"""Seeded token streams."""
