"""Functional optimizers (the twin of `repro/optim`)."""
