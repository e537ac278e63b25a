"""Model configurations (the twins of `repro/configs`)."""
