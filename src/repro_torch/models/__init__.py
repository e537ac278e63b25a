"""Model assembly (the twin of `repro/models`): every family."""
