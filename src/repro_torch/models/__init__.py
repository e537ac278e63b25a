"""Model assembly (the twin of `repro/models`): the dense family."""
