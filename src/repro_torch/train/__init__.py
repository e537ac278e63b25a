"""The intent-managed training step and loop (the twin of `repro/train`)."""
