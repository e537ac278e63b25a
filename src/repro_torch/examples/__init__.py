"""The twins of the reference's `examples/`, run as ``python -m
repro_torch.examples.<name>``: `quickstart`, `pm_simulation`, `train_lm`
and `serve_decode`.  The ones that train or decode run on the card
unless ``--device cpu`` is given."""
