"""PyTorch/CUDA port of the intent-managed parameter manager.

The JAX package `repro` is the reference; this package keeps its layout
and names.  It imports `torch` and numpy, never JAX and nothing of
`repro`.  Ported so far, on one card: the intent-managed serving path
(`serve.runtime.ServingRuntime`) and training loop
(`train.loop.train_loop`, the dense model family), with the hand-written
CUDA kernels `embed_gather`, `pm_combine`, `adagrad_rows` and
`scatter_rows` (`kernels/csrc`).
"""
