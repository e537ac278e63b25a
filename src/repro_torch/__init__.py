"""PyTorch/CUDA port of the intent-managed parameter manager.

The JAX package `repro` is the reference; this package keeps its layout
and names.  It imports `torch` and numpy, never JAX and nothing of
`repro`.  Ported so far: the intent-managed serving path
(`serve.runtime.ServingRuntime`) with the hand-written CUDA kernels
`embed_gather` and `pm_combine` (`kernels/csrc`).
"""
