"""PyTorch/CUDA port of the intent-managed parameter manager.

The JAX package `repro` is the reference; this package keeps its layout
and names.  It imports `torch` and numpy, never JAX and nothing of
`repro`.  Ported so far: the intent-managed serving path
(`serve.runtime.ServingRuntime`) and training loop
(`train.loop.train_loop`) and decoding (`train.steps`) for every model
family of the reference, with the hand-written
CUDA kernels `embed_gather`, `pm_combine`, `adagrad_rows`,
`scatter_rows` and `segment_scatter_rows` (`kernels/csrc`), on the
emulated collective backend or on the vocab-parallel mesh over
`torch.distributed` (`pm.collectives.MeshBackend`, `launch.mesh`).
"""
