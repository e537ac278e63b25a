"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain
PyTorch versions.  Importing this package builds nothing: a kernel is built
on its first launch on a CUDA tensor (`build.library`)."""
