"""Plain PyTorch references, one file per model family, and the training
steps they share (`steps`).  They import torch and numpy only: nothing of
the port, of JAX or of the JAX package."""
