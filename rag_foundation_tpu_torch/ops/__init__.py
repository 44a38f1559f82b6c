"""Tensor ops of the port: plain PyTorch, plus wrappers of the
hand-written CUDA kernels in ``csrc/``."""
