"""Tensor ops of the port: the two hand-written CUDA kernels and resizing."""
