"""Tensor ops of the port: the hand-written CUDA kernels' wrappers, the
space-to-depth packed layout, and resizing."""
