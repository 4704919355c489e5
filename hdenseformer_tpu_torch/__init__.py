"""PyTorch/CUDA port of hdenseformer_tpu.

Serves HDenseFormer by sliding-window whole-volume inference on an NVIDIA
H100. The JAX package ``hdenseformer_tpu`` is the reference; this package
imports neither it nor JAX. Its two hand-written CUDA kernels (dense
attention, InstanceNorm+ReLU) live in ``csrc/`` and are built with nvcc at
first use (``ops/_build.py``).
"""
