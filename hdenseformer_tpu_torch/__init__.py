"""PyTorch/CUDA port of hdenseformer_tpu.

Serves HDenseFormer and Hecktor20Top1 by sliding-window whole-volume
inference, and trains both through ``train/loop.py``'s ``SemanticSeg`` and
the command line (``python -m hdenseformer_tpu_torch.cli``), on an NVIDIA
H100. The JAX package ``hdenseformer_tpu`` is the reference; this package
imports neither it nor JAX. Its hand-written CUDA kernels (dense attention,
InstanceNorm+ReLU forward and backward, the space-to-depth half-shift) live
in ``csrc/`` and are built with nvcc at first use (``ops/_build.py``).
"""
