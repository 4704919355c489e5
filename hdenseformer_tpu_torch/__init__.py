"""PyTorch/CUDA port of hdenseformer_tpu.

Serves HDenseFormer, Hecktor20Top1 and the 3-D zoo (the DAUNet family,
TransBTS, UNETR) by sliding-window whole-volume inference, and the 2-D nets
(HDenseFormer_2D and the smp-style unet, unet++ and deeplabv3+) by per-slice
prediction of volumes; trains them through ``train/loop.py``'s
``SemanticSeg`` and the command line (``python -m
hdenseformer_tpu_torch.cli``), on an NVIDIA H100. The JAX package ``hdenseformer_tpu`` is the reference; this package
imports neither it nor JAX. Its hand-written CUDA kernels (dense attention,
InstanceNorm+ReLU forward and backward, the space-to-depth half-shift) live
in ``csrc/`` and are built with nvcc at first use (``ops/_build.py``).
"""
