"""The benchmark's plain reference: PyTorch in fp32, imports nothing of the
system under test. ``model`` is the architecture, ``augment`` the on-device
3-D augmentation, ``augment2d`` and ``augment3d`` the host ones, ``train``
the loss and optimizer steps, ``serve`` the normalisation and the sliding
window. Run it under ``exact()``: a float32 product may otherwise run in
TF32."""
import contextlib

import torch


@contextlib.contextmanager
def exact():
    """TF32 off for the block, as it was after (the system keeps its own)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
