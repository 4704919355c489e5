"""Model registry of the port.

``get_net`` keeps the signature of ``hdenseformer_tpu.models.get_net`` and
adds ``device``. This slice builds the 3-D HDenseFormer; every other name
raises ``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# every other name of hdenseformer_tpu.models.get_net, and where ROADMAP.md ports it
_NOT_YET = dict.fromkeys((
    "HDenseFormer_2D_32", "HDenseFormer_2D_16", "hecktor20top1", "TransBTS",
    "unet_3d", "da_unet", "se_unet", "da_se_unet", "res_da_se_unet", "unetr",
    "unet", "unet++", "deeplabv3+",
), "queue 1 item 3 (the rest of the zoo)")


def get_net(
    net_name: str,
    channels: int,
    num_classes: int,
    input_shape: Sequence[int],
    transformer_depth: int = 24,
    encoder_name: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    use_kernels: Optional[bool] = None,
    remat: bool = True,
    s2d=None,
    device=None,
):
    """Build ``net_name`` on ``device`` (None: ``"cuda"``, raising without one).

    ``dtype`` is the compute dtype (None: fp32); parameters stay fp32.
    ``use_kernels`` (None: True) routes attention and InstanceNorm+ReLU
    through the kernel wrappers, which launch the CUDA kernels on a CUDA
    device and take the plain versions on the CPU; False forces the plain
    versions everywhere. ``remat`` and ``s2d`` are accepted for the JAX
    signature and ignored: the port serves in eval, with nothing to
    rematerialise, on the fine grid, which JAX's tests show equal to the
    packed one. ``encoder_name`` belongs to the 2-D zoo, not ported yet.

    The parameters are uninitialised: fill them with
    ``models.layers.init_weights`` or ``weights.load_jax_params``.
    """
    del encoder_name, remat, s2d
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'"
            )
        device = "cuda"
    if net_name in _NOT_YET:
        raise NotImplementedError(
            f"{net_name} is not ported yet: ROADMAP.md {_NOT_YET[net_name]}"
        )
    if net_name not in ("HDenseFormer_32", "HDenseFormer_16"):
        raise ValueError(f"unknown net_name {net_name!r}")
    from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer_16, HDenseFormer_32

    build = HDenseFormer_32 if net_name == "HDenseFormer_32" else HDenseFormer_16
    return build(
        channels, num_classes, tuple(input_shape), transformer_depth,
        use_kernels=True if use_kernels is None else use_kernels,
        dtype=dtype, device=torch.device(device),
    ).eval()
