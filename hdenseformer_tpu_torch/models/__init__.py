"""Model registry of the port.

``get_net`` keeps the signature of ``hdenseformer_tpu.models.get_net`` and
adds ``device``. The port builds the 3-D HDenseFormer and Hecktor20Top1;
every other name raises ``NotImplementedError`` naming the ROADMAP.md item
that ports it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# every other name of hdenseformer_tpu.models.get_net, and where ROADMAP.md ports it
_NOT_YET = dict.fromkeys((
    "HDenseFormer_2D_32", "HDenseFormer_2D_16", "TransBTS",
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
    ``use_kernels`` (None: True) routes attention, InstanceNorm+ReLU and the
    s2d half-shift through the kernel wrappers, which launch the CUDA kernels
    on a CUDA device and take the plain versions on the CPU; False forces the
    plain versions everywhere. ``remat`` in {True, "encoder", "levels",
    False} checkpoints HDenseFormer's blocks as JAX's does
    (``models.hdenseformer.REMAT_BLOCKS``, through ``torch.utils.checkpoint``);
    Hecktor20Top1 has no remat in JAX and gets none. The model is
    returned in eval mode; ``train/loop.py``'s step puts it in training,
    where HDenseFormer's dropout (0.5) draws from the generator it is given.

    ``s2d`` is honoured for Hecktor20Top1 as in JAX: None packs level 1 when
    ``input_shape`` is 3-D with even dims, True forces it (a ``ValueError``
    at odd dims, as JAX raises), False keeps the fine grid; the dict form
    that packs level 2 raises ``NotImplementedError``. For HDenseFormer it is
    still ignored: the port runs the fine grid, equal math (JAX's tests hold
    packed equal to fine), since HDenseFormer's packed level 0 uses the
    shift-free conv pair, not ported yet (ROADMAP.md queue 1 item 4).
    ``encoder_name`` belongs to the 2-D zoo, not ported yet.

    The parameters are uninitialised: fill them with
    ``models.layers.init_weights`` or ``weights.load_jax_params``.
    """
    del encoder_name
    input_shape = tuple(input_shape)
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
    kw = dict(use_kernels=True if use_kernels is None else use_kernels, dtype=dtype,
              device=torch.device(device))
    if net_name == "hecktor20top1":
        if s2d and any(s % 2 for s in input_shape):
            raise ValueError(
                f"s2d=True requires even spatial dims, got input_shape={input_shape}. "
                "Use s2d=None (auto) to fall back to the fine path for odd shapes."
            )
        from hdenseformer_tpu_torch.models.hecktor20top1 import hecktertop1

        return hecktertop1(channels, num_classes, input_shape, s2d=s2d, **kw).eval()
    if net_name not in ("HDenseFormer_32", "HDenseFormer_16"):
        raise ValueError(f"unknown net_name {net_name!r}")
    from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer_16, HDenseFormer_32

    build = HDenseFormer_32 if net_name == "HDenseFormer_32" else HDenseFormer_16
    return build(channels, num_classes, input_shape, transformer_depth, remat=remat,
                 **kw).eval()
