"""Model registry of the port.

``get_net`` keeps the signature of ``hdenseformer_tpu.models.get_net`` and
adds ``device``. The port builds the 3-D HDenseFormer, Hecktor20Top1 and the
3-D zoo (the DAUNet family, TransBTS, UNETR) with JAX's constructor knobs;
the 2-D names raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# every other name of hdenseformer_tpu.models.get_net, and where ROADMAP.md ports it
_NOT_YET = dict.fromkeys((
    "HDenseFormer_2D_32", "HDenseFormer_2D_16", "unet", "unet++", "deeplabv3+",
), "queue 1 item 3 (the 2-D zoo)")
DAUNET_FAMILY = ("unet_3d", "da_unet", "se_unet", "da_se_unet", "res_da_se_unet")


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
    Hecktor20Top1 takes ``bool(remat)``, as JAX's get_net passes it, and
    then checkpoints each of its ``res`` and ``sen`` blocks. The model is
    returned in eval mode; ``train/loop.py``'s step puts it in training,
    where HDenseFormer's dropout (0.5) draws from the generator it is given.

    ``s2d`` is honoured for Hecktor20Top1 as in JAX: None packs level 1 when
    ``input_shape`` is 3-D with even dims, True forces it (a ``ValueError``
    at odd dims, as JAX raises, also for the DAUNet family), False keeps the
    fine grid; the dict form that packs level 2 raises
    ``NotImplementedError``. For HDenseFormer, the DAUNet family and
    TransBTS it is otherwise ignored: the port runs the fine grid, equal
    math (JAX's tests hold packed equal to fine), since their packed levels
    use the shift-free conv pair and the packed BatchNorm and GroupNorm, not
    ported yet (ROADMAP.md queue 1 item 4). ``remat`` is ignored for the 3-D
    zoo, as JAX's get_net passes it to none of them; a BatchNorm model must
    not be checkpointed anyway, since the recompute would update its running
    statistics a second time. ``encoder_name`` belongs to the 2-D zoo, not
    ported yet.

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
    use_kernels = True if use_kernels is None else use_kernels
    device = torch.device(device)
    kw = dict(use_kernels=use_kernels, dtype=dtype, device=device)
    if s2d and net_name in DAUNET_FAMILY + ("hecktor20top1",) and any(
            s % 2 for s in input_shape):
        raise ValueError(
            f"s2d=True requires even spatial dims, got input_shape={input_shape}. "
            "Use s2d=None (auto) to fall back to the fine path for odd shapes."
        )
    if net_name in DAUNET_FAMILY:
        from hdenseformer_tpu_torch.models import daunet

        if net_name == "unet_3d":
            depths = tuple(input_shape[0] // (2 ** k) for k in range(5))
            net = daunet.DAUNet(channels, num_classes, depths=depths, conv_builder="plain",
                                dtype=dtype, device=device)
        else:
            net = getattr(daunet, net_name)(init_depth=input_shape[0], n_channels=channels,
                                            n_classes=num_classes, dtype=dtype, device=device)
        return net.eval()
    if net_name == "TransBTS":
        from hdenseformer_tpu_torch.models.transbts import TransBTS

        return TransBTS(n_channels=channels, num_classes=num_classes, img_dim=input_shape,
                        dtype=dtype, device=device).eval()
    if net_name == "unetr":
        from hdenseformer_tpu_torch.models.unetr import UNETR

        return UNETR(channels, num_classes, img_size=input_shape, feature_size=16,
                     hidden_size=768, mlp_dim=3072, num_heads=12, **kw).eval()
    if net_name == "hecktor20top1":
        from hdenseformer_tpu_torch.models.hecktor20top1 import hecktertop1

        return hecktertop1(channels, num_classes, input_shape, s2d=s2d, remat=bool(remat),
                           **kw).eval()
    if net_name not in ("HDenseFormer_32", "HDenseFormer_16"):
        raise ValueError(f"unknown net_name {net_name!r}")
    from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer_16, HDenseFormer_32

    build = HDenseFormer_32 if net_name == "HDenseFormer_32" else HDenseFormer_16
    return build(channels, num_classes, input_shape, transformer_depth, remat=remat,
                 **kw).eval()
