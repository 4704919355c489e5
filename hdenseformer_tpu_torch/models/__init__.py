"""Model registry of the port.

``get_net`` keeps the signature of ``hdenseformer_tpu.models.get_net`` and
adds ``device``. The port builds every name of JAX's with its constructor
knobs: HDenseFormer_32/_16 and HDenseFormer_2D_32/_16, Hecktor20Top1, the
3-D zoo (the DAUNet family, TransBTS, UNETR) and the smp-style 2-D baselines
(unet, unet++, deeplabv3+ on a ResNet encoder).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from hdenseformer_tpu_torch.models.unet2d import NETS_2D, get_2d_net

HDENSEFORMER = ("HDenseFormer_32", "HDenseFormer_16", "HDenseFormer_2D_32", "HDenseFormer_2D_16")
SMP_2D = tuple(NETS_2D)
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

    ``s2d`` means what it means in JAX, for every model that takes it: the
    space-to-depth packed execution of the narrow full-resolution levels
    (``ops/s2d.py``), equal math in another layout, decided from
    ``input_shape``. None applies JAX's rule: HDenseFormer packs its levels
    of at most 32 channels (in 3-D over (H, W), in 2-D at full rank),
    Hecktor20Top1 level 1 (3-D, even dims), the DAUNet family level 0 (not
    the residual builder), TransBTS levels 0 and 1. False keeps the fine
    grid; True forces packing (a ``ValueError`` at odd dims for the DAUNet
    family and Hecktor20Top1, as JAX raises); HDenseFormer, Hecktor20Top1
    and TransBTS also take JAX's dict form {level: True | dims}.
    ``remat`` is ignored for the 3-D zoo, as JAX's get_net passes it to none
    of them; a BatchNorm model must not be checkpointed anyway, since the
    recompute would update its running statistics a second time.

    The 2-D baselines ``unet``, ``unet++`` and ``deeplabv3+`` take
    ``encoder_name`` (resnet18, resnet34 or resnet50; None raises
    ``ValueError``, as in JAX) and return ``[masks, class_logits]``: an aux
    head of ``num_classes - 1`` classes. ``remat`` and ``s2d`` do not reach
    them, as in JAX. HDenseFormer_2D_32/_16 take a 2-D ``input_shape``.

    The parameters are uninitialised: fill them with
    ``models.layers.init_weights`` or ``weights.load_jax_params``.
    """
    input_shape = tuple(input_shape)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'"
            )
        device = "cuda"
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
                                s2d=s2d, **kw)
        else:
            net = getattr(daunet, net_name)(init_depth=input_shape[0], n_channels=channels,
                                            n_classes=num_classes, s2d=s2d, **kw)
        return net.eval()
    if net_name == "TransBTS":
        from hdenseformer_tpu_torch.models.transbts import TransBTS

        return TransBTS(n_channels=channels, num_classes=num_classes, img_dim=input_shape,
                        s2d=s2d, **kw).eval()
    if net_name == "unetr":
        from hdenseformer_tpu_torch.models.unetr import UNETR

        return UNETR(channels, num_classes, img_size=input_shape, feature_size=16,
                     hidden_size=768, mlp_dim=3072, num_heads=12, **kw).eval()
    if net_name == "hecktor20top1":
        from hdenseformer_tpu_torch.models.hecktor20top1 import hecktertop1

        return hecktertop1(channels, num_classes, input_shape, s2d=s2d, remat=bool(remat),
                           **kw).eval()
    if net_name in SMP_2D:
        if encoder_name is None:
            raise ValueError("encoder name must not be 'None'!")
        return get_2d_net(net_name, encoder_name, channels, num_classes,
                          aux_classes=num_classes - 1, dtype=dtype, device=device).eval()
    if net_name not in HDENSEFORMER:
        raise ValueError(f"unknown net_name {net_name!r}")
    from hdenseformer_tpu_torch.models import hdenseformer

    return getattr(hdenseformer, net_name)(channels, num_classes, input_shape,
                                           transformer_depth, remat=remat, s2d=s2d,
                                           **kw).eval()
