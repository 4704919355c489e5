"""InstanceNorm (+ affine) + ReLU over channels-last volumes, forward.

Counterpart of ``hdenseformer_tpu/ops/instance_norm.py`` and of the forward
of ``ops/fused_norm.py``: per (sample, channel) statistics over all spatial
positions, biased variance, ``eps``, batch statistics in eval as in train
(there are no running stats), fp32 statistics, output in ``x.dtype``.

- ``instance_norm_relu_ref`` is the plain version, ported from
  ``xla_instance_norm_relu``: a centered two-pass variance.
- ``instance_norm_relu`` is the kernel wrapper. A CUDA tensor launches the
  hand-written kernel in ``csrc/instance_norm_relu.cu``; a CPU tensor takes
  the plain version; any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from hdenseformer_tpu_torch.ops._build import check, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # kThreads in csrc/instance_norm_relu.cu
_ROWS_PER_THREAD = 64  # rows of one chunk that each thread reduces


def instance_norm_relu_ref(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    relu: bool = True,
) -> torch.Tensor:
    """Plain fp32-statistics instance norm + optional affine + ReLU.

    x: (N, *spatial, C).
    """
    axes = tuple(range(1, x.dim() - 1))
    x32 = x.float()
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def instance_norm_relu(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    relu: bool = True,
) -> torch.Tensor:
    """Instance norm + optional affine + ReLU of a channels-last (N, *spatial, C).

    On CUDA, x must be contiguous in that order (an NCDHW tensor in
    ``torch.channels_last_3d`` memory, permuted to NDHWC, is) and float32 or
    bfloat16; scale and bias are both given or both None, each a float32
    (C,) tensor on x's device. Nothing is copied to make it so.
    """
    if x.device.type == "cpu":
        return instance_norm_relu_ref(x, scale, bias, eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_relu: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"instance_norm_relu: dtype {x.dtype} is not float32 or bfloat16")
    if x.dim() < 3:
        raise ValueError(f"instance_norm_relu: expected (N, *spatial, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            f"instance_norm_relu: x {tuple(x.shape)} with strides {x.stride()} is not "
            "contiguous channels-last"
        )
    if (scale is None) != (bias is None):
        raise ValueError("instance_norm_relu: give both scale and bias, or neither")
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // (n * c)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (
            t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"instance_norm_relu: {name} must be a contiguous float32 ({c},) on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    ct = min(c, _THREADS)
    chunk = (_THREADS // ct) * _ROWS_PER_THREAD
    k = -(-s // chunk)
    if n > 65535 or -(-c // ct) > 65535:
        raise ValueError(f"instance_norm_relu: grid too large for {tuple(x.shape)}")
    y = torch.empty_like(x)
    part = torch.empty(2 * n * c * k, dtype=torch.float32, device=x.device)
    stats = torch.empty(n * c * 2, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hdf_instance_norm_relu(
            x.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(), part.data_ptr(), stats.data_ptr(),
            _DTYPES[x.dtype], n, s, c, ct, chunk, k, eps, int(relu), stream,
        )
    check(err, "instance_norm_relu")
    instance_norm_relu.launches += 1
    return y


# kernel launches since the last reset; chip_smoke.py reads it
instance_norm_relu.launches = 0
