"""Resize and pooling with torch semantics, channels-last.

Counterpart of ``hdenseformer_tpu/ops/resize.py``. The JAX package spells
out torch's index math because JAX has none of it; here it is torch's own:

- ``resize_nearest``: ``src = floor(dst * in / out)`` per axis (torch
  'nearest'). On the serving path it is the identity: 144 / 16 = 9 is the
  token grid. A whole shrink ratio is a strided slice, as in JAX (the
  deep-supervision label pyramid); other ratios gather indices computed on
  x's device, so that a train step never waits for a host-to-device copy.
- ``resize_linear`` and ``upsample_linear``: bi/trilinear,
  ``align_corners=False`` (half-pixel centres, ``_halfpixel_matrix`` in the
  JAX module), in the input's dtype;
- ``resize_linear_align_corners`` and ``upsample_linear_align_corners``:
  ``align_corners=True``. JAX multiplies by an fp32 interpolation matrix,
  which promotes a bf16 input to fp32 wherever an axis is resized; so does
  the port;
- ``max_pool``: window = stride, VALID (odd remainders dropped);
- ``avg_pool`` (VALID, floor) and ``global_avg_pool`` (the mean over every
  spatial dim).

Every function takes and returns ``(N, *spatial, C)`` with 2 or 3 spatial
dims (``resize_nearest`` any number); the NCHW / NCDHW view that torch's
functions take is a free permute of that layout. Gradients are
torch's autograd, which matches JAX's rules: ``max_pool`` routes a tie to
the first maximum in row-major window order (``_max_pool_ws_bwd``), and
``resize_nearest`` scatters each output's gradient back to its source.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of the spatial dims (torch ``mode='nearest'``)."""
    size = tuple(int(s) for s in size)
    if len(size) != x.dim() - 2:
        raise ValueError(f"size {size} must have {x.dim() - 2} spatial dims")
    for axis, out_len in enumerate(size):
        in_len = x.shape[axis + 1]
        if in_len == out_len:
            continue
        if in_len % out_len == 0:
            step = [slice(None)] * x.dim()
            step[axis + 1] = slice(None, None, in_len // out_len)
            x = x[tuple(step)]
            continue
        # float64, as the JAX package's numpy index math
        src = torch.arange(out_len, dtype=torch.float64, device=x.device) * (in_len / out_len)
        x = x.index_select(axis + 1, src.floor().long().clamp_max(in_len - 1))
    return x


_LINEAR = {2: "bilinear", 3: "trilinear"}


def _spatial(x: torch.Tensor, size: Sequence[int]) -> tuple:
    size = tuple(int(s) for s in size)
    if len(size) != x.dim() - 2 or len(size) not in _LINEAR:
        raise ValueError(f"size {size} must give the {x.dim() - 2} spatial dims of a 2-D or "
                         f"3-D input of shape {tuple(x.shape)}")
    return size


def _scaled(x: torch.Tensor, scale) -> tuple:
    nsp = x.dim() - 2
    scale = (scale,) * nsp if isinstance(scale, int) else tuple(scale)
    return tuple(int(s * f) for s, f in zip(x.shape[1:-1], scale))


def resize_linear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bi/trilinear resize to ``size``, ``align_corners=False``, in x's dtype."""
    size = _spatial(x, size)
    if size == tuple(x.shape[1:-1]):
        return x
    return _ndhwc(F.interpolate(_ncdhw(x), size=size, mode=_LINEAR[len(size)],
                                align_corners=False))


def upsample_linear(x: torch.Tensor, scale=2) -> torch.Tensor:
    """``F.interpolate(scale_factor=scale, mode='*linear', align_corners=False)``."""
    return resize_linear(x, _scaled(x, scale))


def resize_linear_align_corners(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bi/trilinear resize to ``size``, ``align_corners=True``: src = dst (in - 1)
    / (out - 1), src 0 where either length is 1. fp32 out where an axis is
    resized, as JAX's fp32 matrix product; x itself where none is."""
    size = _spatial(x, size)
    if size == tuple(x.shape[1:-1]):
        return x
    return _ndhwc(F.interpolate(_ncdhw(x.float()), size=size, mode=_LINEAR[len(size)],
                                align_corners=True))


def upsample_linear_align_corners(x: torch.Tensor, scale=2) -> torch.Tensor:
    return resize_linear_align_corners(x, _scaled(x, scale))


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool3d with kernel = stride = ``window`` (torch floor semantics)."""
    return _ndhwc(F.max_pool3d(_ncdhw(x), window, window))


def avg_pool(x: torch.Tensor, window: int, stride=None) -> torch.Tensor:
    """AvgPool2d/3d(window, stride), VALID (torch floor semantics); stride None
    is the window."""
    pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[x.dim() - 2]
    return _ndhwc(pool(_ncdhw(x), window, window if stride is None else stride))


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """AdaptiveAvgPool to 1 over every spatial dim."""
    return x.mean(dim=tuple(range(1, x.dim() - 1)), keepdim=keepdims)
