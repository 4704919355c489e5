"""Resize and pooling with torch semantics, channels-last.

Counterpart of ``hdenseformer_tpu/ops/resize.py``. The JAX package spells
out torch's index math because JAX has none of it; here it is torch's own:

- ``resize_nearest``: ``src = floor(dst * in / out)`` per axis (torch
  'nearest'). On the serving path it is the identity: 144 / 16 = 9 is the
  token grid. A whole shrink ratio is a strided slice, as in JAX (the
  deep-supervision label pyramid); other ratios gather indices computed on
  x's device, so that a train step never waits for a host-to-device copy.
- ``upsample_linear``: trilinear, ``align_corners=False`` (half-pixel
  centres, ``_halfpixel_matrix`` in the JAX module).
- ``max_pool``: window = stride, VALID (odd remainders dropped).

Every function takes and returns ``(N, *spatial, C)``; the NCDHW view that
torch's functions take is a free permute of that layout. Gradients are
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


def upsample_linear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """``F.interpolate(scale_factor=scale, mode='trilinear', align_corners=False)``."""
    size = tuple(int(s * scale) for s in x.shape[1:-1])
    return _ndhwc(F.interpolate(_ncdhw(x), size=size, mode="trilinear", align_corners=False))


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool3d with kernel = stride = ``window`` (torch floor semantics)."""
    return _ndhwc(F.max_pool3d(_ncdhw(x), window, window))
