"""Resize and pooling with torch semantics, channels-last, forward only.

Counterpart of ``hdenseformer_tpu/ops/resize.py``. The JAX package spells
out torch's index math because JAX has none of it; here it is torch's own:

- ``resize_nearest``: ``src = floor(dst * in / out)`` per axis (torch
  'nearest'). On the serving path it is the identity: 144 / 16 = 9 is the
  token grid.
- ``upsample_linear``: trilinear, ``align_corners=False`` (half-pixel
  centres, ``_halfpixel_matrix`` in the JAX module).
- ``max_pool``: window = stride, VALID (odd remainders dropped).

Every function takes and returns ``(N, *spatial, C)``; the NCDHW view that
torch's functions take is a free permute of that layout.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
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
        idx = np.floor(np.arange(out_len) * (in_len / out_len)).astype(np.int64)
        idx = np.minimum(idx, in_len - 1)
        x = x.index_select(axis + 1, torch.as_tensor(idx, device=x.device))
    return x


def upsample_linear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """``F.interpolate(scale_factor=scale, mode='trilinear', align_corners=False)``."""
    size = tuple(int(s * scale) for s in x.shape[1:-1])
    return _ndhwc(F.interpolate(_ncdhw(x), size=size, mode="trilinear", align_corners=False))


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool3d with kernel = stride = ``window`` (torch floor semantics)."""
    return _ndhwc(F.max_pool3d(_ncdhw(x), window, window))
