"""Space-to-depth packed execution of a full-resolution UNet level, forward.

Counterpart of the part of ``hdenseformer_tpu/ops/s2d.py`` that
Hecktor20Top1's level 1 runs. Tensors are channels-last ``(N, *g, f*C)``:
each 2^d block of fine voxels is one coarse cell with f = 2^d times the
channels, in PARITY-MAJOR order (packed index = p*C + c, p the fine offset
bits of the packed dims in dim order, leading dim first). Under this layout:

- a SAME k^d fine convolution (k odd) is a VALID convolution on the coarse
  grid of the half-shifted packing (``ops/shift_pack.py``) with a kernel
  expanded from the fine one (``_expand``, ``expand_kernel``): 2
  taps for k3, 4 taps with pads (1, 1) for k7;
- a 1^d convolution is one channel matmul per parity block;
- a ConvTranspose (k3, s2, p1, op1) from the unpacked coarse grid is a VALID
  k2 convolution into packed fine channels (``conv_transpose_packed``);
- a k2 s2 max-pool is a max over the parity blocks, returning the unpacked
  coarse grid;
- a x2 trilinear upsample emits the packed layout directly.

Weights keep the port's torch layouts: ``(out, in, k, k, k)`` for
convolutions, ``(in, out, k, k, k)`` for ConvTranspose (unflipped, as torch
stores it). The expanded kernels are gathered from the fine ones on every
call, as JAX recomputes them every step; each expanded entry is a copy of
one fine entry or zero, so the expansion is exact in any precision. The
convolutions are cuDNN's (``F.conv3d``), as on the fine grid.

Only full-rank packing (every spatial dim) is ported; ``dims`` naming fewer
dims raises. The partial-rank forms, the shift-free p2s/s2p conv pair,
``shifted_mask_factors``, the packed GroupNorm and BatchNorm,
``conv_s2_packed`` and ``conv_transpose2_packed`` wait for ROADMAP.md queue
1 item 4.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hdenseformer_tpu_torch.ops.shift_pack import shift_pack, shift_pack_ref

_PARTIAL_RANK = "ROADMAP.md queue 1 item 4 (partial-rank s2d packing)"
_CONV = {2: F.conv2d, 3: F.conv3d}
_CL = {2: torch.channels_last, 3: torch.channels_last_3d}


def _pdims(nsp: int, dims=None) -> tuple:
    """Normalize the packed-dims selector: None = all spatial dims."""
    if dims is None:
        return tuple(range(nsp))
    dims = tuple(sorted(int(d) for d in dims))
    if not dims or len(set(dims)) != len(dims) or not all(0 <= d < nsp for d in dims):
        raise ValueError(f"packed dims {dims} are not distinct dims of {nsp}")
    return dims


def _full_rank(nsp: int, dims, what: str) -> None:
    if len(_pdims(nsp, dims)) != nsp:
        raise NotImplementedError(
            f"{what}: packing only dims {dims} of {nsp} is not ported yet: {_PARTIAL_RANK}"
        )


@lru_cache(maxsize=None)
def _tap_factor_k(k: int):
    """Per-dim factor of a SAME k-tap fine conv (k odd) on the shifted
    packing (JAX ``_tap_factor_k``): (A[u_idx, p, q, t], pad_lo, pad_hi), a
    VALID K-tap coarse conv over the (pad_lo, pad_hi)-padded g+1 shifted
    cells. Shifted cell j+u, block p holds fine 2(j+u) - p, and the output
    fine 2j + q needs tap t = 2u - p - q + (k-1)/2. k3 gives JAX's
    ``_tap_factor(False)`` (K = 2, pads (0, 0)); k7 gives K = 4, pads (1, 1).
    """
    if k % 2 != 1:
        raise ValueError(f"packed convolutions take odd kernels, got {k}")
    half = (k - 1) // 2
    us = [
        u for u in range(-k, k + 1)
        if any(0 <= 2 * u - p - q + half < k for p in range(2) for q in range(2))
    ]
    u_min, u_max = min(us), max(us)
    A = np.zeros((u_max - u_min + 1, 2, 2, k), np.float32)
    for u in range(u_min, u_max + 1):
        for p in range(2):
            for q in range(2):
                t = 2 * u - p - q + half
                if 0 <= t < k:
                    A[u - u_min, p, q, t] = 1.0
    return A, -u_min, u_max - 1


def _tap_factor_transpose() -> np.ndarray:
    """Per-dim factor A[u, 0, q, k] of the ConvTranspose (k3, s2, p1, op1)
    form (JAX ``_tap_factor(True)``): the input is unpacked, and output fine
    2j + q receives in[j + u] * w[k] with k = q - 2u + 1."""
    A = np.zeros((2, 1, 2, 3), np.float32)
    for u in range(2):
        for q in range(2):
            k = q - 2 * u + 1
            if 0 <= k <= 2:
                A[u, 0, q, k] = 1.0
    return A


@lru_cache(maxsize=None)
def _gather_index(transpose: bool, k: int, nsp: int, device: torch.device) -> torch.Tensor:
    """Flat fine-tap index of every expanded kernel entry, k^nsp for a zero.

    Over (fout dims.., fin dims.., K dims..), the axis order of a torch conv
    weight. Each (u, p, q) row of a tap factor holds at most one tap, so an
    expanded entry is one fine tap or zero: a gather, exact in any precision.
    Kept on ``device``: a copy from host memory on every call would wait for
    the device to drain the work queued before it.
    """
    A = _tap_factor_transpose() if transpose else _tap_factor_k(k)[0]
    tab = np.where(A.any(-1), A.argmax(-1), -1).transpose(2, 1, 0)  # (fout, fin, K)
    fout, fin, taps = tab.shape
    idx = np.zeros((fout,) * nsp + (fin,) * nsp + (taps,) * nsp, np.int64)
    valid = np.ones(idx.shape, bool)
    for d in range(nsp):
        shape = [1] * (3 * nsp)
        shape[d], shape[nsp + d], shape[2 * nsp + d] = tab.shape
        td = tab.reshape(shape)
        idx = idx * k + np.maximum(td, 0)
        valid &= td >= 0
    return torch.from_numpy(np.where(valid, idx, k ** nsp)).to(device)


def _expand(w: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Gather the packed conv weight from a fine one.

    w is a conv's ``(o, i, k..)`` or, with ``transpose``, a ConvTranspose's
    ``(i, o, 3..)``. Returns ``(fout*o, fin*i, K..)``, parity-major on both
    channel axes: output index q*o + c, input index p*i + c.
    """
    nsp = w.dim() - 2
    k = w.shape[-1]
    idx = _gather_index(transpose, k, nsp, w.device)
    wo = w.transpose(0, 1) if transpose else w
    o, i = wo.shape[:2]
    flat = torch.cat([wo.reshape(o, i, -1), wo.new_zeros(o, i, 1)], dim=-1)  # (o, i, taps+1)
    fout = int(np.prod(idx.shape[:nsp]))
    fin = int(np.prod(idx.shape[nsp:2 * nsp]))
    ksp = idx.shape[2 * nsp:]
    g = flat[:, :, idx.reshape(-1)].reshape(o, i, fout, fin, *ksp)
    return g.permute(2, 0, 3, 1, *range(4, 4 + nsp)).reshape(fout * o, fin * i, *ksp)


def expand_kernel(w: torch.Tensor) -> torch.Tensor:
    """Fine SAME k3 conv weight (o, i, 3..) -> packed VALID k2 weight
    (f*o, f*i, 2..), full rank."""
    if w.shape[-1] != 3:
        raise ValueError(f"expand_kernel takes a k3 weight, got {tuple(w.shape)}")
    return _expand(w, transpose=False)


def expand_kernel_transpose(w: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose (k3, s2, p1, op1) weight (i, o, 3..) -> the packed
    VALID k2 conv weight (f*o, i, 2..) from the coarse grid into packed
    fine channels, full rank. torch's weight is unflipped, so this is JAX's
    ``expand_kernel_transpose`` of the flipped equivalent-conv kernel."""
    return _expand(w, transpose=True)


def _conv(x: torch.Tensor, w: torch.Tensor, bias, padding: int) -> torch.Tensor:
    """VALID-or-symmetric conv of channels-last x with a torch-layout weight."""
    nsp = x.dim() - 2
    w = w.contiguous(memory_format=_CL[nsp])  # channels-last output, see layers.py
    return _CONV[nsp](x.movedim(-1, 1), w, bias, 1, padding).movedim(1, -1)


def pack(x: torch.Tensor, dims=None) -> torch.Tensor:
    """(N, *fine, C) -> packed-plain (N, *coarse, 2^|dims| C), parity-major."""
    nsp = x.dim() - 2
    dims = _pdims(nsp, dims)
    n, c = x.shape[0], x.shape[-1]
    shape = (n,)
    for i, s in enumerate(x.shape[1:-1]):
        shape += (s // 2, 2) if i in dims else (s,)
    xp = x.reshape(shape + (c,))
    spat, par, pos = [], [], 1
    for i in range(nsp):
        spat.append(pos)
        if i in dims:
            par.append(pos + 1)
            pos += 2
        else:
            pos += 1
    xp = xp.permute(0, *spat, *par, pos)
    g = tuple(s // 2 if i in dims else s for i, s in enumerate(x.shape[1:-1]))
    return xp.reshape((n,) + g + (c * 2 ** len(dims),))


def unpack(xp: torch.Tensor, dims=None) -> torch.Tensor:
    """Inverse of ``pack``."""
    nsp = xp.dim() - 2
    dims = _pdims(nsp, dims)
    n, cf = xp.shape[0], xp.shape[-1]
    c = cf // 2 ** len(dims)
    g = xp.shape[1:-1]
    x = xp.reshape((n,) + tuple(g) + (2,) * len(dims) + (c,))
    perm, pi = [0], 1 + nsp
    for i in range(nsp):
        perm.append(1 + i)
        if i in dims:
            perm.append(pi)
            pi += 1
    perm.append(1 + nsp + len(dims))
    fine = tuple(2 * s if i in dims else s for i, s in enumerate(g))
    return x.permute(*perm).reshape((n,) + fine + (c,))


def convk_packed(xp: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None, dims=None,
                 use_kernels: bool = True) -> torch.Tensor:
    """SAME k^d fine conv (k odd), packed-plain in and out, computed in packed
    space: the half-shift, then a VALID K-tap coarse conv (k3: K = 2, no
    pad; k7: K = 4, pads (1, 1)) with the expanded kernel.

    xp (N, *g, f*C); w the fine (o, C, k..) weight; bias (o,) or None, added
    once per parity block. ``use_kernels`` selects ``shift_pack`` (the CUDA
    kernel for a CUDA tensor) or its plain version.
    """
    nsp = xp.dim() - 2
    _full_rank(nsp, dims, "convk_packed")
    dt = dtype or xp.dtype
    shift = shift_pack if use_kernels else shift_pack_ref
    xs = shift(xp.to(dt))  # cast before the shift: half the copy's bytes from fp32
    _, pad, _ = _tap_factor_k(w.shape[-1])  # pads (pad, pad) for every odd k
    wexp = _expand(w, transpose=False).to(dt)
    b = None if bias is None else bias.to(dt).repeat(2 ** nsp)
    return _conv(xs, wexp, b, pad)


def conv3_packed(xp: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None, dims=None,
                 use_kernels: bool = True) -> torch.Tensor:
    """SAME 3^d fine conv in packed space (``convk_packed`` at k3)."""
    if w.shape[-1] != 3:
        raise ValueError(f"conv3_packed takes a k3 weight, got {tuple(w.shape)}")
    return convk_packed(xp, w, bias, dtype, dims, use_kernels)


def conv1_packed(xp: torch.Tensor, w1: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dims=None) -> torch.Tensor:
    """1^d conv in packed space, fp32 out: one (C, o) matmul per parity block.

    As JAX's ``dot_f32out``, the operands are xp's dtype (the weight rounded
    to it) with fp32 accumulation and an fp32 output; here both are upcast
    and multiplied in fp32, which gives the same products.
    """
    nsp = xp.dim() - 2
    f = 2 ** len(_pdims(nsp, dims))
    co, c = w1.shape[:2]
    w = w1.reshape(co, c).to(xp.dtype).float()
    y = xp.float().reshape(xp.shape[:-1] + (f, c)) @ w.t()
    y = y.reshape(xp.shape[:-1] + (f * co,))
    if bias is not None:
        y = y + bias.float().repeat(f)
    return y


def conv_transpose_packed(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          dtype: Optional[torch.dtype] = None, dims=None) -> torch.Tensor:
    """torch ConvTranspose (k3, s2, p1, op1) from the unpacked coarse grid x
    (N, *g, C), output packed-plain on the same grid (N, *g, f*o): a VALID
    k2 conv over x padded by one cell on the high side of each dim."""
    nsp = x.dim() - 2
    _full_rank(nsp, dims, "conv_transpose_packed")
    dt = dtype or x.dtype
    wexp = expand_kernel_transpose(w).to(dt)
    b = None if bias is None else bias.to(dt).repeat(2 ** nsp)
    # F.conv3d pads symmetrically; the (0, 1) pad is explicit
    xpad = F.pad(x.to(dt), (0, 0) + (0, 1) * nsp)
    return _conv(xpad, wexp, b, 0)


def max_pool_packed(xp: torch.Tensor, dims=None) -> torch.Tensor:
    """k2 s2 max-pool of the fine grid == a max over the parity blocks.
    Returns the UNPACKED coarse grid (N, *g, C)."""
    nsp = xp.dim() - 2
    _full_rank(nsp, dims, "max_pool_packed")
    f = 2 ** nsp
    return xp.reshape(xp.shape[:-1] + (f, xp.shape[-1] // f)).amax(dim=-2)


def upsample2x_packed(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x2 half-pixel linear upsample (torch ``align_corners=False``) of the
    unpacked grid x (N, *g, C), emitted packed-plain (N, *g, f*C).

    Per dim: fine 2j = 0.25 x[j-1] + 0.75 x[j] and fine 2j+1 = 0.75 x[j] +
    0.25 x[j+1], edge-clamped: ``pack(upsample_linear(x, 2))`` as shifted
    adds on the coarse grid.
    """
    nsp = x.dim() - 2
    _full_rank(nsp, dims, "upsample2x_packed")
    t = x
    for d in range(nsp):
        ax = 1 + d
        g = t.shape[ax]
        lo = torch.cat([t.narrow(ax, 0, 1), t.narrow(ax, 0, g - 1)], dim=ax)
        hi = torch.cat([t.narrow(ax, 1, g - 1), t.narrow(ax, g - 1, 1)], dim=ax)
        even = 0.25 * lo + 0.75 * t
        odd = 0.75 * t + 0.25 * hi
        # parity axes accumulate after the spatial ones, before the channels
        t = torch.stack([even, odd], dim=1 + nsp + d)
    return t.reshape(t.shape[:1 + nsp] + (-1,))


def concat_packed(tensors: Sequence[torch.Tensor], dims=None) -> torch.Tensor:
    """Channel concatenation in packed space: per parity block, the blocks
    of each input in order."""
    nsp = tensors[0].dim() - 2
    f = 2 ** len(_pdims(nsp, dims))
    parts = [t.reshape(t.shape[:-1] + (f, t.shape[-1] // f)) for t in tensors]
    out = torch.cat(parts, dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))
