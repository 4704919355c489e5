"""Space-to-depth packed execution of full-resolution UNet levels.

Counterpart of ``hdenseformer_tpu/ops/s2d.py``. Tensors are channels-last
``(N, *g, f*C)``: each 2^|dims| block of fine voxels over the packed dims
``dims`` (None: every spatial dim) is one coarse cell with f = 2^|dims| times
the channels, in PARITY-MAJOR order (packed index = p*C + c, p the fine
offset bits of the packed dims in dim order, leading dim first). Unpacked
dims keep their fine extent. Under this layout:

- a SAME k^d fine convolution (k odd) is, on packed dims, a VALID
  convolution on the coarse grid of the half-shifted packing (the
  "shifted" layout: one extra cell a packed dim, shifted cell j, block p
  holding fine 2j - p) with a kernel expanded from the fine one (2 taps for
  k3, 4 taps with pads (1, 1) for k7); unpacked dims keep their k SAME taps
  (``convk_packed``). At full rank the shift is ``ops/shift_pack.py``'s
  (the CUDA kernel on the card), at partial rank ``plain_to_shifted``;
- the shift-free pair: ``conv3_packed_p2s`` (``convk_packed_p2s`` for any
  odd k) reads packed-plain and writes the shifted layout directly, whose
  pad slots (``shifted_mask_factors``) hold conv garbage until a shifted
  norm zeroes them; ``conv3_packed_s2p`` reads that layout back into
  packed-plain. A conv -> norm -> conv chain then runs with no shift copy;
- a 1^d convolution is one channel matmul per parity block
  (``conv1_packed``, fp32 out as JAX's ``dot_f32out``);
- a ConvTranspose (k3, s2, p1, op1) from the unpacked coarse grid is a VALID
  k2 convolution into packed fine channels (``conv_transpose_packed``;
  unpacked dims run torch's stride-2 transposed taps), and a ConvTranspose
  (k2, s2) one matmul (``conv_transpose2_packed``, full rank);
- a stride-2 SAME conv from packed-plain writes the unpacked coarse grid
  (``conv_s2_packed``);
- a k2 s2 max-pool is a max over the parity blocks (``max_pool_packed``),
  a x2 linear upsample emits the packed layout directly
  (``upsample2x_packed``), and GroupNorm pools its groups over the parity
  blocks (``group_norm_relu_packed``; InstanceNorm is
  ``ops/instance_norm.py``'s, with ``shifted`` for the shifted layout).

Weights keep the port's torch layouts: ``(out, in, k..)`` for convolutions,
``(in, out, k..)`` for ConvTranspose (unflipped, as torch stores it). The
expanded kernels are gathered from the fine ones on every call, as JAX
recomputes them every step; each expanded entry is a copy of one fine entry
or zero, so the expansion is exact in any precision. The convolutions are
cuDNN's (``F.conv2d``/``F.conv3d`` and their transposes), as on the fine
grid: JAX computes them outside any Pallas kernel too.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hdenseformer_tpu_torch.ops.shift_pack import shift_pack, shift_pack_ref

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
_CL = {2: torch.channels_last, 3: torch.channels_last_3d}


def _pdims(nsp: int, dims=None) -> tuple:
    """Normalize the packed-dims selector: None = all spatial dims."""
    if dims is None:
        return tuple(range(nsp))
    dims = tuple(sorted(int(d) for d in dims))
    if not dims or len(set(dims)) != len(dims) or not all(0 <= d < nsp for d in dims):
        raise ValueError(f"packed dims {dims} are not distinct dims of {nsp}")
    return dims


def _odd(k: int) -> None:
    if k % 2 != 1:
        raise ValueError(f"packed convolutions take odd kernels, got {k}")


@lru_cache(maxsize=None)
def _tap_factor_k(k: int):
    """Per-dim factor of a SAME k-tap fine conv (k odd) on the shifted
    packing (JAX ``_tap_factor_k``): (A[u_idx, p, q, t], pad_lo, pad_hi), a
    VALID K-tap coarse conv over the (pad_lo, pad_hi)-padded g+1 shifted
    cells. Shifted cell j+u, block p holds fine 2(j+u) - p, and the output
    fine 2j + q needs tap t = 2u - p - q + (k-1)/2. k3 gives JAX's
    ``_tap_factor(False)`` (K = 2, pads (0, 0)); k7 gives K = 4, pads (1, 1).
    """
    _odd(k)
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


@lru_cache(maxsize=None)
def _tap_factor_p2s_k(k: int):
    """Per-dim factor of the plain -> shifted form (JAX ``_tap_factor_p2s_k``;
    k3 gives ``_tap_factor_p2s``): output shifted slot (j, p), fine 2j - p,
    reads plain cell j + u, block q with q = (t - half - p) mod 2. Returns
    (A[u_idx, q, p, t], pad_lo, pad_hi) of a VALID K-tap conv over the
    padded g plain cells, which yields g+1 shifted cells."""
    _odd(k)
    half = (k - 1) // 2
    entries = []
    for p in range(2):
        for t in range(k):
            s = t - half - p
            q = s % 2
            entries.append(((s - q) // 2, q, p, t))
    u_min = min(e[0] for e in entries)
    u_max = max(e[0] for e in entries)
    A = np.zeros((u_max - u_min + 1, 2, 2, k), np.float32)
    for u, q, p, t in entries:
        A[u - u_min, q, p, t] = 1.0
    return A, -u_min, u_max + 1


@lru_cache(maxsize=None)
def _tap_factor_s2(k: int):
    """Per-dim factor of a stride-2 SAME k-tap fine conv read from packed-plain,
    writing the unpacked coarse grid (JAX ``_tap_factor_s2``): output coarse
    j = fine 2j reads plain cell j + u, block q, where 2(j+u) + q = 2j + t -
    half. Returns (A[u_idx, q, 0, t], pad_lo, pad_hi)."""
    _odd(k)
    half = (k - 1) // 2
    entries = []
    for t in range(k):
        s = t - half
        q = s % 2
        entries.append(((s - q) // 2, q, t))
    u_min = min(e[0] for e in entries)
    u_max = max(e[0] for e in entries)
    A = np.zeros((u_max - u_min + 1, 2, 1, k), np.float32)
    for u, q, t in entries:
        A[u - u_min, q, 0, t] = 1.0
    return A, -u_min, u_max


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


# the per-dim factor of each expansion: its A[u, fin, fout, t] and pads
_FACTORS = {
    "k": _tap_factor_k,
    "p2s": _tap_factor_p2s_k,
    "s2": _tap_factor_s2,
    "t": lambda k: (_tap_factor_transpose(), 0, 1),
}


def _identity(k: int) -> np.ndarray:
    """An unpacked dim's factor: the k fine taps pass through as k taps."""
    A = np.zeros((k, 1, 1, k), np.float32)
    for t in range(k):
        A[t, 0, 0, t] = 1.0
    return A


@lru_cache(maxsize=None)
def _gather_index(kinds: tuple, k: int, device: torch.device) -> torch.Tensor:
    """Flat fine-tap index of every expanded kernel entry, k^nsp for a zero.

    ``kinds`` names each spatial dim's factor (a key of ``_FACTORS`` for a
    packed dim, None for an unpacked one). Over (fout dims.., fin dims.., K
    dims..), the axis order of a torch conv weight. Each (u, p, q) row of a
    tap factor holds at most one tap, so an expanded entry is one fine tap
    or zero: a gather, exact in any precision. Kept on ``device``: a copy
    from host memory on every call would wait for the device to drain the
    work queued before it. Built outside inference mode, whatever the first
    caller's mode: the cached index of a serving call would otherwise be an
    inference tensor, which a later train step's backward may not save.
    """
    nsp = len(kinds)
    tabs = []
    for kind in kinds:
        A = _identity(k) if kind is None else _FACTORS[kind](k)[0]
        tabs.append(np.where(A.any(-1), A.argmax(-1), -1).transpose(2, 1, 0))  # (fout, fin, K)
    shape = [t.shape[0] for t in tabs] + [t.shape[1] for t in tabs] + [t.shape[2] for t in tabs]
    idx = np.zeros(shape, np.int64)
    valid = np.ones(shape, bool)
    for d, tab in enumerate(tabs):
        s = [1] * (3 * nsp)
        s[d], s[nsp + d], s[2 * nsp + d] = tab.shape
        td = tab.reshape(s)
        idx = idx * k + np.maximum(td, 0)
        valid &= td >= 0
    with torch.inference_mode(False):
        return torch.from_numpy(np.where(valid, idx, k ** nsp)).to(device)


def _kinds(nsp: int, dims, kind: str) -> tuple:
    dims = _pdims(nsp, dims)
    return tuple(kind if i in dims else None for i in range(nsp))


def _pads(kinds: tuple, k: int) -> list:
    """(lo, hi) of each dim for the expanded conv: the factor's on packed
    dims, the fine SAME pad on unpacked ones."""
    return [(k // 2, k // 2) if kind is None else tuple(_FACTORS[kind](k)[1:])
            for kind in kinds]


def _expand(w: torch.Tensor, kinds: tuple) -> torch.Tensor:
    """Gather the packed conv weight ``(fout*o, fin*i, K..)`` from a fine one
    ``(o, i, k..)``, parity-major on both channel axes: output index q*o + c,
    input index p*i + c."""
    nsp = w.dim() - 2
    k = w.shape[-1]
    idx = _gather_index(kinds, k, w.device)
    o, i = w.shape[:2]
    flat = torch.cat([w.reshape(o, i, -1), w.new_zeros(o, i, 1)], dim=-1)  # (o, i, taps+1)
    fout = int(np.prod(idx.shape[:nsp]))
    fin = int(np.prod(idx.shape[nsp:2 * nsp]))
    ksp = idx.shape[2 * nsp:]
    g = flat[:, :, idx.reshape(-1)].reshape(o, i, fout, fin, *ksp)
    return g.permute(2, 0, 3, 1, *range(4, 4 + nsp)).reshape(fout * o, fin * i, *ksp)


def expand_kernel(w: torch.Tensor, dims=None) -> torch.Tensor:
    """Fine SAME k3 conv weight (o, i, 3..) -> the packed weight of the
    shifted -> plain form (f*o, f*i, K..): 2 taps on packed dims, the 3 SAME
    taps on the rest (JAX ``expand_kernel``)."""
    if w.shape[-1] != 3:
        raise ValueError(f"expand_kernel takes a k3 weight, got {tuple(w.shape)}")
    return _expand(w, _kinds(w.dim() - 2, dims, "k"))


def expand_kernel_p2s(w: torch.Tensor, dims=None) -> torch.Tensor:
    """Fine SAME k3 conv weight -> the packed weight of the plain -> shifted
    form (``conv3_packed_p2s``; JAX ``expand_kernel_p2s``)."""
    if w.shape[-1] != 3:
        raise ValueError(f"expand_kernel_p2s takes a k3 weight, got {tuple(w.shape)}")
    return _expand(w, _kinds(w.dim() - 2, dims, "p2s"))


def expand_kernel_transpose(w: torch.Tensor, dims=None) -> torch.Tensor:
    """torch ConvTranspose (k3, s2, p1, op1) weight (i, o, 3..) -> JAX's
    ``expand_kernel_transpose`` in conv layout (f*o, i, K..): on packed dims
    the VALID k2 conv from the coarse grid into packed fine channels, on
    unpacked dims JAX's equivalent-conv taps (torch's, flipped)."""
    nsp = w.dim() - 2
    pd = _pdims(nsp, dims)
    flip = [2 + i for i in range(nsp) if i not in pd]
    wf = w.flip(flip) if flip else w
    return _expand(wf.transpose(0, 1), _kinds(nsp, pd, "t"))


def _conv(x: torch.Tensor, w: torch.Tensor, bias, pads: Sequence, stride=1) -> torch.Tensor:
    """Conv of channels-last x with a torch-layout weight and per-dim (lo, hi)
    zero pads."""
    nsp = x.dim() - 2
    w = w.contiguous(memory_format=_CL[nsp])  # channels-last output, see layers.py
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:  # F.convNd pads symmetrically; the rest is explicit
        x = F.pad(x, (0, 0) + tuple(v for lo, hi in reversed(pads) for v in (lo, hi)))
        padding = 0
    return _CONV[nsp](x.movedim(-1, 1), w, bias, stride, padding).movedim(1, -1)


def _bias(bias: Optional[torch.Tensor], dt: torch.dtype, f: int) -> Optional[torch.Tensor]:
    return None if bias is None else bias.to(dt).repeat(f)


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


def plain_to_shifted(xp: torch.Tensor, dims=None) -> torch.Tensor:
    """Packed-plain -> packed-shifted (one extra cell a packed dim, zero at
    the boundary: the fine conv's SAME padding): shifted cell j, block p
    holds fine 2j - p, a copy of block p of plain cell j - bits(p). At full
    rank this is ``shift_pack_ref``."""
    nsp = xp.dim() - 2
    dims = _pdims(nsp, dims)
    npk = len(dims)
    f = 2 ** npk
    c = xp.shape[-1] // f
    g = xp.shape[1:-1]
    pad = []
    for i in reversed(range(nsp)):  # F.pad's order: the last dim first
        pad += [1, 1] if i in dims else [0, 0]
    xr = F.pad(xp, [0, 0] + pad)
    pieces = []
    for m in range(f):
        bits = {d: (m >> (npk - 1 - j)) & 1 for j, d in enumerate(dims)}
        idx = (slice(None),)
        for i in range(nsp):
            # padded coords: cell j - b of the grid sits at j - b + 1
            idx += (slice(1 - bits[i], 2 - bits[i] + g[i]),) if i in dims else (slice(None),)
        pieces.append(xr[idx + (slice(m * c, (m + 1) * c),)])
    return torch.cat(pieces, dim=-1)


def convk_packed(xp: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None, dims=None,
                 use_kernels: bool = True) -> torch.Tensor:
    """SAME k^d fine conv (k odd), packed-plain in and out, computed in packed
    space: the half-shift, then a conv that is VALID K-tap on packed dims
    (k3: K = 2, no pad; k7: K = 4, pads (1, 1)) and the fine SAME k taps on
    unpacked dims, with the expanded kernel.

    xp (N, *g, f*C); w the fine (o, C, k..) weight; bias (o,) or None, added
    once per parity block. At full rank the shift is ``shift_pack`` (the
    CUDA kernel for a CUDA tensor) or, with ``use_kernels`` False, its plain
    version; at partial rank ``plain_to_shifted``, as in JAX.
    """
    nsp = xp.dim() - 2
    pd = _pdims(nsp, dims)
    dt = dtype or xp.dtype
    k = w.shape[-1]
    _odd(k)
    x = xp.to(dt)  # cast before the shift: half the copy's bytes from fp32
    if len(pd) == nsp:
        xs = (shift_pack if use_kernels else shift_pack_ref)(x)
    else:
        xs = plain_to_shifted(x, pd)
    kinds = _kinds(nsp, pd, "k")
    return _conv(xs, _expand(w, kinds).to(dt), _bias(bias, dt, 2 ** len(pd)), _pads(kinds, k))


def conv3_packed(xp: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None, dims=None,
                 use_kernels: bool = True) -> torch.Tensor:
    """SAME 3^d fine conv in packed space (``convk_packed`` at k3)."""
    if w.shape[-1] != 3:
        raise ValueError(f"conv3_packed takes a k3 weight, got {tuple(w.shape)}")
    return convk_packed(xp, w, bias, dtype, dims, use_kernels)


def convk_packed_p2s(xp: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     dtype: Optional[torch.dtype] = None, dims=None) -> torch.Tensor:
    """SAME k^d fine conv (k odd), packed-plain in, packed-SHIFTED out
    (N, *(g+1 on packed dims), f*o): slot (cell j, block p) holds fine 2j - p.
    The pad slots (per packed dim: j = 0 with p = 1, j = g with p = 0) hold
    conv garbage, bias included, and must be zeroed by the consumer
    (``instance_norm_relu(shifted=...)``, ``apply_shifted_mask``) before
    ``conv3_packed_s2p`` reads them as zero padding."""
    nsp = xp.dim() - 2
    pd = _pdims(nsp, dims)
    dt = dtype or xp.dtype
    k = w.shape[-1]
    kinds = _kinds(nsp, pd, "p2s")
    return _conv(xp.to(dt), _expand(w, kinds).to(dt), _bias(bias, dt, 2 ** len(pd)),
                 _pads(kinds, k))


def conv3_packed_p2s(xp: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     dtype: Optional[torch.dtype] = None, dims=None) -> torch.Tensor:
    """``convk_packed_p2s`` at k3: pads (1, 1) on every dim."""
    if w.shape[-1] != 3:
        raise ValueError(f"conv3_packed_p2s takes a k3 weight, got {tuple(w.shape)}")
    return convk_packed_p2s(xp, w, bias, dtype, dims)


def conv3_packed_s2p(xs: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     dtype: Optional[torch.dtype] = None, dims=None) -> torch.Tensor:
    """SAME 3^d fine conv, packed-SHIFTED in (pad slots zero), packed-plain
    out: ``conv3_packed`` less the shift."""
    if w.shape[-1] != 3:
        raise ValueError(f"conv3_packed_s2p takes a k3 weight, got {tuple(w.shape)}")
    nsp = xs.dim() - 2
    pd = _pdims(nsp, dims)
    dt = dtype or xs.dtype
    kinds = _kinds(nsp, pd, "k")
    return _conv(xs.to(dt), _expand(w, kinds).to(dt), _bias(bias, dt, 2 ** len(pd)),
                 _pads(kinds, 3))


def conv_s2_packed(xp: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None, dims=None) -> torch.Tensor:
    """Stride-2 SAME k^d fine conv (k odd) read from packed-plain, writing the
    UNPACKED coarse grid (TransBTS's EnDown): stride 1 on packed dims, the
    fine stride-2 conv on unpacked ones."""
    nsp = xp.dim() - 2
    pd = _pdims(nsp, dims)
    dt = dtype or xp.dtype
    k = w.shape[-1]
    kinds = _kinds(nsp, pd, "s2")
    stride = tuple(1 if i in pd else 2 for i in range(nsp))
    return _conv(xp.to(dt), _expand(w, kinds).to(dt), _bias(bias, dt, 1), _pads(kinds, k),
                 stride)


@lru_cache(maxsize=None)
def shifted_mask_factors(sshape: tuple, fc: int, c: int, dims: tuple = None) -> tuple:
    """Per packed dim i, (i, (s_i, fC) bool factor, True where valid): the
    broadcast AND of the factors masks the pad slots of a packed-SHIFTED
    tensor of spatial shape ``sshape``. Slot (j, p) is a pad iff for some
    packed dim (j == 0 and p's bit == 1) or (j == s - 1 and p's bit == 0);
    the leading packed dim is the high bit (JAX ``shifted_mask_factors``,
    whose factors are these as float 0/1)."""
    nsp = len(sshape)
    dims = _pdims(nsp, dims)
    npk = len(dims)
    pidx = np.arange(fc) // c
    out = []
    for j, i in enumerate(dims):
        b = (pidx >> (npk - 1 - j)) & 1
        m = np.ones((sshape[i], fc), bool)
        m[0, b == 1] = False
        m[sshape[i] - 1, b == 0] = False
        out.append((i, m))
    return tuple(out)


@lru_cache(maxsize=None)
def _mask_factors(sshape: tuple, fc: int, c: int, dims: tuple, device: torch.device) -> tuple:
    """``shifted_mask_factors`` as broadcastable bool tensors on ``device``,
    made at the first call: a step captured as a CUDA graph reads them (a
    copy from the host cannot be captured)."""
    nsp = len(sshape)
    out = []
    for i, m in shifted_mask_factors(sshape, fc, c, dims):
        shape = (1,) * (1 + i) + (m.shape[0],) + (1,) * (nsp - 1 - i) + (m.shape[1],)
        with torch.inference_mode(False):
            out.append(torch.from_numpy(m).reshape(shape).to(device))
    return tuple(out)


def apply_shifted_mask(y: torch.Tensor, dims=None) -> torch.Tensor:
    """Zero the pad slots of a packed-shifted tensor, by selection (the slots
    may hold any value): one broadcast select a packed dim."""
    nsp = y.dim() - 2
    pd = _pdims(nsp, dims)
    fc = y.shape[-1]
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    for m in _mask_factors(tuple(y.shape[1:-1]), fc, fc // 2 ** len(pd), pd, y.device):
        y = torch.where(m, y, zero)
    return y


def shifted_count(sshape: Sequence[int], dims) -> int:
    """Valid slots per channel block of a packed-shifted tensor of spatial
    shape ``sshape``: prod over packed dims of (s_i - 1), over unpacked dims
    of s_i, times f (JAX ``fused_norm._count``)."""
    pd = _pdims(len(sshape), dims)
    m = 2 ** len(pd)
    for i, s in enumerate(sshape):
        m *= (s - 1) if i in pd else s
    return m


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


def dot_f32out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Channel matmul of x (..., C) and w (C, Co) read in their own (compute)
    dtype with an fp32 result (JAX ``dot_f32out``): both upcast, which is
    exact, and multiplied in fp32 (TF32 off, the same arithmetic)."""
    return x.float() @ w.float()


def conv_transpose_packed(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          dtype: Optional[torch.dtype] = None, dims=None) -> torch.Tensor:
    """torch ConvTranspose (k3, s2, p1, op1) from the unpacked coarse grid x
    (N, *g, C), output packed-plain on packed dims (g cells, f*o channels)
    and the fine 2g grid on unpacked dims.

    Full rank: a VALID k2 conv over x padded by one cell on the high side.
    Partial rank: a transposed conv of x, padded so on packed dims, that is
    stride 1 with the expanded taps reversed on packed dims and torch's
    stride-2 (k3, p1, op1) on unpacked ones (JAX dilates the input there).
    """
    nsp = x.dim() - 2
    pd = _pdims(nsp, dims)
    dt = dtype or x.dtype
    f = 2 ** len(pd)
    pad = []
    for i in reversed(range(nsp)):  # F.pad's order: the last dim first
        pad += [0, 1] if i in pd else [0, 0]
    xpad = F.pad(x.to(dt), [0, 0] + pad)
    wexp = expand_kernel_transpose(w, pd).to(dt)
    if len(pd) == nsp:
        return _conv(xpad, wexp, _bias(bias, dt, f), [(0, 0)] * nsp)
    wt = wexp.flip(list(range(2, 2 + nsp))).transpose(0, 1)  # (i, f*o, K..), torch's taps
    wt = wt.contiguous(memory_format=_CL[nsp])
    stride = tuple(1 if i in pd else 2 for i in range(nsp))
    out_pad = tuple(0 if i in pd else 1 for i in range(nsp))
    y = _CONV_T[nsp](xpad.movedim(-1, 1), wt, _bias(bias, dt, f), stride, 1, out_pad)
    return y.movedim(1, -1)


def conv_transpose2_packed(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                           dtype: Optional[torch.dtype] = None, dims=None) -> torch.Tensor:
    """torch ConvTranspose (k2, s2) fine upsample of x (N, *g, C) with
    packed-plain output on the input grid: fine 2j + q reads one tap, so the
    op is one (C, f*o) matmul (``dot_f32out``, rounded to ``dtype``), plus
    the bias per parity block. Full rank only, as in JAX. w is torch's
    (C, o, 2..)."""
    nsp = x.dim() - 2
    if len(_pdims(nsp, dims)) != nsp:
        raise ValueError(f"conv_transpose2_packed packs every dim, got dims {dims}")
    if tuple(w.shape[2:]) != (2,) * nsp:
        raise ValueError(f"conv_transpose2_packed takes a k2 weight, got {tuple(w.shape)}")
    dt = dtype or x.dtype
    c, co = w.shape[:2]
    f = 2 ** nsp
    # parity-major: output q*o + c, q the tap bits in dim order
    wm = w.permute(0, *range(2, 2 + nsp), 1).reshape(c, f * co).to(dt)
    y = dot_f32out(x.to(dt), wm).to(dt)
    if bias is not None:
        y = y + bias.to(dt).repeat(f)
    return y


def group_norm_relu_packed(xp: torch.Tensor, scale: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None, num_groups: int = 8,
                           eps: float = 1e-5, relu: bool = True, dims=None,
                           shifted: bool = False) -> torch.Tensor:
    """GroupNorm (+ affine) (+ ReLU) over the fine grid of a packed tensor
    (JAX ``group_norm_relu_packed``): per (sample, group) statistics over the
    group's channels, the parity blocks and space, fp32, output in xp's
    dtype. ``shifted``: xp is packed-shifted; its pad slots are left out of
    the statistics and zero in the output."""
    nsp = xp.dim() - 2
    pd = _pdims(nsp, dims)
    f = 2 ** len(pd)
    n, c = xp.shape[0], xp.shape[-1] // f
    cg = c // num_groups
    x32 = xp.float()
    axes = tuple(range(1, xp.dim() - 1))
    if shifted:
        x32m = apply_shifted_mask(x32, pd)
        m = shifted_count(xp.shape[1:-1], pd)
    else:
        x32m = x32
        m = f * int(np.prod(xp.shape[1:-1]))
    m_g = m * cg  # elements per (sample, group)

    def to_group(v):  # (N, f*C) -> (N, G)
        return v.reshape(n, f, num_groups, cg).sum(dim=(1, 3))

    mean_g = to_group(x32m.sum(axes)) / m_g
    var_g = to_group(x32m.square().sum(axes)) / m_g - mean_g.square()
    inv_g = torch.rsqrt(var_g + eps)

    def to_packed(v):  # (N, G) -> (N, 1.., f*C)
        v = v.repeat_interleave(cg, dim=-1).repeat(1, f)
        return v.reshape((n,) + (1,) * nsp + (f * c,))

    y = (x32 - to_packed(mean_g)) * to_packed(inv_g)
    if scale is not None:
        y = y * scale.float().repeat(f)
    if bias is not None:
        y = y + bias.float().repeat(f)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if shifted:
        y = apply_shifted_mask(y, pd)
    return y.to(xp.dtype)


def max_pool_packed(xp: torch.Tensor, dims=None) -> torch.Tensor:
    """k2 s2 max-pool of the fine grid: a max over the parity blocks, then a
    pairwise max on unpacked dims (an odd tail dropped, as torch's VALID
    pool). Returns the UNPACKED coarse grid (N, *g, C)."""
    nsp = xp.dim() - 2
    pd = _pdims(nsp, dims)
    f = 2 ** len(pd)
    y = xp.reshape(xp.shape[:-1] + (f, xp.shape[-1] // f)).amax(dim=-2)
    for i in range(nsp):
        if i in pd:
            continue
        ax, s = 1 + i, y.shape[1 + i]
        y = y.narrow(ax, 0, s - s % 2)
        y = y.reshape(y.shape[:ax] + (s // 2, 2) + y.shape[ax + 1:]).amax(dim=ax + 1)
    return y


def upsample2x_packed(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x2 half-pixel linear upsample (torch ``align_corners=False``) of the
    unpacked grid x (N, *g, C), emitted packed-plain on packed dims and
    interleaved on the fine grid on unpacked ones.

    Per dim: fine 2j = 0.25 x[j-1] + 0.75 x[j] and fine 2j+1 = 0.75 x[j] +
    0.25 x[j+1], edge-clamped: ``pack(upsample_linear(x, 2), dims)`` as
    shifted adds on the coarse grid.
    """
    nsp = x.dim() - 2
    pd = _pdims(nsp, dims)
    t, npar = x, 0  # parity axes appended so far, after the spatial ones
    for d in range(nsp):
        ax = 1 + d
        g = t.shape[ax]
        lo = torch.cat([t.narrow(ax, 0, 1), t.narrow(ax, 0, g - 1)], dim=ax)
        hi = torch.cat([t.narrow(ax, 1, g - 1), t.narrow(ax, g - 1, 1)], dim=ax)
        even = 0.25 * lo + 0.75 * t
        odd = 0.75 * t + 0.25 * hi
        if d in pd:
            t = torch.stack([even, odd], dim=1 + nsp + npar)
            npar += 1
        else:  # fine interleave: (.., g, 2, ..) -> (.., 2g, ..)
            t = torch.stack([even, odd], dim=ax + 1)
            t = t.reshape(t.shape[:ax] + (2 * g,) + t.shape[ax + 2:])
    return t.reshape(t.shape[:1 + nsp] + (-1,))


def concat_packed(tensors: Sequence[torch.Tensor], dims=None) -> torch.Tensor:
    """Channel concatenation in packed space: per parity block, the blocks
    of each input in order."""
    nsp = tensors[0].dim() - 2
    f = 2 ** len(_pdims(nsp, dims))
    parts = [t.reshape(t.shape[:-1] + (f, t.shape[-1] // f)) for t in tensors]
    out = torch.cat(parts, dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))
