"""InstanceNorm (+ affine) + ReLU over channels-last volumes, forward and backward.

Counterpart of ``hdenseformer_tpu/ops/instance_norm.py`` and of
``ops/fused_norm.py``: per (sample, channel) statistics over all spatial
positions, biased variance, ``eps``, batch statistics in eval as in train
(there are no running stats), fp32 statistics, output in ``x.dtype``.

- ``instance_norm_relu_ref`` is the plain forward, ported from
  ``xla_instance_norm_relu``: a centered two-pass variance. Autograd through
  it is the plain path's gradient.
- ``instance_norm_relu_bwd_ref`` is the plain backward, a line-for-line
  port of ``fused_norm._bwd_rule`` (unshifted, per sample): the ReLU mask
  rebuilt from x against a per-(n, c) threshold, the dual reduce (t1, t2)
  and the fma form of dx.
- ``instance_norm_relu`` is the autograd function over the two kernel
  wrappers ``instance_norm_relu_fwd`` and ``instance_norm_relu_bwd``. A
  CUDA tensor launches the hand-written forward and backward kernels of
  ``csrc/instance_norm_relu.cu``; a CPU tensor takes the plain versions;
  any other device raises. The forward keeps x in its own dtype and the
  per-(n, c) statistics, nothing of full size in fp32, as ``fused_norm``'s
  residuals.
- ``launch_plan`` cuts the forward's grid, ``bwd_launch_plan`` the
  backward's: one persistent, co-resident grid that reduces, waits at a
  grid barrier and then writes dx.

``shifted`` (None, or the packed dims of ``ops/s2d.py``, True for all) is
``fused_norm``'s argument of the same name: x is then a packed-shifted
tensor (N, *s, f*C), the output of a ``conv3_packed_p2s``, normalised per
(sample, channel c) over space and the f parity blocks, less the pad slots
(``s2d.shifted_mask_factors``), which hold conv garbage: they are left out
of the statistics, their dy is ignored, and y and dx are 0 there. The
kernels take it as the (N, S*f, C) view whose row r is cell r / f, block r
% f, and decode each row's pad status from its index, stepping each
thread's walk over its rows without a division (``pad_walk`` mirrors it).
Their launches count under ``instance_norm_relu_shifted`` and
``instance_norm_relu_shifted_bwd``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from math import prod
from typing import Optional

import numpy as np
import torch

from hdenseformer_tpu_torch.ops._build import check, load_library
from hdenseformer_tpu_torch.ops.s2d import _pdims, shifted_count, shifted_mask_factors

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # kThreads in csrc/instance_norm_relu.cu
_MAX_ROW_THREADS = 32  # threads across one row's channel tile, at most
_ONE_WAVE = 132 * 8  # blocks of 256 threads that fill an H100's 132 SMs once
_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
# The backward (bwd_persistent_kernel): a channel tile is 128 or 64 bytes of
# a row, at most 32 threads and 64 channels
_BWD_TILE_BYTES = (128, 64)
_BWD_MAX_TILE = 64  # kMaxTile in csrc/instance_norm_relu.cu


@dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/instance_norm_relu.cu`` cuts an (N, S, C) input.

    Each thread moves ``vec_bytes`` per access: ``cv`` channels of one row.
    ``row_threads`` threads (a power of two) cover the ``channel_tile``
    channels of a row, so a block of 256 threads covers ``rows_per_block``
    rows at a time and ``chunk`` = rows_per_block * ``rows_per_thread`` rows
    in all. ``grid`` is (chunks per sample K, N, channel tiles), the same for
    the statistics and the normalize pass.
    """

    vec_bytes: int
    cv: int
    vectors_per_row: int
    row_threads: int
    channel_tile: int
    rows_per_block: int
    rows_per_thread: int
    chunk: int
    k: int
    grid: tuple
    part_floats: int
    stats_floats: int

    def cell_step(self, f: int) -> int:
        """Cells between a thread's rows in the shifted mode (f parity blocks)."""
        return self.rows_per_block // f


def launch_plan(n: int, s: int, c: int, elem_bytes: int, addresses=(0,)) -> LaunchPlan:
    """The launch geometry for x of (n, s, c) with ``elem_bytes``-byte elements.

    The vector is the widest of 16, 8, 4, 2 bytes (not under one element)
    that divides one row (c * elem_bytes) and every address in ``addresses``
    (x's and y's), as csrc/shift_pack.cu chooses its width. Each thread
    reduces 32 rows of a chunk, or 16 where 32 leaves the grid under one
    wave of the card.
    """
    vec = _vector_bytes(c, elem_bytes, addresses)
    cv = vec // elem_bytes
    vpr = c // cv
    row_threads = min(_MAX_ROW_THREADS, 1 << (vpr - 1).bit_length())
    rows_per_block = _THREADS // row_threads
    tiles = -(-vpr // row_threads)
    for m in (32, 16):
        chunk = rows_per_block * m
        k = -(-s // chunk)
        if k * n * tiles >= _ONE_WAVE:
            break
    return LaunchPlan(
        vec_bytes=vec, cv=cv, vectors_per_row=vpr, row_threads=row_threads,
        channel_tile=row_threads * cv, rows_per_block=rows_per_block, rows_per_thread=m,
        chunk=chunk, k=k, grid=(k, n, tiles), part_floats=2 * n * c * k,
        stats_floats=2 * n * c,
    )


def _vector_bytes(c: int, elem_bytes: int, addresses) -> int:
    return next(v for v in (16, 8, 4, 2)
                if v >= elem_bytes and (c * elem_bytes) % v == 0
                and all(a % v == 0 for a in addresses))


@dataclass(frozen=True)
class BwdPlan:
    """How ``bwd_persistent_kernel`` cuts an (N, S, C) backward.

    ``row_threads`` threads of ``vec_bytes`` (at most 32) cover a
    ``channel_tile`` of 128 or 64 bytes of a row, so a block of 256 threads covers ``rows_per_unit``
    rows of one tile at a time: a unit. Each (n, tile) has ``units`` units,
    dealt to ``parts`` parts (part j takes units j, j + parts, ...), so that
    the grid reads one narrow window of memory at a time. Item (n, tile,
    part) is numbered ``(n * tiles + tile) * parts + part``, and block b of
    ``grid`` owns items [b * items // grid, (b + 1) * items // grid).
    ``part_floats`` is the scratch of one (t1, t2) pair per (n, c, part).
    """

    vec_bytes: int
    cv: int
    vectors_per_row: int
    row_threads: int
    channel_tile: int
    rows_per_unit: int
    tiles: int
    units: int
    parts: int
    items: int
    grid: int
    part_floats: int
    tsum_floats: int

    def cell_step(self, f: int) -> int:
        """Cells between a thread's rows of one item in the shifted mode."""
        return self.parts * self.rows_per_unit // f


def bwd_launch_plan(n: int, s: int, c: int, elem_bytes: int, addresses=(0,), sms: int = 132,
                    blocks_per_sm: int = 2) -> BwdPlan:
    """The backward's launch geometry on a card of ``sms`` multiprocessors
    that each hold ``blocks_per_sm`` of its blocks.

    The vector is the forward's. The tile is 128 bytes of a row (a whole row
    where it is shorter: fewer, longer reads) unless 64 bytes give the
    co-resident grid more of the items it can hold. Each (n, tile) gets as
    many parts as the grid allows, but no more than its units; where N *
    tiles exceeds the grid, each (n, tile) is one part and a block owns
    several.
    """
    return _bwd_plan(n, s, c, elem_bytes, _vector_bytes(c, elem_bytes, addresses), sms,
                     blocks_per_sm)


@lru_cache(maxsize=1024)
def _bwd_plan(n, s, c, elem_bytes, vec, sms, blocks_per_sm) -> BwdPlan:
    cv = vec // elem_bytes
    vpr = c // cv
    co = sms * blocks_per_sm
    cuts = []  # (items, tv, tiles, units, parts) of the 128- and the 64-byte tile
    for tile_bytes in _BWD_TILE_BYTES:
        tv = min(1 << (vpr - 1).bit_length(), max(1, tile_bytes // vec), _BWD_MAX_TILE // cv,
                 _MAX_ROW_THREADS)
        tiles = -(-vpr // tv)
        units = -(-s // (_THREADS // tv))
        parts = max(1, min(co // (n * tiles), units))
        cuts.append((n * tiles * parts, tv, tiles, units, parts))
    wide, narrow = cuts
    items, tv, tiles, units, parts = wide if wide[0] >= min(co, narrow[0]) else narrow
    return BwdPlan(
        vec_bytes=vec, cv=cv, vectors_per_row=vpr, row_threads=tv, channel_tile=tv * cv,
        rows_per_unit=_THREADS // tv, tiles=tiles, units=units, parts=parts, items=items,
        grid=min(items, co), part_floats=2 * n * c * parts, tsum_floats=2 * n * c,
    )


def _bc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, C) -> (N, 1, ..., 1, C), broadcastable against x."""
    return v.reshape(v.shape[0], *(1,) * (x.dim() - 2), v.shape[-1])


@dataclass(frozen=True)
class Shift:
    """A packed-shifted input: its packed ``dims``, spatial shape ``sshape``,
    parity blocks ``f`` and the valid rows ``m`` of its (N, S*f, C) view, a
    sample (``fused_norm._count``)."""

    dims: tuple
    sshape: tuple
    f: int
    m: int

    def walk(self, step: int) -> tuple:
        """The constants of the kernels' pad walk (``PadWalk``) whose rows
        step by ``step`` cells: per packed dim, leading first, the cells
        between neighbours along it (stride), the period of its coordinate
        in the cell index (extent * stride), and ``step`` modulo the period."""
        stride = tuple(prod(self.sshape[i + 1:]) for i in self.dims)
        period = tuple(self.sshape[i] * st for i, st in zip(self.dims, stride))
        return stride, period, tuple(step % p for p in period)

    def args(self, step: int) -> tuple:
        """The C interface's npk, stride, period and step (``walk(step)``)."""
        return (len(self.dims), *((ctypes.c_int * 3)(*v) for v in self.walk(step)))


def pad_walk(sh: Shift, step: int, starts, count: int, reverse: bool = False) -> np.ndarray:
    """A numpy mirror of the kernels' per-thread pad walk (``PadWalk`` in
    csrc/instance_norm_relu.cu): for each row in ``starts`` of the (S*f)
    view, whether each of its ``count`` rows r, r + step*f, r + 2*step*f, ...
    (r - step*f, ... with ``reverse``) is a pad slot, (len(starts), count).

    As the kernel does it, from ``Shift.walk(step)``: the parity block p = r
    % f is the walk's throughout, each packed dim's residue x = cell % period
    is taken once, then moves by the step's residue with one conditional
    correction, and a row is a pad slot where some x lies in [lo, lo +
    stride) (unsigned 32-bit), lo = 0 where p's bit for the dim is 1, else
    period - stride."""
    stride, period, dstep = sh.walk(step)
    npk = len(sh.dims)
    starts = np.asarray(starts, np.int64)
    cell, p = starts >> npk, starts & (sh.f - 1)
    pad = np.zeros((starts.size, count), bool)
    for j in range(npk):
        x = cell % period[j]
        lo = np.where((p >> (npk - 1 - j)) & 1, 0, period[j] - stride[j])
        for i in range(count):
            pad[:, i] |= (x - lo) % 2**32 < stride[j]
            if reverse:
                x = np.where(x >= dstep[j], x - dstep[j], x + (period[j] - dstep[j]))
            else:
                x = x + dstep[j]
                x = np.where(x >= period[j], x - period[j], x)
    return pad


def shift_of(x: torch.Tensor, shifted) -> Optional[Shift]:
    """The ``Shift`` of a packed-shifted x (``shifted``: its packed dims, or
    True for all), or None for None or False. Raises where a packed dim has
    fewer than 2 cells: row 0 would be a pad, and the kernels shift by it."""
    if shifted is None or shifted is False:
        return None
    nsp = x.dim() - 2
    dims = _pdims(nsp, None if shifted is True else shifted)
    sshape = tuple(x.shape[1:-1])
    f = 2 ** len(dims)
    if x.shape[-1] % f or any(sshape[i] < 2 for i in dims):
        raise ValueError(f"{tuple(x.shape)} is not a packed-shifted tensor over dims {dims}")
    return Shift(dims, sshape, f, shifted_count(sshape, dims))


def _rows(x: torch.Tensor, sh: Optional[Shift]):
    """(the (N, S*f, C) view of a shifted x, its valid rows as a (1, S*f, 1)
    bool mask) or (x, None) unshifted."""
    if sh is None:
        return x, None
    return x.reshape(x.shape[0], -1, x.shape[-1] // sh.f), _valid_rows(sh, x.device)


@lru_cache(maxsize=64)
def _valid_rows(sh: Shift, device: torch.device) -> torch.Tensor:
    nsp = len(sh.sshape)
    valid = np.ones(sh.sshape + (sh.f,), bool)
    for i, m in shifted_mask_factors(sh.sshape, sh.f, 1, sh.dims):  # (s_i, f) factors
        valid &= m.reshape((1,) * i + (m.shape[0],) + (1,) * (nsp - 1 - i) + (sh.f,))
    with torch.inference_mode(False):
        return torch.from_numpy(valid.reshape(1, -1, 1)).to(device)


def _where(valid: Optional[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
    """v at valid rows, 0 at pad rows (a select: pads may hold anything)."""
    return v if valid is None else torch.where(valid, v, torch.zeros((), dtype=v.dtype))


def instance_norm_stats_ref(x: torch.Tensor, eps: float = 1e-5, shifted=None):
    """Plain per-(n, c) fp32 mean and rsqrt(var + eps) of (N, *spatial, C),
    or with ``shifted`` of the valid slots of a packed-shifted (N, *s, f*C),
    two-pass as ``fused_norm._stats``."""
    sh = shift_of(x, shifted)
    x, valid = _rows(x, sh)
    axes = tuple(range(1, x.dim() - 1))
    m = prod(x.shape[1:-1]) if sh is None else sh.m
    x32 = x.float()
    mean = _where(valid, x32).sum(axes) / m
    var = _where(valid, (x32 - _bc(mean, x)).square()).sum(axes) / m
    return mean, torch.rsqrt(var + eps)


def _normalize_ref(x, mean, inv, scale, bias, relu, valid=None):
    y = (x.float() - _bc(mean, x)) * _bc(inv, x)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return _where(valid, y).to(x.dtype)


def instance_norm_relu_ref(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    relu: bool = True,
    shifted=None,
) -> torch.Tensor:
    """Plain fp32-statistics instance norm + optional affine + ReLU.

    x: (N, *spatial, C), or with ``shifted`` a packed-shifted (N, *s, f*C)
    (``fused_norm.instance_norm_relu(shifted=...)``: pad slots out of the
    statistics and 0 in the output).
    """
    mean, inv = instance_norm_stats_ref(x, eps, shifted)
    xv, valid = _rows(x, shift_of(x, shifted))
    return _normalize_ref(xv, mean, inv, scale, bias, relu, valid).reshape(x.shape)


def _relu_mask_ref(x, mean, inv, scale, bias):
    """pre > 0 as per-(n, c) thresholds on x (``fused_norm._relu_mask``)."""
    x32 = x.float()
    if scale is None:
        return x32 > _bc(mean, x)
    g = scale.float()[None]
    b = bias.float()[None]
    gsafe = torch.where(g == 0.0, torch.ones_like(g), g)
    thr_bc = _bc(mean - b / (gsafe * inv), x)
    g_bc, b_bc = _bc(g, x), _bc(b, x)
    return torch.where(g_bc > 0, x32 > thr_bc, torch.where(g_bc < 0, x32 < thr_bc, b_bc > 0))


def instance_norm_relu_bwd_ref(
    dy: torch.Tensor,
    x: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
    shifted=None,
):
    """Plain backward of ``instance_norm_relu`` given its forward's statistics.

    ``mean`` and ``inv`` are the (N, C) fp32 mean and rsqrt(var + eps).
    Returns dx in ``x.dtype`` and shape and fp32 dscale and dbias (None
    without affine). With ``shifted`` (``fused_norm._bwd_rule``'s mask), dy
    at pad slots is ignored and dx is 0 there.
    """
    shape, sh = x.shape, shift_of(x, shifted)
    x, valid = _rows(x, sh)
    dy = dy.reshape(x.shape)
    m = prod(x.shape[1:-1]) if sh is None else sh.m
    axes = tuple(range(1, x.dim() - 1))
    dy_eff = dy
    if relu:
        dy_eff = torch.where(_relu_mask_ref(x, mean, inv, scale, bias), dy,
                             torch.zeros((), dtype=dy.dtype))
    dy_eff = _where(valid, dy_eff)  # pad slots carry no gradient
    dy32 = dy_eff.float()
    t1 = dy32.sum(axes)
    t2 = _where(valid, dy32 * (x.float() - _bc(mean, x))).sum(axes)
    s1, s2 = t1, inv * t2
    gamma = torch.ones_like(inv) if scale is None else scale.float()[None]
    coef = gamma * inv
    # dx = coef * (dy_eff - s1 / m - xhat * s2 / m) in fma form
    b = -(coef * inv) * (s2 / m)
    a = -(coef * (s1 / m)) - mean * b
    dx = _where(valid, _bc(coef, x) * dy32 + _bc(a, x) + x.float() * _bc(b, x))
    dscale = s2.sum(0) if scale is not None else None
    dbias = s1.sum(0) if bias is not None else None
    return dx.to(x.dtype).reshape(shape), dscale, dbias


def absolute_stats(x: torch.Tensor, stats: torch.Tensor, shifted=None):
    """``instance_norm_relu_fwd``'s ``stats`` as the (N, C) mean and inv of
    the plain versions, the mean rounded as the backward kernel rounds it."""
    x, _ = _rows(x, shift_of(x, shifted))
    n, c = x.shape[0], x.shape[-1]
    st = stats.view(n, c, 2)
    return x.reshape(n, -1, c)[:, 0].float() + st[..., 0], st[..., 1]


def _check_cuda(x: torch.Tensor, scale, bias, what: str) -> tuple[int, int, int]:
    """(n, s, c) of a CUDA x that the kernels take; raises otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {x.dtype} is not float32 or bfloat16")
    if x.dim() < 3:
        raise ValueError(f"{what}: expected (N, *spatial, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            f"{what}: x {tuple(x.shape)} with strides {x.stride()} is not "
            "contiguous channels-last"
        )
    if (scale is None) != (bias is None):
        raise ValueError(f"{what}: give both scale and bias, or neither")
    n, c = x.shape[0], x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (
            t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"{what}: {name} must be a contiguous float32 ({c},) on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    return n, x.numel() // (n * c), c


def _plan(what: str, x: torch.Tensor, *tensors: torch.Tensor) -> LaunchPlan:
    n, c = x.shape[0], x.shape[-1]
    plan = launch_plan(n, x.numel() // (n * c), c, x.element_size(),
                       tuple(t.data_ptr() for t in (x, *tensors)))
    if plan.grid[1] > _GRID_YZ or plan.grid[2] > _GRID_YZ:
        raise ValueError(f"{what}: grid {plan.grid} too large for {tuple(x.shape)}")
    return plan


def instance_norm_relu_fwd(x, scale=None, bias=None, eps: float = 1e-5, relu: bool = True,
                          shifted=None):
    """The forward and its statistics: y and the float32 ``stats`` buffer
    (per (n, c): the mean relative to row 0 of x, then rsqrt(var + eps)),
    which ``instance_norm_relu_bwd`` takes. A CUDA tensor launches the
    forward kernel (its shifted mode with ``shifted``), which writes both; a
    CPU tensor takes the plain versions."""
    sh = shift_of(x, shifted)
    xv, valid = _rows(x, sh)
    if x.device.type == "cpu":
        mean, inv = instance_norm_stats_ref(x, eps, shifted)
        n, c = xv.shape[0], xv.shape[-1]
        rel = mean - xv.reshape(n, -1, c)[:, 0].float()
        y = _normalize_ref(xv, mean, inv, scale, bias, relu, valid)
        return y.reshape(x.shape), torch.stack([rel, inv], -1).reshape(-1)
    what = "instance_norm_relu" if sh is None else "instance_norm_relu_shifted"
    n, s, c = _check_cuda(xv, scale, bias, what)
    y = torch.empty_like(x)
    plan = _plan(what, xv, y)
    # the shifted mode's partials end with each chunk's count of valid rows
    part = torch.empty(plan.part_floats + (0 if sh is None else plan.k), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty(plan.stats_floats, dtype=torch.float32, device=x.device)
    lib = load_library()
    args = (
        x.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        y.data_ptr(), part.data_ptr(), stats.data_ptr(),
        _DTYPES[x.dtype], plan.vec_bytes, n, s, c, plan.channel_tile, plan.chunk,
        plan.k, eps, int(relu),
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if sh is None:
            err = lib.hdf_instance_norm_relu(*args, stream)
        else:
            err = lib.hdf_instance_norm_relu_shifted(
                *args, *sh.args(plan.cell_step(sh.f)), stream)
    check(err, what)
    (instance_norm_relu if sh is None else instance_norm_relu_shifted).launches += 1
    return y, stats


def instance_norm_relu_bwd(
    dy: torch.Tensor,
    x: torch.Tensor,
    stats: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
    shifted=None,
):
    """Gradients (dx, dscale, dbias) of ``instance_norm_relu`` at x.

    ``stats`` is ``instance_norm_relu_fwd``'s statistics buffer for this x
    (and this ``shifted``). A CUDA tensor launches the backward kernel; dy
    must match x in shape, dtype and contiguity. A CPU tensor takes
    ``instance_norm_relu_bwd_ref``.
    """
    if x.device.type == "cpu":
        return instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats, shifted), scale,
                                          bias, relu, shifted)
    sh = shift_of(x, shifted)
    n, _, c = _check_cuda(_rows(x, sh)[0], scale, bias, "instance_norm_relu_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(
            f"instance_norm_relu_bwd: dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does "
            f"not match x {tuple(x.shape)} {x.dtype} on {x.device}"
        )
    if not dy.is_contiguous():
        raise ValueError(f"instance_norm_relu_bwd: dy strides {dy.stride()} are not contiguous")
    if stats.dtype != torch.float32 or stats.numel() != 2 * n * c or not stats.is_contiguous():
        raise ValueError(f"instance_norm_relu_bwd: stats must be float32 of {2 * n * c}")
    dx = torch.empty_like(x)
    return launch_bwd(bwd_plan(x, dy, dx, shift=sh), dx, dy, x, stats, scale, bias, relu, sh)


def launch_bwd(plan: BwdPlan, dx, dy, x, stats, scale, bias, relu: bool,
               shift: Optional[Shift] = None):
    """One launch of the backward kernel with ``plan`` (its shifted mode with
    a ``shift``), writing ``dx``; the arguments as ``instance_norm_relu_bwd``
    checked them. Returns (dx, dscale, dbias)."""
    n = x.shape[0]
    c = x.shape[-1] // (1 if shift is None else shift.f)
    s = x.numel() // (n * c)
    lib = load_library()
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=x.device)
    tsum = torch.empty(plan.tsum_floats, dtype=torch.float32, device=x.device)
    # dscale then dbias, summed by the kernel
    dsb = None if scale is None else torch.empty(2 * c, dtype=torch.float32, device=x.device)
    args = (
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        dx.data_ptr(), part.data_ptr(), part.numel(), tsum.data_ptr(),
        None if dsb is None else dsb.data_ptr(),
        _DTYPES[x.dtype], plan.vec_bytes, n, s, c, plan.channel_tile, plan.parts,
        plan.grid, int(relu),
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if shift is None:
            err = lib.hdf_instance_norm_relu_bwd(*args, stream)
        else:
            err = lib.hdf_instance_norm_relu_bwd_shifted(
                *args, float(shift.m), *shift.args(plan.cell_step(shift.f)), stream)
    check(err, "instance_norm_relu_bwd" if shift is None else "instance_norm_relu_shifted_bwd")
    (instance_norm_relu_bwd if shift is None else instance_norm_relu_shifted_bwd).launches += 1
    if dsb is None:
        return dx, None, None
    return dx, dsb[:c], dsb[c:]


def bwd_plan(x: torch.Tensor, *others: torch.Tensor, shift: Optional[Shift] = None) -> BwdPlan:
    """The backward's plan for x (N, *spatial, C), or a packed-shifted x with
    its ``shift``, on its card, vectors aligned to x and ``others`` (dy, dx):
    the card's multiprocessors and the blocks each holds, as the (shifted)
    kernel's occupancy query reports them."""
    n = x.shape[0]
    c = x.shape[-1] // (1 if shift is None else shift.f)
    vec = _vector_bytes(c, x.element_size(), tuple(t.data_ptr() for t in (x, *others)))
    return _bwd_plan(n, x.numel() // (n * c), c, x.element_size(), vec,
                     *_bwd_residency(load_library(), x.device, x.dtype, vec, shift is not None))


@lru_cache(maxsize=None)
def _bwd_residency(lib, device: torch.device, dtype: torch.dtype, vec: int,
                   shifted: bool = False) -> tuple[int, int]:
    """(multiprocessors, backward blocks each holds at once) of the card."""
    with torch.cuda.device(device):
        blocks = _attributes(lib, KERNEL_NAMES.index("bwd_persistent_kernel"), dtype, vec,
                             shifted)[2]
    if blocks < 1:
        raise RuntimeError("instance_norm_relu_bwd: no block of the backward fits a "
                           "multiprocessor")
    return torch.cuda.get_device_properties(device).multi_processor_count, blocks


KERNEL_NAMES = ("partial_stats_kernel", "normalize_kernel", "bwd_persistent_kernel")
_ATTRIBUTES = ("registers", "local_bytes", "blocks_per_sm")


def _attributes(lib, which: int, dtype: torch.dtype, vec: int, shifted: bool) -> tuple:
    """``_ATTRIBUTES`` of kernel ``KERNEL_NAMES[which]`` on the current card."""
    buf = (ctypes.c_int * 3)()
    check(lib.hdf_instance_norm_relu_kernel_attributes(which, _DTYPES[dtype], vec, int(shifted),
                                                       buf),
          f"instance_norm_relu {KERNEL_NAMES[which]} attributes")
    return tuple(buf)


def kernel_attributes(dtype: torch.dtype, vec_bytes: int, shifted: bool = False) -> dict:
    """Per kernel of ``KERNEL_NAMES`` (the shifted instantiations where
    ``shifted``) at ``vec_bytes``-byte vectors: registers a thread, local
    (spilled) bytes a thread and blocks of 256 threads a multiprocessor of
    the current card holds, from cudaFuncGetAttributes and the occupancy
    query."""
    lib = load_library()
    return {name: dict(zip(_ATTRIBUTES, _attributes(lib, which, dtype, vec_bytes, shifted)))
            for which, name in enumerate(KERNEL_NAMES)}


class _InstanceNormReLU(torch.autograd.Function):
    """Keeps x (its own dtype) and the per-(n, c) statistics for the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, relu, shifted):
        y, stats = instance_norm_relu_fwd(x, scale, bias, eps, relu, shifted)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.relu, ctx.shifted = relu, shifted
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dscale, dbias = instance_norm_relu_bwd(dy.to(x.dtype).contiguous(), x, stats,
                                                   scale, bias, ctx.relu, ctx.shifted)
        return dx, dscale, dbias, None, None, None


def instance_norm_relu(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    relu: bool = True,
    shifted=None,
) -> torch.Tensor:
    """Instance norm + optional affine + ReLU of a channels-last (N, *spatial, C).

    On CUDA, x must be contiguous in that order (an NCDHW tensor in
    ``torch.channels_last_3d`` memory, permuted to NDHWC, is) and float32 or
    bfloat16; scale and bias are both given or both None, each a float32
    (C,) tensor on x's device. Nothing is copied to make it so.
    Differentiable in x, scale and bias; where there is nothing to
    differentiate (serving under ``torch.inference_mode``) the forward runs
    without the autograd function and its host cost. ``shifted``: x is a
    packed-shifted (N, *s, f*C) (see the module docstring).
    """
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias))):
        return instance_norm_relu_fwd(x, scale, bias, eps, relu, shifted)[0]
    return _InstanceNormReLU.apply(x, scale, bias, eps, relu, shifted)


def instance_norm_relu_shifted(x: torch.Tensor, dims, scale=None, bias=None, eps: float = 1e-5,
                               relu: bool = True) -> torch.Tensor:
    """``instance_norm_relu`` of a packed-shifted x over packed ``dims``."""
    return instance_norm_relu(x, scale, bias, eps, relu, shifted=dims)


def instance_norm_relu_shifted_bwd(dy, x, stats, dims, scale=None, bias=None,
                                   relu: bool = True):
    """``instance_norm_relu_bwd`` of a packed-shifted x over packed ``dims``."""
    return instance_norm_relu_bwd(dy, x, stats, scale, bias, relu, shifted=dims)


# kernel launches since the last reset, per kernel and mode; chip_smoke.py reads them
instance_norm_relu.launches = 0
instance_norm_relu_bwd.launches = 0
instance_norm_relu_shifted.launches = 0
instance_norm_relu_shifted_bwd.launches = 0
