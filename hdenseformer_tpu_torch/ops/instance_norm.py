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
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Optional

import torch

from hdenseformer_tpu_torch.ops._build import check, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # kThreads in csrc/instance_norm_relu.cu
_MAX_ROW_THREADS = 32  # threads across one row's channel tile, at most
_ONE_WAVE = 132 * 8  # blocks of 256 threads that fill an H100's 132 SMs once
_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


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


def launch_plan(n: int, s: int, c: int, elem_bytes: int, addresses=(0,)) -> LaunchPlan:
    """The launch geometry for x of (n, s, c) with ``elem_bytes``-byte elements.

    The vector is the widest of 16, 8, 4, 2 bytes (not under one element)
    that divides one row (c * elem_bytes) and every address in ``addresses``
    (x's and y's), as csrc/shift_pack.cu chooses its width. Each thread
    reduces 32 rows of a chunk, or 16 where 32 leaves the grid under one
    wave of the card.
    """
    vec = next(v for v in (16, 8, 4, 2)
               if v >= elem_bytes and (c * elem_bytes) % v == 0
               and all(a % v == 0 for a in addresses))
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


def _bc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, C) -> (N, 1, ..., 1, C), broadcastable against x."""
    return v.reshape(v.shape[0], *(1,) * (x.dim() - 2), v.shape[-1])


def instance_norm_stats_ref(x: torch.Tensor, eps: float = 1e-5):
    """Plain per-(n, c) fp32 mean and rsqrt(var + eps) of (N, *spatial, C)."""
    axes = tuple(range(1, x.dim() - 1))
    x32 = x.float()
    mean = x32.mean(axes)
    var = (x32 - _bc(mean, x)).square().mean(axes)
    return mean, torch.rsqrt(var + eps)


def _normalize_ref(x, mean, inv, scale, bias, relu):
    y = (x.float() - _bc(mean, x)) * _bc(inv, x)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


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
    mean, inv = instance_norm_stats_ref(x, eps)
    return _normalize_ref(x, mean, inv, scale, bias, relu)


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
):
    """Plain backward of ``instance_norm_relu`` given its forward's statistics.

    ``mean`` and ``inv`` are the (N, C) fp32 mean and rsqrt(var + eps).
    Returns dx in ``x.dtype`` and fp32 dscale and dbias (None without affine).
    """
    m = prod(x.shape[1:-1])
    axes = tuple(range(1, x.dim() - 1))
    dy_eff = dy
    if relu:
        dy_eff = torch.where(_relu_mask_ref(x, mean, inv, scale, bias), dy,
                             torch.zeros((), dtype=dy.dtype))
    dy32 = dy_eff.float()
    t1 = dy32.sum(axes)
    t2 = (dy32 * (x.float() - _bc(mean, x))).sum(axes)
    s1, s2 = t1, inv * t2
    gamma = torch.ones_like(inv) if scale is None else scale.float()[None]
    coef = gamma * inv
    # dx = coef * (dy_eff - s1 / m - xhat * s2 / m) in fma form
    b = -(coef * inv) * (s2 / m)
    a = -(coef * (s1 / m)) - mean * b
    dx = _bc(coef, x) * dy32 + _bc(a, x) + x.float() * _bc(b, x)
    dscale = s2.sum(0) if scale is not None else None
    dbias = s1.sum(0) if bias is not None else None
    return dx.to(x.dtype), dscale, dbias


def absolute_stats(x: torch.Tensor, stats: torch.Tensor):
    """``instance_norm_relu_fwd``'s ``stats`` as the (N, C) mean and inv of
    the plain versions, the mean rounded as the backward kernel rounds it."""
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


def instance_norm_relu_fwd(x, scale=None, bias=None, eps: float = 1e-5, relu: bool = True):
    """The forward and its statistics: y and the float32 ``stats`` buffer
    (per (n, c): the mean relative to row 0 of x, then rsqrt(var + eps)),
    which ``instance_norm_relu_bwd`` takes. A CUDA tensor launches the
    forward kernel, which writes both; a CPU tensor takes the plain versions."""
    if x.device.type == "cpu":
        mean, inv = instance_norm_stats_ref(x, eps)
        n, c = x.shape[0], x.shape[-1]
        rel = mean - x.reshape(n, -1, c)[:, 0].float()
        return (_normalize_ref(x, mean, inv, scale, bias, relu),
                torch.stack([rel, inv], -1).reshape(-1))
    n, s, c = _check_cuda(x, scale, bias, "instance_norm_relu")
    y = torch.empty_like(x)
    plan = _plan("instance_norm_relu", x, y)
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=x.device)
    stats = torch.empty(plan.stats_floats, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hdf_instance_norm_relu(
            x.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(), part.data_ptr(), stats.data_ptr(),
            _DTYPES[x.dtype], plan.vec_bytes, n, s, c, plan.channel_tile, plan.chunk,
            plan.k, eps, int(relu), stream,
        )
    check(err, "instance_norm_relu")
    instance_norm_relu.launches += 1
    return y, stats


def instance_norm_relu_bwd(
    dy: torch.Tensor,
    x: torch.Tensor,
    stats: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
):
    """Gradients (dx, dscale, dbias) of ``instance_norm_relu`` at x.

    ``stats`` is ``instance_norm_relu_fwd``'s statistics buffer for this x.
    A CUDA tensor launches the backward kernel; dy must match x in shape,
    dtype and contiguity. A CPU tensor takes ``instance_norm_relu_bwd_ref``.
    """
    if x.device.type == "cpu":
        return instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, relu)
    n, s, c = _check_cuda(x, scale, bias, "instance_norm_relu_bwd")
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
    plan = _plan("instance_norm_relu_bwd", x, dy, dx)
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=x.device)
    tsum = torch.empty(2 * n * c, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hdf_instance_norm_relu_bwd(
            x.data_ptr(), dy.data_ptr(), stats.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            dx.data_ptr(), part.data_ptr(), tsum.data_ptr(),
            _DTYPES[x.dtype], plan.vec_bytes, n, s, c, plan.channel_tile, plan.chunk,
            plan.k, int(relu), stream,
        )
    check(err, "instance_norm_relu_bwd")
    instance_norm_relu_bwd.launches += 1
    if scale is None:
        return dx, None, None
    t = tsum.view(n, c, 2)
    inv = stats.view(n, c, 2)[..., 1]
    return dx, (inv * t[..., 1]).sum(0), t[..., 0].sum(0)


class _InstanceNormReLU(torch.autograd.Function):
    """Keeps x (its own dtype) and the per-(n, c) statistics for the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, relu):
        y, stats = instance_norm_relu_fwd(x, scale, bias, eps, relu)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dscale, dbias = instance_norm_relu_bwd(dy.to(x.dtype).contiguous(), x, stats,
                                                   scale, bias, ctx.relu)
        return dx, dscale, dbias, None, None


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
    Differentiable in x, scale and bias; where there is nothing to
    differentiate (serving under ``torch.inference_mode``) the forward runs
    without the autograd function and its host cost.
    """
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias))):
        return instance_norm_relu_fwd(x, scale, bias, eps, relu)[0]
    return _InstanceNormReLU.apply(x, scale, bias, eps, relu)


# kernel launches since the last reset, per direction; chip_smoke.py reads them
instance_norm_relu.launches = 0
instance_norm_relu_bwd.launches = 0
