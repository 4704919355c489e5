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

from dataclasses import dataclass
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
    y = torch.empty_like(x)
    plan = launch_plan(n, s, c, x.element_size(), (x.data_ptr(), y.data_ptr()))
    if plan.grid[1] > _GRID_YZ or plan.grid[2] > _GRID_YZ:
        raise ValueError(f"instance_norm_relu: grid {plan.grid} too large for {tuple(x.shape)}")
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
    return y


# kernel launches since the last reset; chip_smoke.py reads it
instance_norm_relu.launches = 0
