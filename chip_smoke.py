#!/usr/bin/env python3
"""The port's hand-written kernels alone on one GPU, each against its plain version.

    python3 chip_smoke.py [--seed 0] [--phase all|mha]

(``--phase mha`` runs phases 0 and 1m alone.)

Run from the repository root on a machine with an NVIDIA H100. Each kernel
is held against its plain version at the shapes of the system's
configurations and timed there. Times are device times under torch.profiler
(the kernels' durations, no host time between launches). A kernel's bound
is the larger of its bytes over the HBM rate and its operations over the
peak for the input type: the H100 SXM's figures of ``portbench/roofline.py``
(3.35 TB/s, 989 TFLOP/s in bf16, 16 ``ex2`` a clock on each of 132 SMs at
the card's maximum SM clock) and 67 TFLOP/s in fp32 outside the tensor
cores. The phases:

0. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build and what ptxas reported;
1. each kernel against its plain version on the card at the serving
   shapes, with its stated tolerance (InstanceNorm also on 1000 + N(0, 1),
   the guard of its centred statistics; both redesigned kernels rerun
   bitwise), timed beside the plain version, one PyTorch call that
   computes the same function where there is one, and its bound.
   InstanceNorm is also timed by pass and at each of its shapes in a
   HDenseFormer_32 serving forward (summed as per_forward_*), attention also
   on the qkv-split layout that serving gives it and on peaked scores, with
   its occupancy; then the path of the half-shift's backward kernel: the
   gradient of sum(conv3_packed(x, w)^2) through autograd;
1m. the fused attention at head width 64 (``ops/mha.py``) at TransBTS's
   (2, 8, 5832, 64) bf16 in training (dropout 0.1 by a drawn keep mask):
   forward and backward against the plain math (largest error of O, dQ,
   dK, dV over the plain output's largest), rerun bitwise; device times of
   the forward and of the backward's two kernels beside their bounds (the
   larger of products over the bf16 peak with dS's three-part split counted
   once, the exponentials, and the mask's bytes), the mask's draw, the plain
   math's forward and backward, and ``F.scaled_dot_product_attention`` with
   dropout 0.1 as ``library_ms`` (a yardstick: the port never calls it);
1b. the InstanceNorm backward kernel (one cooperative launch) against its
   plain version (the port of fused_norm's VJP) given the same statistics,
   rerun bitwise, at the train step's largest shape (1, 144^3, 32) in bf16
   and fp32, at ragged S with C in {2, 32, 256}, affine and plain, ReLU on
   and off, and on 1000 + N(0, 1); timed against its byte bound (its launch
   plan printed beside), beside the plain version and torch.autograd.grad
   through F.relu(F.instance_norm(...)); summed over the 18 InstanceNorm
   shapes of a HDenseFormer_32 train step at batch 1 (forward and backward)
   and over the 30 backward shapes of a Hecktor20Top1 train step at batch 2;
4p (a). the shifted InstanceNorm forward and backward kernels (the packed
   levels' norms) against their plain versions at HDenseFormer_32's level 0
   in serving (8 windows of 144 x 73 x 73 shifted cells of 4 x 32 channels;
   backward at batch 1) and at HDenseFormer_2D_32's (24 x 193 x 193 cells;
   backward at batch 24), with garbage in the pad slots, which must come out
   0: phase 1's and 1b's bars, timed against their bounds and plain
   versions, and in turns with the unshifted kernels on the same bytes (the
   shifted mode's own cost), by pass, with each instantiation's registers
   and blocks per multiprocessor, beside the shifted kernels' first design's;
4b. UNETR's InstanceNorm shapes at batch 2 (affine, ReLU off, bf16), forward
   and backward kernels against their plain versions and timed, summed over
   a forward and a step;
4c. the kernels at the PI-CAI22 preset's 2-D shapes (384^2, batch 24, bf16):
   attention at one modality path's (24, 8, 576, 4) and each of
   HDenseFormer_2D_32's InstanceNorm shapes, forward and backward, against
   their plain versions with phase 1's and 1b's bars, timed beside their
   bounds and summed over a forward and a step;
1a. the attention backward kernels (a dQ pass, then a dK/dV pass) at the
   train steps' shapes in bf16, the 2-D (24, 8, 576, 4) and the 3-D
   (2, 8, 729, 4), on head views of one qkv: dQ, dK and dV against float64
   math, each error within twice the plain bf16 math's (by the largest and
   by the mean, over the float64 gradient's), rerun bitwise, one backward
   launch a backward; device
   times against the bound (the larger of bytes over HBM and the N^2
   exponentials a (b, h) once), beside the plain math's backward as the
   autograd function ran it before (the forward recomputed, then its
   vector-Jacobian product) and ``F.scaled_dot_product_attention`` forward
   and backward as ``library_ms`` (a yardstick: the port never calls it);
6. a {"kernels": [...]} line with each kernel's numbers;
7. the result line {"ok": true, "device": {...}}.

The models, serving, the train steps, the trainer and data parallel are held
on the card by ``tests/test_torch_cuda.py`` and timed end to end by
``portbench/run.py``; this script times the kernels alone.

Any failed check exits non-zero before the result line, as does a machine
without a CUDA device. fp32 comparisons run with TF32 off in cuDNN and
cuBLAS (set below for the whole run), since a float32 convolution otherwise
runs in TF32 on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from hdenseformer_tpu_torch.models.layers import dropout_keep
from hdenseformer_tpu_torch.ops import _build
from hdenseformer_tpu_torch.ops.dense_attention import attention_ref, dense_attention
from hdenseformer_tpu_torch.ops.dense_attention import bwd_launch_plan as attention_bwd_plan
from hdenseformer_tpu_torch.ops.dense_attention import launch_plan as attention_plan
from hdenseformer_tpu_torch.ops.instance_norm import (
    absolute_stats,
    instance_norm_relu,
    instance_norm_relu_bwd,
    instance_norm_relu_bwd_ref,
    instance_norm_relu_fwd,
    instance_norm_relu_ref,
    instance_norm_relu_shifted,
    instance_norm_relu_shifted_bwd,
    kernel_attributes,
    shift_of,
)
from hdenseformer_tpu_torch.ops.instance_norm import bwd_plan as norm_bwd_plan
from hdenseformer_tpu_torch.ops.mha import attention_ref as mha_ref
from hdenseformer_tpu_torch.ops.mha import mha
from hdenseformer_tpu_torch.ops.s2d import apply_shifted_mask, conv3_packed
from hdenseformer_tpu_torch.ops.shift_pack import (
    shift_pack,
    shift_pack_ref,
    shift_unpack,
    shift_unpack_ref,
)
from portbench.roofline import (
    EX2_PER_CLOCK_SM,
    HBM_BYTES_PER_S,
    PEAK_BF16_FLOPS,
    SM_COUNT,
    sm_clock_hz,
)

PEAK_OPS_PER_S = {torch.bfloat16: PEAK_BF16_FLOPS,
                  torch.float32: 67e12}  # H100 SXM data sheet, outside the tensor cores
PATCH, WINDOWS = 144, 8  # the 3-D presets' patch, and a serving call's windows
BF16_STEP = 2.0 ** -7  # spacing of bf16 values relative to their magnitude, at most

KERNELS = {
    "dense_attention": dict(
        wrapper=dense_attention,
        source="hdenseformer_tpu_torch/csrc/dense_attention.cu",
        replaces="hdenseformer_tpu/ops/dense_attention.py:59",
    ),
    "instance_norm_relu": dict(
        wrapper=instance_norm_relu,
        source="hdenseformer_tpu_torch/csrc/instance_norm_relu.cu",
        replaces="hdenseformer_tpu/ops/instance_norm.py:56",
    ),
    "shift_pack": dict(
        wrapper=shift_pack,
        source="hdenseformer_tpu_torch/csrc/shift_pack.cu",
        replaces="hdenseformer_tpu/ops/shift_pack.py:95",
    ),
    "shift_pack_backward": dict(
        wrapper=shift_unpack,
        source="hdenseformer_tpu_torch/csrc/shift_pack.cu",
        replaces="hdenseformer_tpu/ops/shift_pack.py:133",
    ),
    # the counterpart of fused_norm's VJP, plain XLA in JAX (not Pallas)
    "instance_norm_relu_backward": dict(
        wrapper=instance_norm_relu_bwd,
        source="hdenseformer_tpu_torch/csrc/instance_norm_relu.cu",
        replaces="hdenseformer_tpu/ops/fused_norm.py:271",
    ),
    # the shifted mode of both (a packed-shifted input, pad slots masked):
    # fused_norm.instance_norm_relu(shifted=dims) and its VJP, plain XLA in JAX
    "instance_norm_relu_shifted": dict(
        wrapper=instance_norm_relu_shifted,
        source="hdenseformer_tpu_torch/csrc/instance_norm_relu.cu",
        replaces="hdenseformer_tpu/ops/fused_norm.py:201",
    ),
    "instance_norm_relu_shifted_backward": dict(
        wrapper=instance_norm_relu_shifted_bwd,
        source="hdenseformer_tpu_torch/csrc/instance_norm_relu.cu",
        replaces="hdenseformer_tpu/ops/fused_norm.py:271",
    ),
}
# packed-plain grid and channel counts of Hecktor20Top1's four half-shifts in
# one serving forward (8 windows of 144^3, n_filters 32): the k7 stem (2
# channels), block_1_2_left (32), block_1_1_right (64), block_1_2_right (32)
SHIFT_FC = (16, 256, 512, 256)
# (S, C), count and affine of HDenseFormer_32's unshifted InstanceNorm
# launches in one forward at 144^3 (a serving call's 8 windows, a train
# step's batch 1), each at its own shape, as IN_2D: the BasicConvs (affine),
# two a level in the encoder and two in the decoder (level 3: encoder only;
# level 0, packed over (H, W) by get_net's default s2d=None, two on the
# packed-plain (144 * 72^2 * 4, 32) view of the 144^3 rows and its first two
# shifted), and the UpConv pyramid's four (no affine), each on
# the grid it reads before its upsample: deep_conv on the 9^3 token grid,
# up1-up3
IN_FORWARD = (((PATCH ** 3, 32), 2, True), (((PATCH // 2) ** 3, 64), 4, True),
              (((PATCH // 4) ** 3, 128), 4, True), (((PATCH // 8) ** 3, 256), 2, True),
              (((PATCH // 16) ** 3, 256), 1, False), (((PATCH // 8) ** 3, 128), 1, False),
              (((PATCH // 4) ** 3, 64), 1, False), (((PATCH // 2) ** 3, 32), 1, False))
IN_PASSES = ("partial_stats_kernel", "finalize_kernel", "normalize_kernel")
IN_BWD_PASSES = ("bwd_persistent_kernel",)
# (S, C) and count of Hecktor20Top1's InstanceNorms (no affine, no ReLU) in
# one step at 144^3, n_filters 32, level 1 packed: the (8 * 72^3, 32) view of
# block_1_1_left (conv1 and res_conv), block_1_2_left and block_1_{1,2}_right;
# levels 2-4: the first left block's two, two more left and two right; level
# 5's four left; the vision heads' 1x1 norms on the 72^3, 36^3 and 18^3 grids
IN_HECKTOR_TRAIN = (((8 * (PATCH // 2) ** 3, 32), 5), (((PATCH // 2) ** 3, 64), 6),
                    (((PATCH // 4) ** 3, 128), 6), (((PATCH // 8) ** 3, 256), 6),
                    (((PATCH // 16) ** 3, 512), 4), (((PATCH // 2) ** 3, 32), 1),
                    (((PATCH // 4) ** 3, 32), 1), (((PATCH // 8) ** 3, 32), 1))
UNETR_BATCH = 2  # the Hecktor21 preset's batch
# (S, C) and count of UNETR's InstanceNorms (affine, no ReLU) in one forward
# at 144^3: three a UnetResBlock (norm1, norm2 and the residual's norm3),
# encoder1 and decoder2 at 144^3 x 16, decoder3 at 72^3 x 32, decoder4 at
# 36^3 x 64, decoder5 at 18^3 x 128
IN_UNETR = (((PATCH ** 3, 16), 6), (((PATCH // 2) ** 3, 32), 3),
            (((PATCH // 4) ** 3, 64), 3), (((PATCH // 8) ** 3, 128), 3))
# phase 4c, the 2-D path at the PI-CAI22 preset: 3 channels, 384^2 slices,
# bf16, full width, 24 slices a batch (the preset's 2-D batch), transformer
# depth 24: SLICE_CH x DEPTH_2D attentions a forward
SLICE, SLICE_CH, SLICE_BATCH, DEPTH_2D = 384, 3, 24, 24
# (S, C), count and affine of HDenseFormer_2D_32's unshifted InstanceNorms in
# one forward at 384^2: the BasicConvs (affine), two a level in the encoder
# and two in the decoder (level 4: encoder only; level 0, packed at full rank
# by default, two on the packed-plain view of the 384^2 rows and its first
# two shifted), and the UpConv pyramid's four (no affine): deep_conv on the
# 24^2 token grid, up1-up3
IN_2D = (((SLICE ** 2, 32), 2, True), (((SLICE // 2) ** 2, 64), 4, True),
         (((SLICE // 4) ** 2, 128), 4, True), (((SLICE // 8) ** 2, 256), 2, True),
         (((SLICE // 16) ** 2, 256), 1, False), (((SLICE // 8) ** 2, 128), 1, False),
         (((SLICE // 4) ** 2, 64), 1, False), (((SLICE // 2) ** 2, 32), 1, False))
ATTN_2D = (SLICE_BATCH, 8, (SLICE // 16) ** 2, 4)  # one modality path's attention
# phase 1a: the attention backward at the train steps' shapes (2-D, 3-D)
ATTN_BWD_SHAPES = (ATTN_2D, (2, 8, (PATCH // 16) ** 3, 4))
# phase 4p (a): the shifted InstanceNorm at HDenseFormer_32's
# level 0 in serving (8 windows of 144^3, packed over (H, W): 144 x 73 x 73
# shifted cells of 4 x 32 channels; its backward at the train step's batch
# 1) and at HDenseFormer_2D_32's (24 slices of 384^2, full rank: 193 x 193
# cells of 4 x 32; backward at batch 24): (tag, (N, *cells), dims, backward N)
SHIFTED_SHAPES = (("3d", (WINDOWS, PATCH, PATCH // 2 + 1, PATCH // 2 + 1), (1, 2), 1),
                  ("2d", (SLICE_BATCH, SLICE // 2 + 1, SLICE // 2 + 1), (0, 1), SLICE_BATCH))
# The shifted kernels' first design (each row's pad status decoded by a
# division and a modulo per packed dim, pad rows loaded), as
# shifted_kernel_checks measured it on an NVIDIA H100 80GB HBM3 at 700.00 W
# before the redesign: device ms of the shifted kernel and of the unshifted
# kernel on the same bytes in turns (the means of two readings; the forward
# by pass), and the shifted instantiations' (registers a thread, blocks a
# multiprocessor). Printed beside this run's numbers.
SHIFTED_FIRST_DESIGN = {
    "3d": {"forward": dict(ms=1.8069869, unshifted_ms=1.62282465, stats_pass_ms=0.7246064,
                           normalize_pass_ms=1.07481905),
           "backward": dict(ms=0.36439415, unshifted_ms=0.33761995)},
    "2d": {"forward": dict(ms=0.2856617, unshifted_ms=0.2583428, stats_pass_ms=0.1208493,
                           normalize_pass_ms=0.1615169),
           "backward": dict(ms=0.4340381, unshifted_ms=0.40714855)},
    "attributes": {"partial_stats_kernel": (76, 3), "normalize_kernel": (80, 3),
                   "bwd_persistent_kernel": (125, 2)},
}


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAILED: {msg}")


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def cuda_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``iters`` calls, over
    their count: the host's time between launches included."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call: its kernels' durations under torch.profiler.

    Host time between launches is left out, so a kernel shorter than its
    wrapper's Python overhead is timed as the card runs it.
    """
    return sum(device_kernels(fn, iters).values())


def device_kernels(fn, iters: int = 10, tries: int = 3) -> dict:
    """Device ms per call of each kernel name that ``fn`` launches.

    A profile that holds no device event is taken again, up to ``tries``
    times: on the card machine CUPTI now and then delivers none. Each name's
    time is its mean event times its launches a call (its event count over
    ``iters``, rounded), so an event that CUPTI drops does not shorten the
    call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                count[e.name] = count.get(e.name, 0) + 1
        if total:
            return {name: total[name] / count[name] * max(1, round(count[name] / iters))
                    for name in total}
    fail(f"torch.profiler recorded no device time in {tries} profiles")


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(shape, dtype) -> dict:
    """Attention's bound at (B, H, N, D): the larger of bytes (q, k, v read,
    o written), products over the tensor-core peak, and the N^2 exponentials
    a (b, h) over the special-function units (16 ``ex2`` a clock per SM at
    compute capability 9.0, SM_COUNT SMs at the maximum SM clock): at head
    dim 4 the exponentials bound it. ``bound_by`` "operations" for either of
    the last two; ``exp_bound_ms`` says which."""
    b, h, n, d = shape
    itemsize = torch.tensor([], dtype=dtype).element_size()
    t, by = bound(4 * b * h * n * d * itemsize, 4 * b * h * n * n * d, dtype)
    clock = sm_clock_hz()
    t_exp = b * h * n * n / (EX2_PER_CLOCK_SM * SM_COUNT * clock) * 1e3
    rec = dict(bound_ms=t, bound_by=by, exp_bound_ms=t_exp, sm_clock_hz=clock)
    if t_exp > t:
        rec.update(bound_ms=t_exp, bound_by="operations")
    return rec


def max_err(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    """Max abs error, max relative error, and the largest error over its limit."""
    diff = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    rel = diff / ref.float().abs().clamp_min(1e-6)
    return float(diff.max()), float(rel.max()), float((diff / limit).max())


def phase_env(args) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.last_build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, seed=args.seed,
         kernel_build_s=round(build_s, 3), ptxas=ptxas)
    return smi


MHA_SHAPE = (2, 8, 5832, 64)  # TransBTS at Hecktor21: batch 2, 8 heads of 64, 18^3 tokens
MHA_P = 0.1


def mha_bound(shape, backward: bool) -> dict:
    """The fused attention's bound: products (forward QK^T and PV; backward
    QK^T, dO V^T, P^T dO, dS K, dS^T Q, the split of dS counted once) over
    the bf16 peak, the N^2 exponentials a (b, h) over the special-function
    units, the keep mask's bytes over HBM; the largest, and which."""
    b, h, n, d = shape
    flops = (10 if backward else 4) * b * h * n * n * d
    times = {"operations": flops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3,
             "exponentials": b * h * n * n / (EX2_PER_CLOCK_SM * SM_COUNT * sm_clock_hz()) * 1e3,
             "bytes": b * h * n * n / HBM_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return dict(bound_ms=times[by], bound_by=by, **{f"{k}_ms": v for k, v in times.items()})


def phase_mha(gen) -> dict:
    """Phase 1m: the fused attention against the plain math at MHA_SHAPE."""
    b, h, n, d = MHA_SHAPE
    dev = torch.device("cuda")
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn((b, n, h * d), generator=gen, device=dev).to(torch.bfloat16)
    keep = dropout_keep((b, h, n, n), MHA_P, dev, gen)

    def fwd_bwd(fn):
        x = qkv.detach().requires_grad_()
        out = fn(x)
        return (out.detach(),) + torch.autograd.grad(out, x, dout)

    kernel = lambda x: mha(x, h, keep, MHA_P)  # noqa: E731
    plain = lambda x: mha_ref(x, h, keep, MHA_P)  # noqa: E731
    got, again, ref = fwd_bwd(kernel), fwd_bwd(kernel), fwd_bwd(plain)
    torch.cuda.synchronize()
    rec = dict(shape=list(MHA_SHAPE), dtype="bfloat16", p=MHA_P,
               bitwise_rerun=all(bool(torch.equal(u, v)) for u, v in zip(got, again)))
    parts = {"o": (got[0], ref[0])}
    for j, name in enumerate(("dq", "dk", "dv")):
        parts[name] = (got[1].view(b, n, 3, -1)[:, :, j], ref[1].view(b, n, 3, -1)[:, :, j])
    rec["vs_plain"] = {name: float((u.float() - v.float()).abs().max() / v.float().abs().max())
                       for name, (u, v) in parts.items()}
    if not rec["bitwise_rerun"]:
        fail("mha: reruns differ")
    # a guard against gross faults; the precision bar is tests/test_torch_cuda.py's (each
    # output's error against float64 within twice the plain math's)
    if not all(np.isfinite(list(rec["vs_plain"].values()))) or max(rec["vs_plain"].values()) > 0.05:
        fail(f"mha against the plain math: {rec['vs_plain']}")
    del again, ref

    x = qkv.detach().requires_grad_()
    out = kernel(x)
    fwd = device_kernels(lambda: kernel(x), iters=10)
    bwd = device_kernels(lambda: torch.autograd.grad(out, x, dout, retain_graph=True), iters=10)
    rec["kernels_ms"] = {k: v for k, v in {**fwd, **bwd}.items() if "mha64" in k}
    rec["fwd_ms"] = sum(v for k, v in fwd.items() if "mha64" in k)
    rec["bwd_ms"] = sum(v for k, v in bwd.items() if "mha64" in k)
    rec["ms"] = rec["fwd_ms"] + rec["bwd_ms"]
    rec["fwd_bound"] = mha_bound(MHA_SHAPE, False)
    rec["bwd_bound"] = mha_bound(MHA_SHAPE, True)
    rec["bound_ms"] = rec["fwd_bound"]["bound_ms"] + rec["bwd_bound"]["bound_ms"]
    rec["pct_of_bound"] = 100 * rec["bound_ms"] / rec["ms"]
    del out, x
    rec["mask_draw_ms"] = device_ms(lambda: dropout_keep((b, h, n, n), MHA_P, dev, gen), iters=5)
    rec["plain_ms"] = device_ms(lambda: fwd_bwd(plain), iters=3)
    views = [t.view(b, n, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
    grad_o = dout.view(b, n, h, d).transpose(1, 2)

    def library():
        xs = [v.detach().requires_grad_() for v in views]
        o = F.scaled_dot_product_attention(*xs, dropout_p=MHA_P)
        return torch.autograd.grad(o, xs, grad_o)

    rec["library_ms"] = device_ms(library, iters=5)
    emit("kernel_check", kernel="mha64", **rec)
    del qkv, dout, keep, got
    torch.cuda.empty_cache()
    return {key: rec[key] for key in ("ms", "fwd_ms", "bwd_ms", "plain_ms", "library_ms",
                                      "bound_ms", "pct_of_bound", "mask_draw_ms")}


def attention_grads(fn, q, k, v, dout) -> tuple:
    """dQ, dK, dV of ``fn`` at (q, k, v) against ``dout``."""
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(fn(*xs), xs, dout)


def attention_grad_errors(q, k, v, dout, grads) -> dict:
    """Each of dQ, dK, dV against float64 math: (largest error over the
    largest exact value, mean error over the mean exact value)."""
    scale = q.shape[-1] ** -0.5
    exact = attention_grads(
        lambda q, k, v: torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v,
        *(t.double() for t in (q, k, v, dout)))
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, exact):
        diff = (got.double() - ref).abs()
        errs[name] = (float(diff.max() / ref.abs().max()), float(diff.mean() / ref.abs().mean()))
    return errs


def phase_attention_backward(gen) -> dict:
    """Phase 1a: the attention backward kernels at ATTN_BWD_SHAPES, bf16."""
    dev = torch.device("cuda")
    out = {}
    for shape in ATTN_BWD_SHAPES:
        b, h, n, d = shape
        # q, k, v as the model gives them: head views of one qkv projection
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t.view(b, n, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1))
        dout = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        dense_attention.backward_launches = 0
        got = attention_grads(dense_attention, q, k, v, dout)
        again = attention_grads(dense_attention, q, k, v, dout)
        torch.cuda.synchronize()
        rec = dict(shape=list(shape), dtype="bfloat16",
                   backward_launches=dense_attention.backward_launches,
                   bitwise_rerun=all(bool(torch.equal(u, w)) for u, w in zip(got, again)))
        plain = attention_grads(attention_ref, q, k, v, dout)
        rec["err_vs_f64"] = attention_grad_errors(q, k, v, dout, got)
        rec["plain_err_vs_f64"] = attention_grad_errors(q, k, v, dout, plain)
        del again, plain
        if rec["backward_launches"] != 2 or not rec["bitwise_rerun"]:
            fail(f"dense_attention backward {shape}: {rec['backward_launches']} launches for "
                 f"2 backwards, or reruns differ")
        # tests/test_torch_cuda.py's bar: each gradient within twice the plain math's error
        for name, (top, mean) in rec["err_vs_f64"].items():
            plain_top, plain_mean = rec["plain_err_vs_f64"][name]
            if not (np.isfinite([top, mean]).all() and top <= 2 * plain_top
                    and mean <= 2 * plain_mean):
                fail(f"dense_attention backward {shape} {name} against float64: "
                     f"{rec['err_vs_f64']}, the plain math's {rec['plain_err_vs_f64']}")
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        o = dense_attention(*xs)
        kernels = device_kernels(lambda: torch.autograd.grad(o, xs, dout, retain_graph=True),
                                 iters=50)
        rec["kernels_ms"] = {name: t for name, t in kernels.items() if "dense_attention" in name}
        rec["ms"] = sum(rec["kernels_ms"].values())

        def plain_backward():  # the autograd function's backward before the kernels
            with torch.enable_grad():
                ys = [t.detach().requires_grad_() for t in (q, k, v)]
                return torch.autograd.grad(attention_ref(*ys), ys, dout)

        rec["plain_ms"] = device_ms(plain_backward, iters=10)
        lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
        rec["library_ms"] = device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*lib_in), lib_in, dout), iters=20)
        nbytes = b * h * n * (4 * d * 2 + d * 4 + 4 + 3 * d * 2)  # q k v dO, O, lse; dq dk dv
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_exp = b * h * n * n / (EX2_PER_CLOCK_SM * SM_COUNT * sm_clock_hz()) * 1e3
        rec.update(bound_ms=max(t_bytes, t_exp), bound_by="bytes" if t_bytes > t_exp
                   else "exponentials", bytes_bound_ms=t_bytes, exp_bound_ms=t_exp)
        rec["pct_of_bound"] = 100 * rec["bound_ms"] / rec["ms"]
        rec["plan"] = dataclasses.asdict(attention_bwd_plan(b, h, n, d))
        emit("kernel_check", kernel="dense_attention_backward", **rec)
        out[f"{b}x{h}x{n}x{d}"] = {key: rec[key] for key in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "pct_of_bound")}
        del qkv, q, k, v, dout, got, xs, o, lib_in
        torch.cuda.empty_cache()
    return out


def instance_norm_times(x, scale, bias, library: bool = True, relu: bool = True) -> dict:
    """Device times of the kernel (by pass), its plain version and, with
    ``library``, ``F.relu(F.instance_norm(...))``; the bound. Each pass's
    rate counts the bytes it must move: x for the statistics, x and y for
    the normalize."""
    c = x.shape[-1]
    affine = scale is not None
    # ~7 fp32 operations per element: shifted sums 3, normalize+affine+ReLU 4
    nbytes = 2 * x.numel() * x.element_size() + (2 * c * 4 if affine else 0)
    rec = dict(zip(("bound_ms", "bound_by"), bound(nbytes, 7 * x.numel(), torch.float32)))
    iters = 10 if x.numel() > 1e8 else 50
    by_kernel = device_kernels(lambda: instance_norm_relu(x, scale, bias, relu=relu), iters)
    passes = {p: sum(t for name, t in by_kernel.items() if p in name) for p in IN_PASSES}
    if any(t == 0 for t in passes.values()):
        fail(f"instance_norm_relu: the profiler saw {sorted(by_kernel)}, not its three passes")
    xbytes = x.numel() * x.element_size()
    rec["ms"] = sum(by_kernel.values())
    rec["passes_ms"] = passes
    rec["passes_tb_per_s"] = {"partial_stats_kernel": xbytes / passes["partial_stats_kernel"] / 1e9,
                              "normalize_kernel": 2 * xbytes / passes["normalize_kernel"] / 1e9}
    rec["plain_ms"] = device_ms(lambda: instance_norm_relu_ref(x, scale, bias, relu=relu),
                                iters)
    if library:
        # the library call on the same channels-last tensor, viewed as (N, C, S)
        rec["library_ms"] = device_ms(
            lambda: F.relu(F.instance_norm(x.transpose(1, 2), weight=scale, bias=bias, eps=1e-5)),
            iters)
    return rec


def phase_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version; returns the main-shape numbers."""
    dev = torch.device("cuda")
    main = {}

    # --- dense attention -------------------------------------------------
    # Tolerances: fp32, summation order and exp2: 1e-5 + 1e-4 |ref|. bf16
    # against the fp32 math on the same inputs: one output rounding,
    # 1e-5 + 2^-8 |ref|. bf16 against the plain bf16 version, which also
    # rounds the probabilities to bf16 before the second product (the kernel
    # carries them as two bf16 parts, to 2^-16): that rounding moves an
    # output by up to 2^-9 * max|v| ~ 1e-2, so 2e-2 + 2^-8 |ref|.
    for shape, dtype in (((8, 8, 729, 4), torch.bfloat16), ((8, 8, 729, 4), torch.float32),
                         ((1, 2, 130, 4), torch.float32)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        got = dense_attention(q, k, v)
        plain = attention_ref(q, k, v)
        math32 = attention_ref(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        if dtype == torch.float32:
            checks = {"plain": (plain, 1e-4, 1e-5)}
        else:
            checks = {"plain": (plain, 2.0 ** -8, 2e-2), "fp32_math": (math32, 2.0 ** -8, 1e-5)}
        rec = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""))
        for ref_name, (ref, rtol, atol) in checks.items():
            abs_e, rel_e, over = max_err(got, ref, rtol, atol)
            rec[f"vs_{ref_name}"] = dict(max_abs=abs_e, max_rel=rel_e, rtol=rtol, atol=atol)
            if not over <= 1.0:
                fail(f"dense_attention {shape} {dtype} vs {ref_name}: {abs_e} over tolerance")
        b, h, n, d = shape
        rec.update(attention_bound(shape, dtype))
        rec["ms"] = device_ms(lambda: dense_attention(q, k, v), iters=50)
        rec["event_ms"] = cuda_ms(lambda: dense_attention(q, k, v), iters=50)  # with the host
        rec["plain_ms"] = device_ms(lambda: attention_ref(q, k, v), iters=20)
        rec["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
        rec["bitwise_rerun"] = bool(torch.equal(got, dense_attention(q, k, v)))
        if not rec["bitwise_rerun"]:
            fail(f"dense_attention {shape} {dtype}: reruns differ")
        if shape == (8, 8, 729, 4) and dtype == torch.bfloat16:
            # the serving layout: the head views of one qkv projection
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(dtype)
            views = [t.view(b, n, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
            rec["ms_qkv_split"] = device_ms(lambda: dense_attention(*views), iters=50)
            # peaked scores (q and k x 8, scores ~64x wider): the bf16 sweep's
            # running max moves up, and rescales, in most warps
            qp, kp = (q.float() * 8).to(dtype), (k.float() * 8).to(dtype)
            abs_e, _, over = max_err(dense_attention(qp, kp, v),
                                     attention_ref(qp.float(), kp.float(), v.float()), 2.0 ** -8,
                                     1e-5)
            if not over <= 1.0:
                fail(f"dense_attention {shape} peaked vs fp32_math: {abs_e} over tolerance")
            rec["peaked"] = dict(max_abs_vs_fp32_math=abs_e,
                                 ms=device_ms(lambda: dense_attention(qp, kp, v), iters=50))
            blocks = _build.load_library().hdf_dense_attention_blocks_per_sm(1, d, n)
            plan = attention_plan(b, h, n, d, q.element_size())
            rec["occupancy"] = dict(blocks_per_sm=blocks, warps_per_sm=blocks * plan.threads // 32,
                                    grid=list(plan.grid), threads=plan.threads)
        emit("kernel_check", kernel="dense_attention", **rec)
        if shape == (8, 8, 729, 4) and dtype == torch.bfloat16:
            main["dense_attention"] = dict(max_abs_err=rec["vs_plain"]["max_abs"], **{
                key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                          "exp_bound_ms")})
        del q, k, v, got, plain, math32

    # --- InstanceNorm + ReLU ---------------------------------------------
    # Tolerances: fp32, summation order: 1e-5 + 1e-5 |ref|. bf16: the kernel
    # and the plain version round the same fp32 value unless their statistics
    # (summed in different orders) put it across a rounding boundary, so at
    # most one bf16 step apart: 1e-6 + 2^-7 |ref|. The "far" case, 1000 +
    # N(0, 1) in fp32, guards the centred statistics: the plain version runs
    # on x - 1000 (exact here; the norm does not change under a shift), since
    # on x its own fp32 mean near 1000 is only good to a 6e-5 step.
    for (n, s, c), dtype, affine, far in (
        ((WINDOWS, PATCH ** 3, 32), torch.bfloat16, True, False),  # the largest serving call
        ((2, 1000, 32), torch.float32, True, False),
        ((2, 1000, 32), torch.float32, False, False),
        ((1, 300, 16), torch.float32, True, False),
        ((2, 4096, 32), torch.float32, True, True),
    ):
        x = (torch.randn((n, s, c), generator=gen, device=dev) * (1 if far else 3)
             + (1000 if far else 1)).to(dtype)
        scale = torch.rand(c, generator=gen, device=dev) if affine else None
        bias = torch.randn(c, generator=gen, device=dev) if affine else None
        got = instance_norm_relu(x, scale, bias)
        again = instance_norm_relu(x, scale, bias)
        plain = instance_norm_relu_ref(x - 1000 if far else x, scale, bias)
        torch.cuda.synchronize()
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_STEP, 1e-6)
        abs_e, rel_e, over = max_err(got, plain, rtol, atol)
        rec = dict(shape=[n, s, c], dtype=str(dtype).replace("torch.", ""), affine=affine,
                   mean=1000 if far else 1,
                   vs_plain=dict(max_abs=abs_e, max_rel=rel_e, rtol=rtol, atol=atol),
                   bitwise_rerun=bool(torch.equal(got, again)))
        if not over <= 1.0:
            fail(f"instance_norm_relu {(n, s, c)} {dtype} mean {rec['mean']}: {abs_e} over "
                 "tolerance")
        if not rec["bitwise_rerun"]:
            fail(f"instance_norm_relu {(n, s, c)} {dtype}: reruns differ")
        rec.update(instance_norm_times(x, scale, bias))
        emit("kernel_check", kernel="instance_norm_relu", **rec)
        if "instance_norm_relu" not in main:
            main["instance_norm_relu"] = dict(max_abs_err=abs_e, **{
                key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        del x, got, again, plain
        torch.cuda.empty_cache()

    # the serving forward's InstanceNorm launches, timed shape by shape
    per_forward = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for (s, c), count, affine in IN_FORWARD:
        x = (torch.randn((WINDOWS, s, c), generator=gen, device=dev) * 3 + 1).to(torch.bfloat16)
        scale, bias = (torch.rand(c, generator=gen, device=dev),
                       torch.randn(c, generator=gen, device=dev)) if affine else (None, None)
        rec = dict(shape=[WINDOWS, s, c], dtype="bfloat16", affine=affine,
                   launches_per_serving_forward=count,
                   **instance_norm_times(x, scale, bias, library=False))
        emit("instance_norm_serving_shape", **rec)
        for key in per_forward:
            per_forward[key] += rec[key] * count
        del x
        torch.cuda.empty_cache()
    launches = sum(count for _, count, _ in IN_FORWARD)
    emit("instance_norm_per_serving_forward", launches=launches,
         **{f"per_forward_{k}": v for k, v in per_forward.items()})
    main["instance_norm_relu"].update({f"per_forward_{k}": v for k, v in per_forward.items()})

    # --- s2d half-shift, forward and backward ----------------------------
    # A pure copy: the kernel must equal the plain version bit for bit. The
    # serving forward runs it at SHIFT_FC; no single PyTorch call computes
    # it (library_ms null). Bound: read the input once, write the output once.
    g = PATCH // 2
    per_forward = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for fc in sorted(set(SHIFT_FC)):
        x = torch.randn((WINDOWS, g, g, g, fc), generator=gen, device=dev).to(torch.bfloat16)
        got = shift_pack(x)
        plain = shift_pack_ref(x)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            fail(f"shift_pack {tuple(x.shape)}: differs from the plain version")
        nbytes = (x.numel() + got.numel()) * x.element_size()
        rec = dict(shape=list(x.shape), dtype="bfloat16", bitwise_equal=True,
                   launches_per_serving_forward=SHIFT_FC.count(fc))
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 0, torch.bfloat16)
        rec["ms"] = device_ms(lambda: shift_pack(x), iters=10)
        rec["plain_ms"] = device_ms(lambda: shift_pack_ref(x), iters=5)
        rec["library_ms"] = None
        emit("kernel_check", kernel="shift_pack", **rec)
        for key in per_forward:
            per_forward[key] += rec[key] * SHIFT_FC.count(fc)
        if fc == max(SHIFT_FC):
            main["shift_pack"] = dict(max_abs_err=0.0, **{
                key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        del x, got, plain
        torch.cuda.empty_cache()
    emit("shift_pack_per_serving_forward", launches=len(SHIFT_FC), **per_forward)
    main["shift_pack"].update({f"per_forward_{k}": v for k, v in per_forward.items()})

    dy = torch.randn((WINDOWS, g + 1, g + 1, g + 1, max(SHIFT_FC)), generator=gen,
                     device=dev).to(torch.bfloat16)
    got = shift_unpack(dy)
    plain = shift_unpack_ref(dy)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        fail(f"shift_unpack {tuple(dy.shape)}: differs from the plain version")
    rec = dict(shape=list(dy.shape), dtype="bfloat16", bitwise_equal=True)
    rec["bound_ms"], rec["bound_by"] = bound((dy.numel() + got.numel()) * 2, 0, torch.bfloat16)
    rec["ms"] = device_ms(lambda: shift_unpack(dy), iters=10)
    rec["plain_ms"] = device_ms(lambda: shift_unpack_ref(dy), iters=5)
    rec["library_ms"] = None
    emit("kernel_check", kernel="shift_pack_backward", **rec)
    main["shift_pack_backward"] = dict(max_abs_err=0.0, **{
        key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    del dy, got, plain
    torch.cuda.empty_cache()
    return main


def norm_bwd_inputs(gen, shape, dtype, affine, mean=1.0, spread=3.0):
    """x, dy, scale and bias of one InstanceNorm backward case: scale of both
    signs with one zero (every branch of the ReLU mask)."""
    dev = torch.device("cuda")
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * spread + mean).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = bias = None
    if affine:
        scale = torch.randn(c, generator=gen, device=dev)
        scale[0] = 0.0
        bias = torch.randn(c, generator=gen, device=dev)
    return x, dy, scale, bias


def norm_bwd_check(got, ref, dtype) -> dict:
    """The backward's bars: dx per (n, c) within 1e-4 of max|dx_ref| (fp32),
    or two bf16 steps of |dx_ref| plus 1e-3 of max|dx_ref| (bf16: summation
    order, then one rounding on each side); dscale and dbias within 1e-4 of
    the tensor's max|ref|. "over" is the largest error over its bar."""
    dx, dscale, dbias = got
    dx_ref, dscale_ref, dbias_ref = ref
    n, c = dx.shape[0], dx.shape[-1]
    d = (dx.float() - dx_ref.float()).reshape(n, -1, c).abs()
    r = dx_ref.float().reshape(n, -1, c).abs()
    peak = r.amax(1, keepdim=True)
    bar = 1e-4 * peak if dtype == torch.float32 else 2 * BF16_STEP * r + 1e-3 * peak
    rec = dict(dx_max_abs=float(d.max()), dx_scale=float(peak.max()),
               over=float((d / bar.clamp_min(1e-30)).max()))
    for name, a, b in (("dscale", dscale, dscale_ref), ("dbias", dbias, dbias_ref)):
        if (a is None) != (b is None):
            fail(f"instance_norm_relu_bwd: {name} is {a} against {b}")
        if a is not None:
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            rec[f"{name}_max_rel"] = rel
            rec["over"] = max(rec["over"], rel / 1e-4)
    return rec


def norm_backward_times(x, dy, scale, bias, relu, library: bool = True) -> dict:
    """Device times of the backward kernel (the wrapper's whole call, one
    launch, dscale and dbias included), its plain version and, with
    ``library``, torch.autograd.grad through F.relu(F.instance_norm(...)).
    The bound moves each byte once: read x and dy, write dx."""
    _, stats = instance_norm_relu_fwd(x, scale, bias, relu=relu)
    n, es = x.numel(), x.element_size()
    # ~14 fp32 operations an element: mask, select and 2 sums in the reduce,
    # mask, select, centring and 2 fmas for dx
    rec = dict(zip(("bound_ms", "bound_by"), bound(3 * n * es, 14 * n, torch.float32)))
    plan = norm_bwd_plan(x, dy)
    rec["plan"] = dict(grid=plan.grid, vec_bytes=plan.vec_bytes, channel_tile=plan.channel_tile,
                       tiles=plan.tiles, parts=plan.parts)
    iters = 10 if n > 2e8 else 50
    by_kernel = device_kernels(lambda: instance_norm_relu_bwd(dy, x, stats, scale, bias, relu),
                               iters)
    passes = {p: sum(t for name, t in by_kernel.items() if p in name) for p in IN_BWD_PASSES}
    if any(t == 0 for t in passes.values()):
        fail(f"instance_norm_relu_bwd: the profiler saw {sorted(by_kernel)}, not its kernel")
    rec["ms"] = sum(by_kernel.values())
    rec["kernel_ms"] = passes
    rec["tb_per_s"] = 3 * n * es / passes[IN_BWD_PASSES[0]] / 1e9  # the function's bytes
    mean, inv = absolute_stats(x, stats)
    rec["plain_ms"] = device_ms(
        lambda: instance_norm_relu_bwd_ref(dy, x, mean, inv, scale, bias, relu), iters)
    if library:
        # the library's backward on the same channels-last tensor, viewed as (N, C, S)
        leaves = [x.detach().transpose(1, 2).requires_grad_()]
        if scale is not None:
            leaves += [scale.clone().requires_grad_(), bias.clone().requires_grad_()]
        weight, b = (None, None) if scale is None else leaves[1:]
        y = F.instance_norm(leaves[0], weight=weight, bias=b, eps=1e-5)
        y = F.relu(y) if relu else y
        g = dy.transpose(1, 2)
        rec["library_ms"] = device_ms(
            lambda: torch.autograd.grad(y, leaves, g, retain_graph=True), iters)
    return rec


def norm_bwd_compare(x, dy, scale, bias, relu, what: str) -> dict:
    """The backward kernel against its plain version given the forward
    kernel's statistics (so both draw the same ReLU mask), and a rerun that
    must be bitwise equal; fails over the bars."""
    _, stats = instance_norm_relu_fwd(x, scale, bias, relu=relu)
    got = instance_norm_relu_bwd(dy, x, stats, scale, bias, relu)
    again = instance_norm_relu_bwd(dy, x, stats, scale, bias, relu)
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, relu)
    torch.cuda.synchronize()
    vs_plain = norm_bwd_check(got, ref, x.dtype)
    if not vs_plain["over"] <= 1.0:
        fail(f"instance_norm_relu_bwd {what}: {vs_plain}")
    if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"instance_norm_relu_bwd {what}: reruns differ")
    return vs_plain


def phase_norm_backward(gen) -> dict:
    """The InstanceNorm backward kernel against its plain version, timed;
    then summed over a HDenseFormer_32 train step's 18 InstanceNorm shapes
    at batch 1, and over a Hecktor20Top1 train step's 30 at batch 2."""
    main = None
    for shape, dtype, affine, relu, mean in (
        ((1, PATCH ** 3, 32), torch.bfloat16, True, True, 1.0),  # the train step's largest
        ((1, PATCH ** 3, 32), torch.float32, True, True, 1.0),
        ((3, 4099, 2), torch.bfloat16, False, True, 1.0),  # ragged S: no chunk divides it
        ((3, 4099, 32), torch.float32, True, False, 1.0),
        ((3, 4099, 256), torch.bfloat16, True, True, 1.0),
        ((3, 4099, 32), torch.bfloat16, False, False, 1.0),
        ((2, 4096, 32), torch.float32, True, True, 1000.0),  # the precision guard
    ):
        x, dy, scale, bias = norm_bwd_inputs(gen, shape, dtype, affine, mean,
                                             1.0 if mean > 1 else 3.0)
        what = f"{shape} {dtype} affine {affine} relu {relu} mean {mean}"
        rec = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""), affine=affine,
                   relu=relu, mean=mean, bitwise_rerun=True,
                   vs_plain=norm_bwd_compare(x, dy, scale, bias, relu, what))
        if shape[1] == PATCH ** 3:
            rec.update(norm_backward_times(x, dy, scale, bias, relu))
        emit("kernel_check", kernel="instance_norm_relu_backward", **rec)
        if main is None:
            main = dict(max_abs_err=rec["vs_plain"]["dx_max_abs"], **{
                key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        del x, dy
        torch.cuda.empty_cache()

    # a train step's InstanceNorms (batch 1, bf16), forward and backward, each
    # shape's backward held against its plain version (the launch plan moves with C)
    per_step = dict(fwd_ms=0.0, fwd_bound_ms=0.0, bwd_ms=0.0, bwd_plain_ms=0.0, bwd_bound_ms=0.0)
    for (s, c), count, affine in IN_FORWARD:
        x, dy, scale, bias = norm_bwd_inputs(gen, (1, s, c), torch.bfloat16, affine)
        vs_plain = norm_bwd_compare(x, dy, scale, bias, True, f"(1, {s}, {c}) bfloat16")
        fwd = instance_norm_times(x, scale, bias, library=False)
        bwd = norm_backward_times(x, dy, scale, bias, True, library=False)
        emit("instance_norm_train_shape", shape=[1, s, c], dtype="bfloat16", affine=affine,
             launches_per_train_step=count, vs_plain=vs_plain, bitwise_rerun=True,
             fwd_ms=fwd["ms"], fwd_bound_ms=fwd["bound_ms"], bwd_ms=bwd["ms"],
             bwd_plain_ms=bwd["plain_ms"], bwd_bound_ms=bwd["bound_ms"], plan=bwd["plan"])
        for key, val in (("fwd_ms", fwd["ms"]), ("fwd_bound_ms", fwd["bound_ms"]),
                         ("bwd_ms", bwd["ms"]), ("bwd_plain_ms", bwd["plain_ms"]),
                         ("bwd_bound_ms", bwd["bound_ms"])):
            per_step[key] += val * count
        del x, dy
        torch.cuda.empty_cache()
    emit("instance_norm_per_train_step", launches=sum(count for _, count, _ in IN_FORWARD),
         **per_step)

    # a Hecktor20Top1 train step's backward InstanceNorms (batch 2, bf16, no
    # affine, no ReLU: FastSmoothSENorm's norm)
    per_step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for (s, c), count in IN_HECKTOR_TRAIN:
        x, dy, scale, bias = norm_bwd_inputs(gen, (2, s, c), torch.bfloat16, False)
        vs_plain = norm_bwd_compare(x, dy, None, None, False, f"(2, {s}, {c}) bfloat16")
        bwd = norm_backward_times(x, dy, None, None, False, library=False)
        emit("instance_norm_hecktor_train_shape", shape=[2, s, c], dtype="bfloat16",
             launches_per_train_step=count, vs_plain=vs_plain, bitwise_rerun=True,
             **{k: bwd[k] for k in ("ms", "plain_ms", "bound_ms", "plan")})
        for key in per_step:
            per_step[key] += bwd[key] * count
        del x, dy
        torch.cuda.empty_cache()
    emit("instance_norm_per_hecktor_train_step",
         launches=sum(count for _, count in IN_HECKTOR_TRAIN), **per_step)
    return main


def phase_shift_grad(gen) -> None:
    """The backward kernel's path: d/dx sum(conv3_packed(x, w)^2) via autograd.

    fp32 with TF32 off, at (2, 20^3, 256) (C = 32, a 40^3 fine grid). Both
    paths run the same cuDNN convolutions on bitwise-equal operands (the
    shift is a copy), but cuDNN may pick another algorithm, and so another
    summation order, for each call: 1e-5 of the gradient's scale.
    """
    dev = torch.device("cuda")
    x = torch.randn((2, 20, 20, 20, 256), generator=gen, device=dev)
    w = torch.randn((32, 32, 3, 3, 3), generator=gen, device=dev) * 0.05
    grads = {}
    for use in (True, False):
        xr = x.clone().requires_grad_()
        reset_counts()
        conv3_packed(xr, w, use_kernels=use).square().sum().backward()
        torch.cuda.synchronize()
        grads[use] = (xr.grad, read_counts())
    (got, counts), (ref, plain_counts) = grads[True], grads[False]
    expect = dict(dict.fromkeys(KERNELS, 0), shift_pack=1, shift_pack_backward=1)
    if counts != expect or any(plain_counts.values()):
        fail(f"autograd path launched {counts} (plain path {plain_counts}), expected {expect}")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    emit("shift_grad", shape=list(x.shape), launches=counts, max_abs_err=err, scale=scale,
         atol=1e-5 * scale)
    if not (torch.isfinite(got).all() and err <= 1e-5 * scale):
        fail(f"conv3_packed gradient through the kernels: {err} over {1e-5 * scale}")


def shifted_inputs(gen, n, cells, dims, c=32, dtype=torch.bfloat16):
    """A packed-shifted x of (n, *cells, 2^|dims| c) as a p2s conv writes it:
    N(1, 3^2) at the valid slots, garbage (N(0, 100^2)) at the pad slots; dy
    (large at the pads too), and scale of both signs with one zero, bias."""
    dev = torch.device("cuda")
    shape = (n, *cells, 2 ** len(dims) * c)
    x = torch.randn(shape, generator=gen, device=dev) * 3 + 1
    garbage = 100 * torch.randn(shape, generator=gen, device=dev)
    valid = apply_shifted_mask(torch.ones(shape[1:], device=dev)[None], dims) > 0
    x = torch.where(valid, x, garbage).to(dtype)
    dy = torch.where(valid, torch.randn(shape, generator=gen, device=dev),
                     1e3 * torch.ones((), device=dev)).to(dtype)
    scale = torch.randn(c, generator=gen, device=dev)
    scale[0] = 0.0
    return x, dy, scale, torch.randn(c, generator=gen, device=dev)


def pass_times(fn, passes, iters: int) -> dict:
    """Device ms a call of each of ``passes`` (kernel-name substrings) that
    ``fn`` launches."""
    by_kernel = device_kernels(fn, iters)
    return {p: sum(t for name, t in by_kernel.items() if p in name) for p in passes}


def in_turns(fns: dict, passes, iters: int) -> dict:
    """``pass_times`` of each of ``fns`` (two), in turns a, b, b, a, a, b: per
    name the three readings' ms, and the median reading's ms and passes (a
    reading now and then runs slow, for both kernels alike, and one profile
    of the shifted forward once read 0.48x the other, under its byte
    bound)."""
    a, b = fns
    readings = {a: [], b: []}
    for name in (a, b, b, a, a, b):
        readings[name].append(pass_times(fns[name], passes, iters))
    out = {}
    for name, rs in readings.items():
        best = sorted(rs, key=lambda r: sum(r.values()))[1]
        out[name] = dict(ms=sum(best.values()), readings_ms=[sum(r.values()) for r in rs],
                         passes_ms=best)
    return out


def shifted_kernel_checks(gen) -> dict:
    """Phase 4p (a): the shifted InstanceNorm forward and backward kernels against
    their plain versions at SHIFTED_SHAPES (bf16, affine, ReLU): phase 1's
    forward bar and phase 1b's backward bars (given the same statistics),
    exact zeros at every pad slot, reruns bitwise; device times beside the
    plain versions' and the bound (bytes the function needs, each once:
    forward the valid rows of x read and all of y written, backward the
    valid rows of x and dy read and all of dx written). The shifted mode's
    own cost: each kernel timed in turns with the unshifted kernel on the
    same tensor viewed as (N, rows, C) (the same bytes), by pass, beside
    both instantiations' registers and blocks per multiprocessor (the
    shifted ones must hold as many blocks) and the first design's numbers.
    No single PyTorch call computes the masked norm (library_ms null)."""
    main = {}
    attrs = {mode: kernel_attributes(torch.bfloat16, 16, shifted=mode == "shifted")
             for mode in ("shifted", "unshifted")}
    emit("shifted_kernel_attributes", **attrs,
         first_design_shifted=SHIFTED_FIRST_DESIGN["attributes"])
    if any(attrs["shifted"][k]["blocks_per_sm"] < attrs["unshifted"][k]["blocks_per_sm"]
           for k in attrs["shifted"]):
        fail(f"the shifted kernels hold fewer blocks a multiprocessor: {attrs}")
    for tag, (n, *cells), dims, bwd_n in SHIFTED_SHAPES:
        x, dy, scale, bias = shifted_inputs(gen, n, cells, dims)
        c = scale.numel()
        y, stats = instance_norm_relu_fwd(x, scale, bias, shifted=dims)
        again, _ = instance_norm_relu_fwd(x, scale, bias, shifted=dims)
        plain = instance_norm_relu_ref(x, scale, bias, shifted=dims)
        torch.cuda.synchronize()
        abs_e, rel_e, over = max_err(y, plain, BF16_STEP, 1e-6)
        pads_zero = bool(torch.equal(apply_shifted_mask(y, dims), y))
        if not over <= 1.0 or not pads_zero or not torch.equal(y, again):
            fail(f"instance_norm_relu_shifted {tuple(x.shape)} {dims}: error {abs_e} "
                 f"({over} of the bar), pads zero {pads_zero}, rerun equal "
                 f"{torch.equal(y, again)}")
        numel, valid = x.numel(), shift_of(x, dims).m
        fwd = dict(shape=list(x.shape), dims=list(dims), dtype="bfloat16", affine=True,
                   relu=True, rows_per_sample=numel // (n * c), valid_rows_per_sample=valid,
                   vs_plain=dict(max_abs=abs_e, max_rel=rel_e, rtol=BF16_STEP, atol=1e-6),
                   pads_zero=pads_zero, bitwise_rerun=True)
        fwd["bound_ms"], fwd["bound_by"] = bound(
            (n * valid * c + numel) * 2 + 2 * c * 4, 7 * numel, torch.float32)
        xv = x.view(n, -1, c)  # the same bytes, unshifted
        turns = in_turns({"shifted": lambda: instance_norm_relu_fwd(x, scale, bias, shifted=dims),
                          "unshifted": lambda: instance_norm_relu_fwd(xv, scale, bias)},
                         IN_PASSES, 10 if numel > 1e8 else 50)
        fwd["ms"] = turns["shifted"]["ms"]
        fwd["mode_cost"] = dict(turns, shifted_over_unshifted=fwd["ms"] / turns["unshifted"]["ms"],
                                first_design=SHIFTED_FIRST_DESIGN[tag]["forward"])
        fwd["plain_ms"] = device_ms(lambda: instance_norm_relu_ref(x, scale, bias, shifted=dims),
                                    iters=3)
        fwd["library_ms"] = None
        emit("kernel_check", kernel="instance_norm_relu_shifted", path=tag, **fwd)
        del y, again, plain, xv
        xb, dyb = x[:bwd_n].contiguous(), dy[:bwd_n].contiguous()
        del x, dy
        torch.cuda.empty_cache()
        _, stb = instance_norm_relu_fwd(xb, scale, bias, shifted=dims)
        got = instance_norm_relu_bwd(dyb, xb, stb, scale, bias, True, shifted=dims)
        twice = instance_norm_relu_bwd(dyb, xb, stb, scale, bias, True, shifted=dims)
        mean, inv = absolute_stats(xb, stb, dims)
        ref = instance_norm_relu_bwd_ref(dyb, xb, mean, inv, scale, bias, True, shifted=dims)
        torch.cuda.synchronize()
        view = (got[0].reshape(bwd_n, -1, c),) + got[1:]
        chk = norm_bwd_check(view, (ref[0].reshape(bwd_n, -1, c),) + ref[1:], torch.bfloat16)
        pads_zero = bool(torch.equal(apply_shifted_mask(got[0], dims), got[0]))
        if not chk["over"] <= 1.0 or not pads_zero or not all(
                torch.equal(a, b) for a, b in zip(got, twice)):
            fail(f"instance_norm_relu_shifted_bwd {tuple(xb.shape)} {dims}: {chk}, pads zero "
                 f"{pads_zero}")
        numel = xb.numel()
        bwd = dict(shape=list(xb.shape), dims=list(dims), dtype="bfloat16", affine=True,
                   relu=True, vs_plain=chk, pads_zero=pads_zero, bitwise_rerun=True,
                   plan=dataclasses.asdict(norm_bwd_plan(xb, dyb, shift=shift_of(xb, dims))))
        bwd["bound_ms"], bwd["bound_by"] = bound((2 * bwd_n * valid * c + numel) * 2,
                                                 14 * numel, torch.float32)
        xbv, dybv = xb.view(bwd_n, -1, c), dyb.view(bwd_n, -1, c)
        _, stu = instance_norm_relu_fwd(xbv, scale, bias)
        turns = in_turns(
            {"shifted": lambda: instance_norm_relu_bwd(dyb, xb, stb, scale, bias, True,
                                                       shifted=dims),
             "unshifted": lambda: instance_norm_relu_bwd(dybv, xbv, stu, scale, bias, True)},
            IN_BWD_PASSES, 10 if numel > 2e8 else 50)
        bwd["ms"] = turns["shifted"]["ms"]
        bwd["mode_cost"] = dict(turns, shifted_over_unshifted=bwd["ms"] / turns["unshifted"]["ms"],
                                first_design=SHIFTED_FIRST_DESIGN[tag]["backward"])
        bwd["plain_ms"] = device_ms(lambda: instance_norm_relu_bwd_ref(
            dyb, xb, mean, inv, scale, bias, True, shifted=dims), iters=3)
        bwd["library_ms"] = None
        emit("kernel_check", kernel="instance_norm_relu_shifted_backward", path=tag, **bwd)
        for name, rec, err in (("instance_norm_relu_shifted", fwd, abs_e),
                               ("instance_norm_relu_shifted_backward", bwd, chk["dx_max_abs"])):
            keys = {k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            if tag == "3d":
                main[name] = dict(max_abs_err=err, **keys)
            else:
                main[name]["at_2d_shape"] = dict(shape=rec["shape"], max_abs_err=err, **keys)
        del xb, dyb, xbv, dybv, got, twice, ref
        torch.cuda.empty_cache()
    return main


def phase_unetr_norms(gen) -> dict:
    """UNETR's InstanceNorm shapes at batch 2 (bf16, affine, ReLU off): the
    forward kernel against its plain version (phase 1's bf16 bar) and the
    backward kernel against its plain version (phase 1b's bars), each shape
    timed and summed over one UNETR forward and one train step."""
    per = dict(fwd_ms=0.0, fwd_plain_ms=0.0, fwd_bound_ms=0.0, bwd_ms=0.0, bwd_plain_ms=0.0,
               bwd_bound_ms=0.0)
    for (s, c), count in IN_UNETR:
        x, dy, scale, bias = norm_bwd_inputs(gen, (UNETR_BATCH, s, c), torch.bfloat16, True)
        got = instance_norm_relu(x, scale, bias, relu=False)
        plain = instance_norm_relu_ref(x, scale, bias, relu=False)
        torch.cuda.synchronize()
        abs_e, _, over = max_err(got, plain, BF16_STEP, 1e-6)
        if not over <= 1.0:
            fail(f"instance_norm_relu (2, {s}, {c}) ReLU off: {abs_e} over tolerance")
        vs_plain = norm_bwd_compare(x, dy, scale, bias, False, f"(2, {s}, {c}) ReLU off")
        fwd = instance_norm_times(x, scale, bias, library=False, relu=False)
        bwd = norm_backward_times(x, dy, scale, bias, False, library=False)
        emit("instance_norm_unetr_shape", shape=[UNETR_BATCH, s, c], dtype="bfloat16", relu=False,
             launches_per_forward=count, fwd_max_abs_err=abs_e, bwd_vs_plain=vs_plain,
             fwd_ms=fwd["ms"], fwd_plain_ms=fwd["plain_ms"], fwd_bound_ms=fwd["bound_ms"],
             bwd_ms=bwd["ms"], bwd_plain_ms=bwd["plain_ms"], bwd_bound_ms=bwd["bound_ms"])
        for key in per:
            per[key] += (fwd if key.startswith("fwd") else bwd)[key[4:]] * count
        del x, dy, got, plain
        torch.cuda.empty_cache()
    emit("instance_norm_per_unetr_step", launches_forward=sum(n for _, n in IN_UNETR),
         launches_backward=sum(n for _, n in IN_UNETR), **per)
    return per


def phase_2d_kernels(gen) -> dict:
    """Phase 4c's kernel shapes: attention at one modality path's (24, 8, 576,
    4) and each of HDenseFormer_2D_32's InstanceNorm shapes at batch 24, bf16,
    forward and backward, against their plain versions with phase 1's and
    1b's bars (reruns bitwise), timed beside their bounds (the largest shape
    also beside its PyTorch call), and summed over a serving forward and a
    train step with remat (each forward norm twice). Returns per kernel the
    numbers for the kernels line."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(ATTN_2D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    got = dense_attention(q, k, v)
    checks = {"plain": (attention_ref(q, k, v), 2.0 ** -8, 2e-2),
              "fp32_math": (attention_ref(q.float(), k.float(), v.float()), 2.0 ** -8, 1e-5)}
    torch.cuda.synchronize()
    rec = dict(shape=list(ATTN_2D), dtype="bfloat16")
    for ref_name, (ref, rtol, atol) in checks.items():
        abs_e, rel_e, over = max_err(got, ref, rtol, atol)
        rec[f"vs_{ref_name}"] = dict(max_abs=abs_e, max_rel=rel_e, rtol=rtol, atol=atol)
        if not over <= 1.0:
            fail(f"dense_attention {ATTN_2D} vs {ref_name}: {abs_e} over tolerance")
    if not torch.equal(got, dense_attention(q, k, v)):
        fail(f"dense_attention {ATTN_2D}: reruns differ")
    rec.update(attention_bound(ATTN_2D, torch.bfloat16))
    rec["ms"] = device_ms(lambda: dense_attention(q, k, v), iters=50)
    rec["plain_ms"] = device_ms(lambda: attention_ref(q, k, v), iters=20)
    rec["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
    rec["launches_per_forward"] = SLICE_CH * DEPTH_2D
    rec["per_forward_ms"] = rec["ms"] * SLICE_CH * DEPTH_2D
    emit("kernel_check_2d", kernel="dense_attention", **rec)
    timed = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    out = {"dense_attention": dict(max_abs_err=rec["vs_plain"]["max_abs"], **{
        key: rec[key] for key in ("shape", "per_forward_ms") + timed})}
    del q, k, v, got, checks

    fwd_sum = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bwd_sum = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for i, ((s, c), count, affine) in enumerate(IN_2D):
        shape = (SLICE_BATCH, s, c)
        x, dy, scale, bias = norm_bwd_inputs(gen, shape, torch.bfloat16, affine)
        got = instance_norm_relu(x, scale, bias)
        again = instance_norm_relu(x, scale, bias)
        plain = instance_norm_relu_ref(x, scale, bias)
        torch.cuda.synchronize()
        abs_e, _, over = max_err(got, plain, BF16_STEP, 1e-6)
        if not over <= 1.0 or not torch.equal(got, again):
            fail(f"instance_norm_relu {shape}: {abs_e} over tolerance, or reruns differ")
        vs_plain = norm_bwd_compare(x, dy, scale, bias, True, f"{shape} bfloat16")
        fwd = instance_norm_times(x, scale, bias, library=i == 0)
        bwd = norm_backward_times(x, dy, scale, bias, True, library=i == 0)
        emit("instance_norm_2d_shape", shape=list(shape), dtype="bfloat16", affine=affine,
             launches_per_forward=count, fwd_max_abs_err=abs_e, bwd_vs_plain=vs_plain,
             bitwise_rerun=True, fwd={k: fwd[k] for k in fwd if k != "passes_ms"},
             bwd={k: bwd[k] for k in bwd if k != "kernel_ms"})
        for key in fwd_sum:
            fwd_sum[key] += fwd[key] * count
            bwd_sum[key] += bwd[key] * count
        if i == 0:
            out["instance_norm_relu"] = dict(shape=list(shape), max_abs_err=abs_e, **{
                key: fwd[key] for key in timed})
            out["instance_norm_relu_backward"] = dict(
                shape=list(shape), max_abs_err=vs_plain["dx_max_abs"],
                **{key: bwd[key] for key in timed})
        del x, dy, got, again, plain
        torch.cuda.empty_cache()
    launches = sum(count for _, count, _ in IN_2D)
    emit("instance_norm_per_2d_step", launches_forward=launches, launches_backward=launches,
         per_forward=fwd_sum, per_train_step_forward={k: 2 * v for k, v in fwd_sum.items()},
         per_train_step_backward=bwd_sum)
    out["instance_norm_relu"].update({f"per_forward_{k}": v for k, v in fwd_sum.items()})
    out["instance_norm_relu_backward"].update({f"per_step_{k}": v for k, v in bwd_sum.items()})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=["all", "mha"], default="all",
                    help="mha: the environment and the fused attention's phase alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    smi = phase_env(args)
    fused = phase_mha(gen)
    if args.phase == "mha":
        print(json.dumps({"ok": True, "mha64": fused, "device": torch.cuda.get_device_name(0)}))
        return 0
    main_shapes = phase_kernels(gen)
    main_shapes["instance_norm_relu_backward"] = phase_norm_backward(gen)
    phase_shift_grad(gen)
    main_shapes.update(shifted_kernel_checks(gen))
    unetr = phase_unetr_norms(gen)
    main_shapes["instance_norm_relu"].update(
        {f"per_unetr_forward_{k}": unetr[f"fwd_{k}"] for k in ("ms", "plain_ms", "bound_ms")})
    main_shapes["instance_norm_relu_backward"].update(
        {f"per_unetr_step_{k}": unetr[f"bwd_{k}"] for k in ("ms", "plain_ms", "bound_ms")})
    for name, rec in phase_2d_kernels(gen).items():
        main_shapes[name]["at_2d_shape"] = rec
    main_shapes["dense_attention"]["backward"] = phase_attention_backward(gen)

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             **main_shapes[name])
        for name, k in KERNELS.items()
    ] + [dict(name="mha64", route="cuda", source="hdenseformer_tpu_torch/csrc/mha64.cu",
              replaces=None, **fused)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
