#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hdenseformer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--depth 24]

Run from the repository root on a machine with an NVIDIA H100. It builds
the port's CUDA kernels from csrc/ and drives the serving paths of
HDenseFormer_32 and Hecktor20Top1:

0. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build and what ptxas reported;
1. each kernel against its plain version on the card at the serving
   shapes, with its stated tolerance (InstanceNorm also on 1000 + N(0, 1),
   the guard of its centred statistics; both redesigned kernels rerun
   bitwise), timed beside the plain version, one PyTorch call that
   computes the same function where there is one, and its bound (the
   larger of bytes over 3.35 TB/s and operations over the peak for the
   input type). Times are device times under torch.profiler (the kernels'
   durations, no host time between launches). InstanceNorm is also timed
   by pass and at each of its shapes in a HDenseFormer_32 serving forward
   (summed as per_forward_*), attention also on the qkv-split layout that
   serving gives it and on peaked scores, with its occupancy; then the path
   of the half-shift's backward kernel: the gradient of
   sum(conv3_packed(x, w)^2) through autograd;
2. the full-width HDenseFormer_32 forward (2 modalities, 144^3, depth 24,
   bf16, 8 windows), once through the kernels and once through the plain
   versions: logit difference, argmax agreement, kernel launch counts;
2b. the full-width Hecktor20Top1 forward (n_filters 32, 2 modalities,
   144^3, bf16, 8 windows): packed level 1 through the kernels (the
   default), packed through the plain versions, and fine through the
   kernels; then packed against fine in fp32 at 64^3;
3. serving: predict_volume on a synthetic 200^3 two-channel volume (patch
   144^3, step 72^3, window_batch 8, one model call of 8 windows): first
   call, p50 of 3 warm calls, peak device memory, launch counts, and the
   labels against the plain path's; 3b. the same for Hecktor20Top1;
4. a {"kernels": [...]} line with each kernel's numbers;
5. the result line {"ok": true, "device": {...}}.

Each path is driven with every kernel's launch count set to 0 just before
it and read just after; a kernel of the path that did not launch fails the
run.

Any failed check exits non-zero before the result line, as does a machine
without a CUDA device. fp32 comparisons run with TF32 off in cuDNN and
cuBLAS (set below for the whole run), since a float32 convolution otherwise
runs in TF32 on the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize
from hdenseformer_tpu_torch.infer.sliding import cal_steps, predict_volume
from hdenseformer_tpu_torch.models import get_net
from hdenseformer_tpu_torch.models.layers import init_weights
from hdenseformer_tpu_torch.ops import _build
from hdenseformer_tpu_torch.ops.dense_attention import attention_ref, dense_attention
from hdenseformer_tpu_torch.ops.dense_attention import launch_plan as attention_plan
from hdenseformer_tpu_torch.ops.instance_norm import (
    instance_norm_relu,
    instance_norm_relu_ref,
)
from hdenseformer_tpu_torch.ops.s2d import conv3_packed
from hdenseformer_tpu_torch.ops.shift_pack import (
    shift_pack,
    shift_pack_ref,
    shift_unpack,
    shift_unpack_ref,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
PATCH, STEP, WINDOWS, N_CLS = 144, 72, 8, 2
VOLUME = 200  # the serving case measured on the TPU, baselines/infer_latency_v5e.json
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
}
# packed-plain grid and channel counts of Hecktor20Top1's four half-shifts in
# one serving forward (8 windows of 144^3, n_filters 32): the k7 stem (2
# channels), block_1_2_left (32), block_1_1_right (64), block_1_2_right (32)
SHIFT_FC = (16, 256, 512, 256)
# (S, C) and count of HDenseFormer_32's InstanceNorm launches in one serving
# forward (8 windows of 144^3): the BasicConv/UpConv norms at each level
IN_FORWARD = (((PATCH ** 3, 32), 5), (((PATCH // 2) ** 3, 64), 5),
              (((PATCH // 4) ** 3, 128), 5), (((PATCH // 8) ** 3, 256), 3))
IN_PASSES = ("partial_stats_kernel", "finalize_kernel", "normalize_kernel")
HECKTOR_EXPECT = {"dense_attention": 0, "instance_norm_relu": 30, "shift_pack": 4,
                  "shift_pack_backward": 0}


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


def device_kernels(fn, iters: int = 10) -> dict:
    """Device ms per call of each kernel name that ``fn`` launches."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    if not by_name:
        fail("torch.profiler recorded no device time")
    return by_name


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
         depth=args.depth, kernel_build_s=round(build_s, 3), ptxas=ptxas)
    return smi


def instance_norm_times(x, scale, bias, library: bool = True) -> dict:
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
    by_kernel = device_kernels(lambda: instance_norm_relu(x, scale, bias), iters)
    passes = {p: sum(t for name, t in by_kernel.items() if p in name) for p in IN_PASSES}
    if any(t == 0 for t in passes.values()):
        fail(f"instance_norm_relu: the profiler saw {sorted(by_kernel)}, not its three passes")
    xbytes = x.numel() * x.element_size()
    rec["ms"] = sum(by_kernel.values())
    rec["passes_ms"] = passes
    rec["passes_tb_per_s"] = {"partial_stats_kernel": xbytes / passes["partial_stats_kernel"] / 1e9,
                              "normalize_kernel": 2 * xbytes / passes["normalize_kernel"] / 1e9}
    rec["plain_ms"] = device_ms(lambda: instance_norm_relu_ref(x, scale, bias), iters)
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
        nbytes, ops = 4 * q.numel() * q.element_size(), 4 * b * h * n * n * d
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
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
                key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
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
    for (s, c), count in IN_FORWARD:
        x = (torch.randn((WINDOWS, s, c), generator=gen, device=dev) * 3 + 1).to(torch.bfloat16)
        scale, bias = torch.rand(c, generator=gen, device=dev), torch.randn(c, generator=gen,
                                                                             device=dev)
        rec = dict(shape=[WINDOWS, s, c], dtype="bfloat16", launches_per_serving_forward=count,
                   **instance_norm_times(x, scale, bias, library=False))
        emit("instance_norm_serving_shape", **rec)
        for key in per_forward:
            per_forward[key] += rec[key] * count
        del x
        torch.cuda.empty_cache()
    launches = sum(count for _, count in IN_FORWARD)
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


def phase_shift_grad(gen) -> dict:
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
    expect = {"dense_attention": 0, "instance_norm_relu": 0, "shift_pack": 1,
              "shift_pack_backward": 1}
    if counts != expect or any(plain_counts.values()):
        fail(f"autograd path launched {counts} (plain path {plain_counts}), expected {expect}")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    emit("shift_grad", shape=list(x.shape), launches=counts, max_abs_err=err, scale=scale,
         atol=1e-5 * scale)
    if not (torch.isfinite(got).all() and err <= 1e-5 * scale):
        fail(f"conv3_packed gradient through the kernels: {err} over {1e-5 * scale}")
    return counts


def build_models(args):
    nets = [
        get_net("HDenseFormer_32", 2, N_CLS, (PATCH,) * 3, transformer_depth=args.depth,
                dtype=torch.bfloat16, use_kernels=use, device="cuda")
        for use in (True, False)
    ]
    init_weights(nets[0], torch.Generator().manual_seed(args.seed))
    nets[1].load_state_dict(nets[0].state_dict())
    return nets


def hdf_expect(args) -> dict:
    return {"dense_attention": 2 * args.depth, "instance_norm_relu": 18, "shift_pack": 0,
            "shift_pack_backward": 0}


def timed_forward(net, x):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = net(x)
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) * 1e3


def phase_forward(args, net, plain, gen) -> None:
    """Full-width forward through the kernels and through the plain versions."""
    x = torch.randn((WINDOWS, PATCH, PATCH, PATCH, 2), generator=gen, device="cuda")
    expect = hdf_expect(args)
    with torch.inference_mode():
        reset_counts()
        outs, first_ms = timed_forward(net, x)
        counts = read_counts()
        if counts != expect:
            fail(f"forward launched {counts}, expected {expect}")
        if counts["instance_norm_relu"] != sum(count for _, count in IN_FORWARD):
            fail(f"forward launched {counts['instance_norm_relu']} InstanceNorms, but phase 1 "
                 f"timed {IN_FORWARD} as one forward's")
        outs, warm_ms = timed_forward(net, x)
        ref, plain_first_ms = timed_forward(plain, x)
        ref, plain_ms = timed_forward(plain, x)
    shapes = [list(o.shape) for o in outs]
    want = [[WINDOWS, PATCH // 2 ** i, PATCH // 2 ** i, PATCH // 2 ** i, N_CLS] for i in range(4)]
    if shapes != want or any(o.dtype != torch.float32 for o in outs):
        fail(f"forward outputs {shapes} {[o.dtype for o in outs]}, expected fp32 {want}")
    if not all(bool(torch.isfinite(o).all()) for o in outs + ref):
        fail("forward outputs are not finite")
    diffs = [float((o - r).abs().max()) for o, r in zip(outs, ref)]
    top = ref[0].topk(2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    same = outs[0].argmax(-1) == ref[0].argmax(-1)
    agree = float(same.float().mean())
    decided = margin > 0.1
    agree_decided = float(same[decided].float().mean())
    emit("forward", launches=counts, first_ms=first_ms, warm_ms=warm_ms,
         plain_first_ms=plain_first_ms, plain_ms=plain_ms, max_abs_logit_diff=diffs,
         logit_scale=float(ref[0].abs().max()), argmax_agreement=agree,
         decided_fraction=float(decided.float().mean()),
         argmax_agreement_margin_gt_0p1=agree_decided)
    # bounds: all voxels >= 99%; voxels whose plain top-two margin exceeds 0.1
    # (a tenth of the logit scale's order) >= 99.9%. bf16 rounding differences
    # between the two paths move logits by far less than 0.1.
    if agree < 0.99 or agree_decided < 0.999:
        fail(f"argmax agreement {agree} (all), {agree_decided} (margin > 0.1)")


def synthetic_volume(seed: int) -> np.ndarray:
    """A (2, V, V, V) CT+PET volume, V = VOLUME: noise around a bright sphere."""
    rng = np.random.default_rng(seed)
    shape = (VOLUME,) * 3
    grid = np.indices(shape, dtype=np.float32) - VOLUME / 2
    sphere = (np.sqrt((grid ** 2).sum(0)) < VOLUME * 0.15).astype(np.float32)
    ct = rng.normal(0.0, 200.0, shape).astype(np.float32) + 300.0 * sphere
    pet = rng.gamma(2.0, 1.0, shape).astype(np.float32) + 8.0 * sphere
    return np.stack([ct, pet])


def phase_serving(args, net, plain, tag: str, expect: dict) -> dict:
    image = PETandCTNormalize()({"image": synthetic_volume(args.seed)})["image"]

    def serve(model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = predict_volume(model, image, (PATCH,) * 3, (STEP,) * 3, N_CLS,
                                window_batch=WINDOWS)
        return labels, (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    labels, first_ms = serve(net)
    first_counts = read_counts()
    warm, per_call = [], []
    for _ in range(3):
        reset_counts()
        again, ms = serve(net)
        warm.append(ms)
        per_call.append(read_counts())
        if not np.array_equal(again, labels):
            fail("repeated serving calls gave different labels")
    peak = torch.cuda.max_memory_allocated()
    ref, plain_ms = serve(plain)
    agree = float((labels == ref).mean())
    p50 = statistics.median(warm)
    n_windows = int(np.prod([len(s) for s in cal_steps((VOLUME,) * 3, (PATCH,) * 3,
                                                        (STEP,) * 3)]))
    emit(tag, volume=[VOLUME] * 3, patch=PATCH, step=STEP, window_batch=WINDOWS,
         windows=n_windows, label_shape=list(labels.shape), label_dtype=str(labels.dtype),
         class_histogram=np.bincount(labels.ravel(), minlength=N_CLS).tolist(),
         first_call_ms=first_ms, warm_ms=warm, p50_ms=p50,
         windows_per_s=n_windows / (p50 / 1e3),
         max_memory_allocated_bytes=peak, launches_first_call=first_counts,
         launches_per_warm_call=per_call, plain_path_ms=plain_ms,
         label_agreement_vs_plain=agree)
    if labels.shape != (VOLUME,) * 3 or labels.min() < 0 or labels.max() >= N_CLS:
        fail(f"labels {labels.shape} in [{labels.min()}, {labels.max()}]")
    if first_counts != expect or any(c != expect for c in per_call):
        fail(f"{tag} launched {first_counts} / {per_call}, expected {expect} per call")
    if agree < 0.99:
        fail(f"{tag} labels agree with the plain path on {agree} of voxels, under 0.99")
    return first_counts


def compare_logits(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Max |dlogit|, argmax agreement overall and where ref's top-two margin > 0.1."""
    top = ref.topk(2, dim=-1).values
    decided = top[..., 0] - top[..., 1] > 0.1
    same = got.argmax(-1) == ref.argmax(-1)
    return dict(max_abs_logit_diff=float((got - ref).abs().max()),
                logit_scale=float(ref.abs().max()),
                argmax_agreement=float(same.float().mean()),
                decided_fraction=float(decided.float().mean()),
                argmax_agreement_margin_gt_0p1=float(same[decided].float().mean()))


def build_hecktor(seed: int, size: int, dtype):
    """Hecktor20Top1 (n_filters 32) three ways, one set of random weights:
    packed with the kernels (get_net's default at even dims), packed with the
    plain versions, and fine with the kernels."""
    nets = {
        name: get_net("hecktor20top1", 2, N_CLS, (size,) * 3, dtype=dtype, s2d=s2d,
                      use_kernels=use, device="cuda")
        for name, s2d, use in (("packed", None, True), ("packed_plain", None, False),
                               ("fine", False, True))
    }
    init_weights(nets["packed"], torch.Generator().manual_seed(seed))
    for net in nets.values():
        net.load_state_dict(nets["packed"].state_dict())
    if not nets["packed"].packed or nets["fine"].packed:
        fail("get_net's s2d=None did not pack Hecktor20Top1 at even dims")
    return nets


def phase_hecktor_forward(args, nets, gen) -> None:
    """Full-width Hecktor20Top1 forward, three ways; then packed vs fine in fp32."""
    x = torch.randn((WINDOWS, PATCH, PATCH, PATCH, 2), generator=gen, device="cuda")
    rec, outs = {}, {}
    with torch.inference_mode():
        for name, net in nets.items():
            reset_counts()
            outs[name], first_ms = timed_forward(net, x)
            counts = read_counts()
            outs[name], warm_ms = timed_forward(net, x)
            rec[name] = dict(first_ms=first_ms, warm_ms=warm_ms, launches=counts)
    expect = {"packed": HECKTOR_EXPECT,
              "packed_plain": dict.fromkeys(HECKTOR_EXPECT, 0),
              "fine": dict(HECKTOR_EXPECT, shift_pack=0)}
    for name, out in outs.items():
        if rec[name]["launches"] != expect[name]:
            fail(f"Hecktor {name} forward launched {rec[name]['launches']}, "
                 f"expected {expect[name]}")
        if out.shape != (WINDOWS, PATCH, PATCH, PATCH, N_CLS) or out.dtype != torch.float32:
            fail(f"Hecktor {name} logits {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"Hecktor {name} logits are not finite")
    vs_plain = compare_logits(outs["packed"], outs["packed_plain"])
    vs_fine = compare_logits(outs["packed"], outs["fine"])
    emit("hecktor_forward", shape=list(x.shape), dtype="bfloat16", runs=rec,
         kernels_vs_plain=vs_plain, packed_vs_fine_bf16=vs_fine)
    # the same bar as HDenseFormer's kernel path against its plain path (bf16)
    if vs_plain["argmax_agreement"] < 0.99 or vs_plain["argmax_agreement_margin_gt_0p1"] < 0.999:
        fail(f"Hecktor kernels vs plain path: {vs_plain}")
    del outs, x
    torch.cuda.empty_cache()

    # packed against fine in fp32 (TF32 off) at 64^3, n_filters 32: JAX's bar
    # for its own packed-vs-fine test, 2e-2 of the logit scale
    small = build_hecktor(args.seed, 64, None)
    x = torch.randn((2, 64, 64, 64, 2), generator=gen, device="cuda")
    with torch.inference_mode():
        reset_counts()
        got = small["packed"](x)
        counts = read_counts()
        ref = small["fine"](x)
    cmp = compare_logits(got, ref)
    emit("hecktor_packed_vs_fine_fp32", shape=list(x.shape), launches=counts,
         atol=2e-2 * cmp["logit_scale"], **cmp)
    if counts != HECKTOR_EXPECT or not cmp["max_abs_logit_diff"] <= 2e-2 * cmp["logit_scale"]:
        fail(f"Hecktor packed vs fine fp32: {cmp}, launches {counts}")
    del small, got, ref
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=24, help="transformer_depth (24 = full)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    smi = phase_env(args)
    main_shapes = phase_kernels(gen)
    by_path = {"shift_grad": phase_shift_grad(gen)}
    net, plain = build_models(args)
    phase_forward(args, net, plain, gen)
    by_path["serve-200"] = phase_serving(args, net, plain, "serving", hdf_expect(args))
    del net, plain
    torch.cuda.empty_cache()
    nets = build_hecktor(args.seed, PATCH, torch.bfloat16)
    phase_hecktor_forward(args, nets, gen)
    by_path["serve-200-hecktor"] = phase_serving(
        args, nets["packed"], nets["packed_plain"], "serving_hecktor", HECKTOR_EXPECT)

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             launches=sum(counts[name] for counts in by_path.values()),
             launches_by_path={path: counts[name] for path, counts in by_path.items()},
             **main_shapes[name])
        for name, k in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
