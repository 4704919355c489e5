#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hdenseformer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--depth 24]

Run from the repository root on a machine with an NVIDIA H100. It builds
the port's CUDA kernels from csrc/ and drives the serving path:

0. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build and what ptxas reported;
1. each kernel against its plain version on the card at the serving
   shapes, with its stated tolerance, timed beside the plain version, one
   PyTorch call that computes the same function, and its bound (the larger
   of bytes over 3.35 TB/s and operations over the peak for the input type);
2. the full-width HDenseFormer_32 forward (2 modalities, 144^3, depth 24,
   bf16, 8 windows), once through the kernels and once through the plain
   versions: logit difference, argmax agreement, kernel launch counts;
3. serving: predict_volume on a synthetic 200^3 two-channel volume (patch
   144^3, step 72^3, window_batch 8, one model call of 8 windows): first
   call, p50 of 3 warm calls, peak device memory, launch counts, and the
   labels against the plain path's;
4. a {"kernels": [...]} line with each kernel's numbers;
5. the result line {"ok": true, "device": {...}}.

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

from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize
from hdenseformer_tpu_torch.infer.sliding import cal_steps, predict_volume
from hdenseformer_tpu_torch.models import get_net
from hdenseformer_tpu_torch.models.layers import init_weights
from hdenseformer_tpu_torch.ops import _build
from hdenseformer_tpu_torch.ops.dense_attention import attention_ref, dense_attention
from hdenseformer_tpu_torch.ops.instance_norm import (
    instance_norm_relu,
    instance_norm_relu_ref,
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
    """Median over ``reps`` of the mean device time of ``iters`` calls."""
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


def phase_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version; returns the main-shape numbers."""
    dev = torch.device("cuda")
    main = {}

    # --- dense attention -------------------------------------------------
    # Tolerances: fp32, summation order and exp2: 1e-5 + 1e-4 |ref|. bf16
    # against the fp32 math on the same inputs: one output rounding,
    # 1e-5 + 2^-8 |ref|. bf16 against the plain bf16 version, which also
    # rounds the probabilities to bf16 before the second product (the kernel
    # keeps them in fp32): that rounding moves an output by up to
    # 2^-9 * max|v| ~ 1e-2, so 2e-2 + 2^-8 |ref|.
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
        rec["ms"] = cuda_ms(lambda: dense_attention(q, k, v), iters=50)
        rec["plain_ms"] = cuda_ms(lambda: attention_ref(q, k, v), iters=20)
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
        emit("kernel_check", kernel="dense_attention", **rec)
        if shape == (8, 8, 729, 4) and dtype == torch.bfloat16:
            main["dense_attention"] = dict(max_abs_err=rec["vs_plain"]["max_abs"], **{
                key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        del q, k, v, got, plain, math32

    # --- InstanceNorm + ReLU ---------------------------------------------
    # Tolerances: fp32, summation order: 1e-5 + 1e-5 |ref|. bf16: the kernel
    # and the plain version round the same fp32 value unless their statistics
    # (summed in different orders) put it across a rounding boundary, so at
    # most one bf16 step apart: 1e-6 + 2^-7 |ref|.
    for (n, s, c), dtype, affine in (
        ((WINDOWS, PATCH ** 3, 32), torch.bfloat16, True),  # the largest serving call
        ((2, 1000, 32), torch.float32, True),
        ((2, 1000, 32), torch.float32, False),
        ((1, 300, 16), torch.float32, True),
    ):
        x = (torch.randn((n, s, c), generator=gen, device=dev) * 3 + 1).to(dtype)
        scale = torch.rand(c, generator=gen, device=dev) if affine else None
        bias = torch.randn(c, generator=gen, device=dev) if affine else None
        got = instance_norm_relu(x, scale, bias)
        again = instance_norm_relu(x, scale, bias)
        plain = instance_norm_relu_ref(x, scale, bias)
        torch.cuda.synchronize()
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_STEP, 1e-6)
        abs_e, rel_e, over = max_err(got, plain, rtol, atol)
        rec = dict(shape=[n, s, c], dtype=str(dtype).replace("torch.", ""), affine=affine,
                   vs_plain=dict(max_abs=abs_e, max_rel=rel_e, rtol=rtol, atol=atol),
                   bitwise_rerun=bool(torch.equal(got, again)))
        if not over <= 1.0:
            fail(f"instance_norm_relu {(n, s, c)} {dtype}: {abs_e} over tolerance")
        if not rec["bitwise_rerun"]:
            fail(f"instance_norm_relu {(n, s, c)} {dtype}: reruns differ")
        # ~11 fp32 operations per element: Welford 6, normalize+affine+ReLU 5
        nbytes = 2 * x.numel() * x.element_size() + (2 * c * 4 if affine else 0)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 11 * x.numel(), torch.float32)
        iters = 10 if x.numel() > 1e8 else 50
        rec["ms"] = cuda_ms(lambda: instance_norm_relu(x, scale, bias), iters=iters)
        rec["plain_ms"] = cuda_ms(lambda: instance_norm_relu_ref(x, scale, bias), iters=iters)
        # the library call on the same channels-last tensor, viewed as (N, C, S)
        rec["library_ms"] = cuda_ms(
            lambda: F.relu(F.instance_norm(x.transpose(1, 2), weight=scale, bias=bias, eps=1e-5)),
            iters=iters,
        )
        emit("kernel_check", kernel="instance_norm_relu", **rec)
        if "instance_norm_relu" not in main:
            main["instance_norm_relu"] = dict(max_abs_err=abs_e, **{
                key: rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        del x, got, again, plain
    torch.cuda.empty_cache()
    return main


def build_models(args):
    nets = [
        get_net("HDenseFormer_32", 2, N_CLS, (PATCH,) * 3, transformer_depth=args.depth,
                dtype=torch.bfloat16, use_kernels=use, device="cuda")
        for use in (True, False)
    ]
    init_weights(nets[0], torch.Generator().manual_seed(args.seed))
    nets[1].load_state_dict(nets[0].state_dict())
    return nets


def timed_forward(net, x):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = net(x)
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) * 1e3


def phase_forward(args, net, plain, gen) -> None:
    """Full-width forward through the kernels and through the plain versions."""
    x = torch.randn((WINDOWS, PATCH, PATCH, PATCH, 2), generator=gen, device="cuda")
    expect = {"dense_attention": 2 * args.depth, "instance_norm_relu": 18}
    with torch.inference_mode():
        reset_counts()
        outs, first_ms = timed_forward(net, x)
        counts = read_counts()
        if counts != expect:
            fail(f"forward launched {counts}, expected {expect}")
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


def phase_serving(args, net, plain) -> dict:
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
    emit("serving", volume=[VOLUME] * 3, patch=PATCH, step=STEP, window_batch=WINDOWS,
         windows=n_windows, label_shape=list(labels.shape), label_dtype=str(labels.dtype),
         class_histogram=np.bincount(labels.ravel(), minlength=N_CLS).tolist(),
         first_call_ms=first_ms, warm_ms=warm, p50_ms=p50,
         windows_per_s=n_windows / (p50 / 1e3),
         max_memory_allocated_bytes=peak, launches_first_call=first_counts,
         launches_per_warm_call=per_call, plain_path_ms=plain_ms,
         label_agreement_vs_plain=agree)
    expect = {"dense_attention": 2 * args.depth, "instance_norm_relu": 18}
    if labels.shape != (VOLUME,) * 3 or labels.min() < 0 or labels.max() >= N_CLS:
        fail(f"labels {labels.shape} in [{labels.min()}, {labels.max()}]")
    if first_counts != expect or any(c != expect for c in per_call):
        fail(f"serving launched {first_counts} / {per_call}, expected {expect} per call")
    if agree < 0.99:
        fail(f"serving labels agree with the plain path on {agree} of voxels, under 0.99")
    return first_counts


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
    net, plain = build_models(args)
    phase_forward(args, net, plain, gen)
    launches = phase_serving(args, net, plain)

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             launches=launches[name], **main_shapes[name])
        for name, k in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
