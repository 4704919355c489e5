#!/usr/bin/env python3
"""Where the device time of one serving call, or one train step, goes, on one GPU.

    python3 profile_torch_serving.py [--seed 0] [--depth 24]
        [--net HDenseFormer_32|hecktor20top1] [--fine] [--train]

Builds the model at full width with random weights, as chip_smoke.py does
(HDenseFormer_32 by default; hecktor20top1 with its level 1 packed, or on
the fine grid with --fine), serves its synthetic 200^3 two-channel volume
twice to warm up (patch 144^3, step 72^3, window_batch 8: one model call of
8 windows), times unprofiled calls, then runs one more under torch.profiler
and prints JSON lines. With --train it does the same with steps of bench.py's
train step (HDenseFormer_32, 144^3, batch 1, bf16, FocalLoss deep supervision,
Adam; chip_smoke.build_train) on a synthetic case:

- "call": host wall time of the profiled call (or step), device busy time
  (the union of its kernels' intervals), and the device's idle share; and,
  timed just before it in the same process without the profiler, the ms a
  call (the median of 5 serving calls, or a chained window of 8 train steps
  over 8) and the idle share that leaves beside the busy time (the
  profiler records on the host; the kernels' device time is not moved);
- "groups": device time of each of the port's kernels and of everything else;
- "kernels": the 25 kernels with the most device time, with launch counts;
- "ops": the 12 operators (with their input shapes) whose own kernels take
  the most device time, which names the layer behind a library kernel.

Shapes are recorded, so the profiled call's host times (wall, idle share)
are longer than an unprofiled call's; the device's are not moved.

It needs a CUDA device and exits non-zero without one, or if the profiler
recorded no device activity.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from chip_smoke import (
    IN_BWD_PASSES,
    IN_PASSES,
    N_CLS,
    PATCH,
    STEP,
    WINDOWS,
    build_hecktor,
    build_models,
    build_train,
    synthetic_volume,
)
from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize
from hdenseformer_tpu_torch.infer.sliding import predict_volume

# the port's kernels by symbol name (csrc/*.cu); InstanceNorm is three passes
# each way (the backward first: "finalize_kernel" names a pass of both)
GROUPS = {
    "dense_attention kernel": ("dense_attention_kernel",),
    "instance_norm_relu backward kernel": IN_BWD_PASSES,
    "instance_norm_relu kernel": IN_PASSES,
    "shift_pack kernel": ("shift_kernel",),
}


def group_of(name: str) -> str:
    for group, keys in GROUPS.items():
        if any(k in name for k in keys):
            return group
    return "other (library kernels)"


def busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--net", choices=("HDenseFormer_32", "hecktor20top1"),
                    default="HDenseFormer_32")
    ap.add_argument("--fine", action="store_true",
                    help="hecktor20top1 on the fine grid (default: level 1 packed)")
    ap.add_argument("--train", action="store_true",
                    help="profile a train step of HDenseFormer_32 instead of serving")
    args = ap.parse_args()
    if args.train and (args.net != "HDenseFormer_32" or args.fine):
        ap.error("--train profiles HDenseFormer_32's train step")
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        state, step, batch, gen = build_train(args)
        net = state.model

        def serve():
            step(state, batch, gen)
    else:
        if args.net == "hecktor20top1":
            net = build_hecktor(args.seed, PATCH, torch.bfloat16)["fine" if args.fine
                                                                    else "packed"]
        else:
            net, _ = build_models(args)
        image = PETandCTNormalize()({"image": synthetic_volume(args.seed)})["image"]

        def serve():
            return predict_volume(net, image, (PATCH,) * 3, (STEP,) * 3, N_CLS,
                                  window_batch=WINDOWS)

    for _ in range(2):
        serve()
    torch.cuda.synchronize()
    if args.train:  # a chained window, as chip_smoke.py times the step
        t0 = time.perf_counter()
        for _ in range(8):
            serve()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / 8
    else:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        plain_ms = sorted(times)[2]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # the device's kernels and copies; not the ranges that annotate them on
    # the device's timeline (the optimizer's step is one)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("profile_torch_serving: the profiler recorded no device time", file=sys.stderr)
        return 1
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name, count, by_group = defaultdict(float), defaultdict(int), defaultdict(float)
    for e in kernels:
        d = e.time_range.elapsed_us()
        by_name[e.name] += d
        count[e.name] += 1
        by_group[group_of(e.name)] += d
    print(json.dumps({"call": {
        "device": torch.cuda.get_device_name(0), "net": args.net,
        "what": "train step" if args.train else "serving call",
        "packed": bool(getattr(net, "packed", False)), "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / wall_us,
        "unprofiled_ms": plain_ms, "device_idle_share_unprofiled": 1 - busy / 1e3 / plain_ms,
        "kernel_launches": len(kernels)}}))
    print(json.dumps({"groups": {g: {"ms": t / 1e3, "share_of_busy": t / busy}
                                 for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])}}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({"kernels": [{"name": n[:160], "ms": t / 1e3, "count": count[n]}
                                  for n, t in top]}))
    ops = sorted(prof.key_averages(group_by_input_shape=True),
                 key=lambda a: -a.self_device_time_total)[:12]
    print(json.dumps({"ops": [{"op": a.key, "input_shapes": str(a.input_shapes)[:200],
                               "self_device_ms": a.self_device_time_total / 1e3,
                               "count": a.count} for a in ops]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
