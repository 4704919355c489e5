#!/usr/bin/env python3
"""Where the device time of one serving call goes, on one GPU.

    python3 profile_torch_serving.py [--seed 0] [--depth 24]
        [--net HDenseFormer_32|hecktor20top1] [--fine]

Builds the model at full width with random weights, as chip_smoke.py does
(HDenseFormer_32 by default; hecktor20top1 with its level 1 packed, or on
the fine grid with --fine), serves its synthetic 200^3 two-channel volume
twice to warm up (patch 144^3, step 72^3, window_batch 8: one model call of
8 windows), then runs a third call under torch.profiler and prints JSON
lines:

- "call": host wall time of the profiled call, device busy time (the union
  of its kernels' intervals), and the device's idle share;
- "groups": device time of each of the port's kernels and of everything else;
- "kernels": the 25 kernels with the most device time, with launch counts.

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
    IN_PASSES,
    N_CLS,
    PATCH,
    STEP,
    WINDOWS,
    build_hecktor,
    build_models,
    synthetic_volume,
)
from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize
from hdenseformer_tpu_torch.infer.sliding import predict_volume

# the port's kernels by symbol name (csrc/*.cu); InstanceNorm is three passes
GROUPS = {
    "dense_attention kernel": ("dense_attention_kernel",),
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.net == "hecktor20top1":
        net = build_hecktor(args.seed, PATCH, torch.bfloat16)["fine" if args.fine else "packed"]
    else:
        net, _ = build_models(args)
    image = PETandCTNormalize()({"image": synthetic_volume(args.seed)})["image"]

    def serve():
        return predict_volume(net, image, (PATCH,) * 3, (STEP,) * 3, N_CLS,
                              window_batch=WINDOWS)

    for _ in range(2):
        serve()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
        "packed": bool(getattr(net, "packed", False)), "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / wall_us,
        "kernel_launches": len(kernels)}}))
    print(json.dumps({"groups": {g: {"ms": t / 1e3, "share_of_busy": t / busy}
                                 for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])}}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({"kernels": [{"name": n[:160], "ms": t / 1e3, "count": count[n]}
                                  for n, t in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
