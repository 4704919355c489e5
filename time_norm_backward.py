#!/usr/bin/env python3
"""Device time of the InstanceNorm+ReLU backward kernel at the train steps'
shapes, for one or more checkouts of this repository in turn, on one GPU.

    python3 time_norm_backward.py [--trees DIR [DIR ...]] [--seed 0]

Each DIR is the root of a checkout (default: the directory of this script).
Give two checkouts in turns to compare them within one run on one card, as
``--trees parent change change parent``. Each tree runs in a process of its
own, which imports ``hdenseformer_tpu_torch`` from that tree, builds its
kernels there, and times ``instance_norm_relu_bwd`` (the wrapper's whole
call; its kernels' device time under torch.profiler, best of 3 profiles of
10 to 50 calls) on the same inputs from ``--seed``, at

- the 18 InstanceNorms of bench.py's HDenseFormer_32 train step: batch 1,
  bf16, affine, ReLU (``chip_smoke.IN_FORWARD``);
- the 30 of a Hecktor20Top1 trainer step: batch 2, bf16, no affine, no ReLU
  (``chip_smoke.IN_HECKTOR_TRAIN``).

Each tree's run prints one JSON line (per shape: ms, the bound, and for a
checkout whose backward is one persistent launch, its plan's grid, tile and
parts; the sums over both steps).

The card's name and power limit come first. Exits non-zero without a CUDA
device or if a tree's run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def device_ms(fn, iters: int) -> float:
    """Device time of one ``fn()``: the best of 3 profiles of ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        t = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA) / iters / 1e3
        if t > 0 and (best is None or t < best):
            best = t
    if best is None:
        sys.exit("time_norm_backward: torch.profiler recorded no device time")
    return best


def case(gen, shape, affine: bool, relu: bool, inorm):
    """x, dy, scale, bias and the forward kernel's stats of one bf16 case."""
    import torch

    dev = torch.device("cuda")
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    scale = bias = None
    if affine:
        scale = torch.randn(c, generator=gen, device=dev)
        scale[0] = 0.0
        bias = torch.randn(c, generator=gen, device=dev)
    _, stats = inorm.instance_norm_relu_fwd(x, scale, bias, relu=relu)
    return x, dy, scale, bias, stats


def worker(tree: str, seed: int, tables: dict) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from hdenseformer_tpu_torch.ops import instance_norm as inorm

    if not torch.cuda.is_available():
        sys.exit("time_norm_backward: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"tree": tree, "module": inorm.__file__, "steps": {}}
    for step, (batch, affine, relu, table) in tables.items():
        rows, total, total_bound = [], 0.0, 0.0
        for (s, c), count in table:
            x, dy, scale, bias, stats = case(gen, (batch, s, c), affine, relu, inorm)
            n = x.numel()
            ms = device_ms(lambda: inorm.instance_norm_relu_bwd(dy, x, stats, scale, bias, relu),
                           10 if n > 2e8 else 50)
            bound = 3 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
            row = dict(shape=[batch, s, c], launches=count, ms=ms, bound_ms=bound)
            if hasattr(inorm, "bwd_plan"):
                plan = inorm.bwd_plan(x, dy)
                row["plan"] = dict(grid=plan.grid, channel_tile=plan.channel_tile,
                                   parts=plan.parts)
            rows.append(row)
            total += ms * count
            total_bound += bound * count
            del x, dy
            torch.cuda.empty_cache()
        out["steps"][step] = dict(shapes=rows, launches=sum(c for _, c in table),
                                  ms=total, bound_ms=total_bound)
    return out


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=[here])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--tables", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, json.loads(args.tables))), flush=True)
        return 0

    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("time_norm_backward: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import IN_FORWARD, IN_HECKTOR_TRAIN

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    tables = {"bench_train_step": (1, True, True, IN_FORWARD),
              "hecktor_train_step": (2, False, False, IN_HECKTOR_TRAIN)}
    for tree in args.trees:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree, "--seed",
             str(args.seed), "--tables", json.dumps(tables)],
            capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout, run.stderr[-4000:], file=sys.stderr)
            return 1
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
