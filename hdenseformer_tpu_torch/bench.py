"""Train throughput of the port on one GPU: the repository's ``bench.py``,
its protocol and its output line, through ``hdenseformer_tpu_torch``.

    python -m hdenseformer_tpu_torch.bench

HDenseFormer_32 (2 modalities, 144^3, depth 24, batch 1, bf16 compute with
fp32 parameters, no rematerialisation) takes full train steps: the forward
with dropout, the deep-supervision FocalLoss, the backward, and Adam (lr
1e-3, coupled L2 1e-4), on a zero image whose label is background
everywhere. One warm step, then ``REPS`` chained windows of ``STEPS``
steps, each ended by reading the loss (a sync); the best window counts.

stderr: ``{"first_call_s"}``, then ``{"rep_window_s", "ms_per_step_best",
"contention_spread"}``. stdout: one line ``{"metric":
"train_throughput_128eq_patches_per_sec", "value", "unit", "vs_baseline"}``,
the 128^3-equivalent patches a second (a 144^3 patch counts (144/128)^3),
and its ratio to ``baselines/cpu_torch.json`` (the reference PyTorch
implementation on a host CPU).

It runs on the card and raises without one. ``--device cpu`` and the
size, depth and window options exist so that a test can run it small;
their defaults are bench.py's constants.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch

from hdenseformer_tpu_torch.losses import get_loss
from hdenseformer_tpu_torch.models import get_net
from hdenseformer_tpu_torch.models.layers import init_weights
from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step
from hdenseformer_tpu_torch.train.state import get_optimizer

VOL = 144
CHANNELS = 2
BATCH = 1
REMAT = False
DEPTH = 24
STEPS = 8
REPS = 4
LR, WEIGHT_DECAY = 1e-3, 1e-4

BASELINE_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "baselines", "cpu_torch.json")


def build(device=None, size: int = VOL, depth: int = DEPTH, seed: int = 0):
    """bench.py's train step: (state, step, batch, dropout generator).
    ``device`` None is the GPU (raising without one)."""
    net = get_net("HDenseFormer_32", CHANNELS, 2, (size,) * 3, transformer_depth=depth,
                  dtype=torch.bfloat16, remat=REMAT, device=device)
    init_weights(net, torch.Generator().manual_seed(seed))
    device = next(net.parameters()).device
    state = TrainState(net, get_optimizer("Adam", LR, weight_decay=WEIGHT_DECAY,
                                          params=net.parameters()))
    step = make_train_step(get_loss("FocalLoss", use_ds=True), 2)
    image = torch.zeros((BATCH,) + (size,) * 3 + (CHANNELS,), device=device)
    label = torch.zeros((BATCH,) + (size,) * 3 + (2,), device=device)
    label[..., 0] = 1.0
    generator = torch.Generator(device=device).manual_seed(seed)
    return state, step, {"image": image, "label": label}, generator


def time_steps(state, step, batch, generator, steps: int = STEPS, reps: int = REPS) -> dict:
    """bench.py's protocol: one warm step, then ``reps`` chained windows of
    ``steps`` steps, each ended by reading the loss, which waits for the
    card. Returns the window times, the losses and the last step's metrics;
    the state is trained in place."""
    t0 = time.perf_counter()
    state, metrics = step(state, batch, generator)
    first_loss = float(metrics["loss"])
    first_call_s = time.perf_counter() - t0
    windows, losses = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, batch, generator)
        losses.append(float(metrics["loss"]))  # the chained steps end here
        windows.append(time.perf_counter() - t0)
    return dict(first_call_s=first_call_s, first_loss=first_loss, rep_window_s=windows,
                window_losses=losses, best_window_s=min(windows), steps=steps,
                metrics=metrics)


def result_line(best_window_s: float, steps: int = STEPS, size: int = VOL,
                batch: int = BATCH, baseline_file: Optional[str] = BASELINE_FILE) -> dict:
    """bench.py's stdout line for a best window of ``steps`` steps."""
    patches_per_sec = batch * steps * (size / 128.0) ** 3 / best_window_s
    vs = None
    if baseline_file and os.path.exists(baseline_file):
        with open(baseline_file) as f:
            base = json.load(f)
        if base.get("patches_per_sec"):
            vs = patches_per_sec / base["patches_per_sec"]
    return {"metric": "train_throughput_128eq_patches_per_sec",
            "value": round(patches_per_sec, 4), "unit": "patches/s/chip",
            "vs_baseline": round(vs, 2) if vs else None}


def window_line(timed: dict) -> dict:
    """bench.py's second stderr line."""
    best = timed["best_window_s"]
    return {"rep_window_s": [round(t, 3) for t in timed["rep_window_s"]],
            "ms_per_step_best": round(1000.0 * best / timed["steps"], 1),
            "contention_spread": round(max(timed["rep_window_s"]) / best, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for tests")
    ap.add_argument("--size", type=int, default=VOL, help="patch edge")
    ap.add_argument("--depth", type=int, default=DEPTH, help="transformer_depth")
    ap.add_argument("--steps", type=int, default=STEPS, help="steps a window")
    ap.add_argument("--reps", type=int, default=REPS, help="windows")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card (--device cpu for tests)")
    state, step, batch, generator = build(args.device, args.size, args.depth, args.seed)
    timed = time_steps(state, step, batch, generator, args.steps, args.reps)
    print(json.dumps({"first_call_s": round(timed["first_call_s"], 1)}), file=sys.stderr)
    print(json.dumps(window_line(timed)), file=sys.stderr)
    print(json.dumps(result_line(timed["best_window_s"], args.steps, args.size)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
