#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hdenseformer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--depth 24]

Run from the repository root on a machine with an NVIDIA H100. It builds
the port's CUDA kernels from csrc/ and drives the serving paths of
HDenseFormer_32 and Hecktor20Top1, the train step of HDenseFormer_32, the
3-D zoo's forwards and train steps, the 2-D path (HDenseFormer_2D_32 and
the smp-style baselines, per-slice prediction), and the trainer of da_unet,
HDenseFormer_2D_32, HDenseFormer_32 and Hecktor20Top1 (in ``_smoke_work/``,
removed at the end):

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
1b. the InstanceNorm backward kernel (one cooperative launch) against its
   plain version (the port of fused_norm's VJP) given the same statistics,
   rerun bitwise, at the train step's largest shape (1, 144^3, 32) in bf16
   and fp32, at ragged S with C in {2, 32, 256}, affine and plain, ReLU on
   and off, and on 1000 + N(0, 1); timed against its byte bound (its launch
   plan printed beside), beside the plain version and torch.autograd.grad through
   F.relu(F.instance_norm(...)); summed over a bench.py train step's 18
   InstanceNorm shapes (forward and backward) and over the 30 backward
   shapes of a Hecktor20Top1 trainer step (batch 2);
1c. on-device augmentation (``data/augment_device.augment_batch_3d``, no
   custom kernel): the draw and apply of a batch of 2 synthetic CT+PET
   cases of 152^3 cropped to 144^3, the same drawn values applied on the
   card and on the CPU (image within 1e-5 + 1e-5 |ref|, labels equal on at
   least 99.99 % of the voxels: only soft values at 0.5 may round across),
   the whole augmentation timed by device time with its draw, beside the
   host pipeline's time for one sample;
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
4. training: one train step of HDenseFormer_32 at 64^3, depth 4, through
   the kernels and through the plain versions from the same weights and
   dropout seed, in fp32 and in bf16, beside the plain path on an input
   moved by one rounding step (the network's own sensitivity, which sets
   the bars); then the full-width train step of bench.py (2 modalities,
   144^3, batch 1, depth 24, bf16, FocalLoss deep supervision, Adam with
   coupled L2 1e-4, lr 1e-3, dropout 0.5, no rematerialisation) on its zero
   image, built and timed by ``hdenseformer_tpu_torch.bench`` (one warm
   step, the best of 4 chained windows of 8 steps): the loss after every
   window, peak memory, launches per step, and the bench's JSON line;
   then one 64^3 fp32 step with remat on and off (cuDNN deterministic, one
   dropout seed: equal loss, gradients within 1e-5 of their max, the
   generator in one state), and the peak memory and time of one full-width
   step at batch 2 with remat on and off, of HDenseFormer_32 and of
   Hecktor20Top1;
4b. the 3-D zoo: UNETR's InstanceNorm shapes at batch 2 (affine, ReLU off,
   bf16), forward and backward kernels against their plain versions and
   timed, summed over a forward and a step; then each of unet_3d, da_unet,
   se_unet, da_se_unet, res_da_se_unet, TransBTS and unetr from get_net at
   the Hecktor21 preset (2 channels, 2 classes, 144^3, bf16, full width): an
   eval forward of 2 windows and 2 train steps at batch 2 (FocalLoss, Adam
   with coupled L2 1e-4, lr 1e-3, seeded dropout): finite losses, ms a step,
   peak memory, parameters; launches checked against the model's count
   (UNETR 15 InstanceNorms a forward, 15 + 15 a step; the others none); a
   BatchNorm model's running statistics unmoved by the eval forward and all
   moved by the steps; UNETR's eval forward also through the plain versions
   (phase 2's bars). Then da_unet through the trainer: one epoch of fold 1
   on phase 5's cases, inf-sw of one 200^3 volume (labels equal to
   predict_volume's under the checkpoint's weights and running statistics,
   which must have moved off (0, 1)), eval;
4c. the 2-D path at the PI-CAI22 preset (3 channels, 384^2, 2 classes,
   bf16, full width, batch 24): attention at one modality path's (24, 8,
   576, 4) and each of HDenseFormer_2D_32's 18 InstanceNorm shapes, forward
   and backward, against their plain versions with phase 1's and 1b's bars,
   timed beside their bounds and summed over a forward and a step;
   HDenseFormer_2D_32 (get_net's remat on) through the kernels and through
   the plain versions on 24 slices (phase 2's bars), then 2 train steps
   (launches checked: 72 attentions and 18 norms a forward, twice in a step
   with the recompute, 18 backward norms); unet, unet++ and deeplabv3+ on
   resnet18 and resnet50: an eval forward (the aux head's (24, 1) logits,
   running statistics unmoved) and 2 train steps (finite losses, every
   running statistic moved, no kernel of the port); then the 2-D journey:
   one epoch of HDenseFormer_2D_32 through the trainer on 72 synthetic
   slice cases (.npy), ``predict_case_2d`` of two 3 x 30 x 400^2 volumes
   (seconds a volume, slices/s; labels equal to a direct argmax of the
   model's logits on the same preprocessed slices) and their dice and HD95;
5. the trainer: 6 synthetic 152^3 cases (3 patients x 2), written as .hdf5
   where h5py imports and driven through the CLI (``cli.main``), else as
   .npy case directories driven through ``SemanticSeg`` with a .npy reader
   (the CLI's own calls; the line says which). Fold 1 of 3 trains 2 epochs
   at the Hecktor21 preset (HDenseFormer_32, 144^3, depth 24, batch 2, bf16,
   remat, DS FocalLoss, Adam with coupled L2 1e-4, poly LR), resumes one
   epoch from its best checkpoint, infers two 200^3 volumes (window batch
   8) and is evaluated (dice, HD95); then one epoch of Hecktor20Top1 (with
   the preset's remat, as JAX). Per epoch: losses, dice, seconds, step time
   and the share spent waiting on the loader; launches per train step,
   checked against the counts the models' code gives;
5b. the same 2 epochs of HDenseFormer_32 with ``device_augment=True``
   (through ``SemanticSeg``: the CLI has no flag for it, as JAX's has
   none): the loader ships raw cases and the augmentation runs in the step
   on the card. Steady step time, loader-wait share and peak memory beside
   phase 5's; launches per train step equal to phase 5's; finite losses;
6. a {"kernels": [...]} line with each kernel's numbers;
7. the result line {"ok": true, "device": {...}}.

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
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from hdenseformer_tpu_torch import bench, cli
from hdenseformer_tpu_torch.configs import get_config
from hdenseformer_tpu_torch.data import augment_device
from hdenseformer_tpu_torch.data.augment3d import (
    RandomCrop3D,
    RandomFlip3D,
    RandomTranslationRotationZoom3D,
)
from hdenseformer_tpu_torch.data.io import hdf5_reader, save_as_hdf5
from hdenseformer_tpu_torch.data.pipeline import get_cross_validation_by_sample
from hdenseformer_tpu_torch.data.transforms import Compose, PETandCTNormalize, ToOneHot
from hdenseformer_tpu_torch.infer.sliding import cal_steps, predict_volume
from hdenseformer_tpu_torch.losses import get_loss
from hdenseformer_tpu_torch.metrics.eval3d import multi_dice, multi_hd
from hdenseformer_tpu_torch.models import get_net
from hdenseformer_tpu_torch.models.layers import init_weights
from hdenseformer_tpu_torch.ops import _build
from hdenseformer_tpu_torch.ops.dense_attention import attention_ref, dense_attention
from hdenseformer_tpu_torch.ops.dense_attention import launch_plan as attention_plan
from hdenseformer_tpu_torch.ops.instance_norm import (
    absolute_stats,
    instance_norm_relu,
    instance_norm_relu_bwd,
    instance_norm_relu_bwd_ref,
    instance_norm_relu_fwd,
    instance_norm_relu_ref,
)
from hdenseformer_tpu_torch.ops.instance_norm import bwd_plan as norm_bwd_plan
from hdenseformer_tpu_torch.ops.s2d import conv3_packed
from hdenseformer_tpu_torch.ops.shift_pack import (
    shift_pack,
    shift_pack_ref,
    shift_unpack,
    shift_unpack_ref,
)
from hdenseformer_tpu_torch.train.checkpoint import get_weight_path, load_checkpoint
from hdenseformer_tpu_torch.train.loop import SemanticSeg, TrainState, make_train_step
from hdenseformer_tpu_torch.train.state import get_optimizer

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
    # the counterpart of fused_norm's VJP, plain XLA in JAX (not Pallas)
    "instance_norm_relu_backward": dict(
        wrapper=instance_norm_relu_bwd,
        source="hdenseformer_tpu_torch/csrc/instance_norm_relu.cu",
        replaces="hdenseformer_tpu/ops/fused_norm.py:271",
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
IN_BWD_PASSES = ("bwd_persistent_kernel",)
HECKTOR_EXPECT = {"dense_attention": 0, "instance_norm_relu": 30, "shift_pack": 4,
                  "shift_pack_backward": 0, "instance_norm_relu_backward": 0}
# (S, C) and count of Hecktor20Top1's InstanceNorms (no affine, no ReLU) in
# one step at 144^3, n_filters 32, level 1 packed: the (8 * 72^3, 32) view of
# block_1_1_left (conv1 and res_conv), block_1_2_left and block_1_{1,2}_right;
# levels 2-4: the first left block's two, two more left and two right; level
# 5's four left; the vision heads' 1x1 norms on the 72^3, 36^3 and 18^3 grids
IN_HECKTOR_TRAIN = (((8 * (PATCH // 2) ** 3, 32), 5), (((PATCH // 2) ** 3, 64), 6),
                    (((PATCH // 4) ** 3, 128), 6), (((PATCH // 8) ** 3, 256), 6),
                    (((PATCH // 16) ** 3, 512), 4), (((PATCH // 2) ** 3, 32), 1),
                    (((PATCH // 4) ** 3, 32), 1), (((PATCH // 8) ** 3, 32), 1))
# one Hecktor20Top1 train step with remat (checkpointed: every block but the
# three vision heads): the forward's 30 norms and 4 half-shifts, the
# recompute's 27 and 4 (all four half-shifts sit in checkpointed level-1
# blocks), a backward per norm, and 3 backward half-shifts (the stem's
# input needs no gradient)
HECKTOR_TRAIN_EXPECT = {"dense_attention": 0, "instance_norm_relu": 30 + 27, "shift_pack": 4 + 4,
                        "shift_pack_backward": 3, "instance_norm_relu_backward": 30}
# the train step of bench.py: batch 1, Adam with coupled L2, 4 chained
# windows of 8 steps; a 144^3 patch counts (144 / 128)^3 128^3 patches
LR, WEIGHT_DECAY = bench.LR, bench.WEIGHT_DECAY
TRAIN_WINDOWS, TRAIN_STEPS = bench.REPS, bench.STEPS
PATCH_EQUIV = (PATCH / 128) ** 3
# the trainer phase: 6 synthetic cases of CASE^3 (3 patients x 2; RandomCrop3D
# draws a 144^3 patch), fold 1 of 3, 2 epochs, then one resumed
CASE, TRAIN_EPOCHS = 152, 2
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_work")
# the conv biases under an InstanceNorm without affine: their true gradient
# is zero, and what any implementation returns for them is rounding noise
ZERO_GRADIENT = ("deep_conv.conv.bias", "up1.conv.bias", "up2.conv.bias", "up3.conv.bias")
# the 3-D zoo of get_net, at the Hecktor21 preset (2 channels, 2 classes,
# 144^3, bf16, full width), batch 2
ZOO = ("unet_3d", "da_unet", "se_unet", "da_se_unet", "res_da_se_unet", "TransBTS", "unetr")
ZOO_BATCH, ZOO_STEPS = 2, 2
# (S, C) and count of UNETR's InstanceNorms (affine, no ReLU) in one forward
# at 144^3: three a UnetResBlock (norm1, norm2 and the residual's norm3),
# encoder1 and decoder2 at 144^3 x 16, decoder3 at 72^3 x 32, decoder4 at
# 36^3 x 64, decoder5 at 18^3 x 128
IN_UNETR = (((PATCH ** 3, 16), 6), (((PATCH // 2) ** 3, 32), 3),
            (((PATCH // 4) ** 3, 64), 3), (((PATCH // 8) ** 3, 128), 3))
# phase 4c, the 2-D path at the PI-CAI22 preset: 3 channels, 384^2 slices, 2
# classes, bf16, full width, 24 slices a batch (the preset's 2-D batch)
SLICE, SLICE_CH, SLICE_BATCH = 384, 3, 24
# (S, C), count and affine of HDenseFormer_2D_32's InstanceNorms in one
# forward at 384^2: the BasicConvs (affine), two a level in the encoder and
# two in the decoder (level 4: encoder only), and the UpConv pyramid's four
# (no affine): deep_conv on the 24^2 token grid, up1-up3
IN_2D = (((SLICE ** 2, 32), 4, True), (((SLICE // 2) ** 2, 64), 4, True),
         (((SLICE // 4) ** 2, 128), 4, True), (((SLICE // 8) ** 2, 256), 2, True),
         (((SLICE // 16) ** 2, 256), 1, False), (((SLICE // 8) ** 2, 128), 1, False),
         (((SLICE // 4) ** 2, 64), 1, False), (((SLICE // 2) ** 2, 32), 1, False))
ATTN_2D = (SLICE_BATCH, 8, (SLICE // 16) ** 2, 4)  # one modality path's attention
SMP_2D = tuple((net, enc) for net in ("unet", "unet++", "deeplabv3+")
               for enc in ("resnet18", "resnet50"))
SMP_2D_STEPS = 2
# the 2-D journey: 72 slice cases (fold 1 of 3: 48 train, 2 steps of 24), then
# per-slice prediction of 2 volumes of 30 slices of 400^2 (chunks of 24 and 6)
JOURNEY_SLICES, JOURNEY_VOLUME = 72, (30, 400, 400)


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
    then summed over a bench.py train step's 18 InstanceNorm shapes at batch
    1, and over a Hecktor20Top1 trainer step's 30 at batch 2."""
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
    for (s, c), count in IN_FORWARD:
        x, dy, scale, bias = norm_bwd_inputs(gen, (1, s, c), torch.bfloat16, True)
        vs_plain = norm_bwd_compare(x, dy, scale, bias, True, f"(1, {s}, {c}) bfloat16")
        fwd = instance_norm_times(x, scale, bias, library=False)
        bwd = norm_backward_times(x, dy, scale, bias, True, library=False)
        emit("instance_norm_train_shape", shape=[1, s, c], dtype="bfloat16",
             launches_per_train_step=count, vs_plain=vs_plain, bitwise_rerun=True,
             fwd_ms=fwd["ms"], fwd_bound_ms=fwd["bound_ms"], bwd_ms=bwd["ms"],
             bwd_plain_ms=bwd["plain_ms"], bwd_bound_ms=bwd["bound_ms"], plan=bwd["plan"])
        for key, val in (("fwd_ms", fwd["ms"]), ("fwd_bound_ms", fwd["bound_ms"]),
                         ("bwd_ms", bwd["ms"]), ("bwd_plain_ms", bwd["plain_ms"]),
                         ("bwd_bound_ms", bwd["bound_ms"])):
            per_step[key] += val * count
        del x, dy
        torch.cuda.empty_cache()
    emit("instance_norm_per_train_step", launches=sum(count for _, count in IN_FORWARD),
         **per_step)

    # a Hecktor20Top1 trainer step's backward InstanceNorms (batch 2, bf16, no
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
              "shift_pack_backward": 1, "instance_norm_relu_backward": 0}
    if counts != expect or any(plain_counts.values()):
        fail(f"autograd path launched {counts} (plain path {plain_counts}), expected {expect}")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    emit("shift_grad", shape=list(x.shape), launches=counts, max_abs_err=err, scale=scale,
         atol=1e-5 * scale)
    if not (torch.isfinite(got).all() and err <= 1e-5 * scale):
        fail(f"conv3_packed gradient through the kernels: {err} over {1e-5 * scale}")
    return counts


def phase_augment(args) -> dict:
    """Phase 1c: ``augment_batch_3d`` on a batch of 2 raw cases of CASE^3 to
    PATCH^3. The card's draw is applied on the card and, moved, on the CPU:
    the image within 1e-5 + 1e-5 |ref|, the labels equal on >= 99.99 % of
    the voxels (a soft value at 0.5 may round across). Timed with its draw
    by device time and by CUDA events (host gaps included), beside the host
    pipeline (RandomCrop3D, PETandCTNormalize, the scipy affine, flip and
    one-hot) on one sample."""
    raw = [synthetic_volume(args.seed + i, args.case) for i in range(2)]
    image = torch.from_numpy(np.stack([np.moveaxis(v, 0, -1) for v in raw]))
    label = torch.from_numpy(np.stack([sphere(args.case)] * 2))
    patch = (args.patch,) * 3
    img_c, lab_c = image.cuda(), label.cuda()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    draw = augment_device.draw_batch_3d(gen, img_c.shape, patch)
    got_i, got_l = augment_device.apply_batch_3d(img_c, lab_c, draw, N_CLS)
    t0 = time.perf_counter()
    ref_i, ref_l = augment_device.apply_batch_3d(image, label, draw.to("cpu"), N_CLS)
    cpu_s = time.perf_counter() - t0
    abs_err, rel_err, worst = max_err(got_i.cpu(), ref_i, 1e-5, 1e-5)
    agree = float((got_l.argmax(-1).cpu() == ref_l.argmax(-1)).float().mean())

    def augment():
        return augment_device.augment_batch_3d(gen, img_c, lab_c, patch, num_classes=N_CLS)

    host = Compose([RandomCrop3D(patch), PETandCTNormalize(),
                    RandomTranslationRotationZoom3D(mode="tr", num_class=N_CLS),
                    RandomFlip3D(mode="hv"), ToOneHot(num_class=N_CLS, input_channel=2)])
    t0 = time.perf_counter()
    host({"image": raw[0].copy(), "label": sphere(args.case)}, np.random.default_rng(args.seed))
    host_s = time.perf_counter() - t0
    rec = dict(batch=2, case=args.case, patch=args.patch, image_max_abs_err=abs_err,
               image_max_rel_err=rel_err, image_worst_vs_bar=worst, bar="1e-5 + 1e-5 |ref|",
               label_agreement=agree, label_bar=0.9999, device_ms=device_ms(augment, 10),
               event_ms=cuda_ms(augment, 5, 3), cpu_apply_s=cpu_s,
               host_pipeline_s_per_sample=host_s, translation=draw.affine.translation.tolist(),
               angle=draw.affine.angle.tolist(), origins=draw.origins.tolist(),
               flips=draw.flips.tolist())
    emit("augment", **rec)
    if not (worst <= 1.0 and agree >= 0.9999 and bool(torch.isfinite(got_i).all())
            and tuple(got_i.shape) == (2,) + patch + (2,)):
        fail(f"augmentation on the card vs the CPU: {rec}")
    del img_c, lab_c, got_i, got_l
    torch.cuda.empty_cache()
    return rec


def build_models(args):
    nets = [
        get_net("HDenseFormer_32", 2, N_CLS, (PATCH,) * 3, transformer_depth=args.depth,
                dtype=torch.bfloat16, use_kernels=use, device="cuda")
        for use in (True, False)
    ]
    init_weights(nets[0], torch.Generator().manual_seed(args.seed))
    nets[1].load_state_dict(nets[0].state_dict())
    return nets


def hdf_expect(args, train: bool = False) -> dict:
    """Launches of one HDenseFormer_32 forward (or train step) at full width."""
    return {"dense_attention": 2 * args.depth, "instance_norm_relu": 18, "shift_pack": 0,
            "shift_pack_backward": 0, "instance_norm_relu_backward": 18 if train else 0}


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


def sphere(size: int) -> np.ndarray:
    """The (size,)^3 mask of a centred sphere of radius 0.15 size: the tumour."""
    grid = np.indices((size,) * 3, dtype=np.float32) - size / 2
    return (np.sqrt((grid ** 2).sum(0)) < size * 0.15).astype(np.float32)


def synthetic_volume(seed: int, size: int = VOLUME) -> np.ndarray:
    """A (2, size, size, size) CT+PET volume: noise around a bright sphere."""
    rng = np.random.default_rng(seed)
    shape = (size,) * 3
    ball = sphere(size)
    ct = rng.normal(0.0, 200.0, shape).astype(np.float32) + 300.0 * ball
    pet = rng.gamma(2.0, 1.0, shape).astype(np.float32) + 8.0 * ball
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


def synthetic_case(seed: int, size: int) -> dict:
    """A training batch of one synthetic CT+PET case on the card: the
    normalised (1, size^3, 2) image and the one-hot label of its sphere."""
    image = PETandCTNormalize()({"image": synthetic_volume(seed, size)})["image"]
    label = np.eye(N_CLS, dtype=np.float32)[sphere(size).astype(np.int64)]
    return {"image": torch.from_numpy(np.moveaxis(image, 0, -1)[None].copy()).cuda(),
            "label": torch.from_numpy(label[None]).cuda()}


def train_one_step(net, batch, seed: int) -> dict:
    """One train step of ``net`` on ``batch`` (bench.py's optimizer and loss,
    dropout drawn from ``seed``): loss, counts, and the model's gradients
    and parameters after the step."""
    opt = get_optimizer("Adam", LR, weight_decay=WEIGHT_DECAY, params=net.parameters())
    step = make_train_step(get_loss("FocalLoss", use_ds=True), N_CLS)
    reset_counts()
    _, out = step(TrainState(net, opt), batch, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return dict(loss=float(out["loss"]), counts=read_counts(),
                grads={n: p.grad for n, p in net.named_parameters()},
                params={n: p.detach() for n, p in net.named_parameters()})


def grad_errors(run, ref) -> dict:
    """Per tensor max|d grad| / max|g_ref|; and max|d param| after the step."""
    return {n: (float((g - ref["grads"][n]).abs().max()) / max(
        float(ref["grads"][n].abs().max()), 1e-30),
        float((run["params"][n] - ref["params"][n]).abs().max())) for n, g in run["grads"].items()}


def phase_train_compare(args) -> dict:
    """One train step at 64^3, depth 4, through the kernels and through the
    plain versions, same weights and dropout seed; fp32 (TF32 off) and bf16.

    Bars. The gradients of a ReLU network differ between two correct
    implementations wherever rounding moves an activation across zero, and
    a flipped mask weighs much on the small deep grids. So the plain path
    also runs on the input moved by one rounding step (1e-6 relative in
    fp32; 2^-8, one bf16 step, in bf16), and each bar holds the kernel path
    to 3x that run's own difference from the plain path:
    - per tensor max|d|/max|g_plain|, the worst and the median over the
      tensors that have a gradient (all but ZERO_GRADIENT);
    - Adam's first update is lr against the sign of the gradient, so a
      parameter moves 2 lr away from the plain path's where the sign
      flipped: the count of flipped updates (and none beyond 2 lr).
    The ZERO_GRADIENT biases' max|g| (rounding noise) within 10x the larger
    of the plain and moved runs'. Every gradient exists and is finite
    (kernel outputs without a grad_fn would leave none upstream of a norm
    or an attention). The loss within 1e-5 (fp32) or 1e-3 (bf16), relative.
    """
    size, depth = 64, 4
    batch = synthetic_case(args.seed, size)
    out = {}
    for dtype, moved in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -8)):
        nets = [
            get_net("HDenseFormer_32", 2, N_CLS, (size,) * 3, transformer_depth=depth,
                    dtype=None if dtype == torch.float32 else dtype, use_kernels=use,
                    remat=False, device="cuda")
            for use in (True, False, False)
        ]
        init_weights(nets[0], torch.Generator().manual_seed(args.seed))
        for net in nets[1:]:
            net.load_state_dict(nets[0].state_dict())
        g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        nudged = dict(batch, image=batch["image"] * (
            1 + moved * torch.randn(batch["image"].shape, generator=g, device="cuda")))
        kern, plain, noise = (train_one_step(net, b, args.seed)
                              for net, b in zip(nets, (batch, batch, nudged)))
        expect = dict(hdf_expect(argparse.Namespace(depth=depth), train=True))
        if kern["counts"] != expect or any(plain["counts"].values()):
            fail(f"train step launched {kern['counts']} (plain {plain['counts']}), "
                 f"expected {expect}")
        missing = [n for n, gr in kern["grads"].items()
                   if gr is None or not bool(torch.isfinite(gr).all())]
        if missing:
            fail(f"kernel path: no or non-finite gradient for {missing[:5]}")
        if not set(ZERO_GRADIENT) <= set(kern["grads"]):
            fail(f"train step: no tensor named {set(ZERO_GRADIENT) - set(kern['grads'])}")
        errs, noise_errs = grad_errors(kern, plain), grad_errors(noise, plain)
        live = [n for n in errs if n not in ZERO_GRADIENT]
        worst = max(live, key=lambda n: errs[n][0])
        ratios = sorted(errs[n][0] for n in live)
        noise_ratios = sorted(noise_errs[n][0] for n in live)
        top = max(float(gr.abs().max()) for gr in plain["grads"].values())
        zero_grad = {key: max(float(run["grads"][n].abs().max()) for n in ZERO_GRADIENT) / top
                     for key, run in (("kernels", kern), ("plain", plain), ("moved", noise))}
        flipped = sum(int(((kern["params"][n] - plain["params"][n]).abs() > LR).sum())
                      for n in errs)
        noise_flipped = sum(int(((noise["params"][n] - plain["params"][n]).abs() > LR).sum())
                            for n in errs)
        n_params = sum(p.numel() for p in kern["params"].values())
        rec = dict(
            size=size, depth=depth, dtype=str(dtype).replace("torch.", ""),
            launches=kern["counts"], loss=kern["loss"], plain_loss=plain["loss"],
            moved_loss=noise["loss"], loss_rel=abs(kern["loss"] - plain["loss"]) / plain["loss"],
            worst_tensor=worst, worst_grad_ratio=errs[worst][0],
            its_moved_grad_ratio=noise_errs[worst][0],
            moved_worst_grad_ratio=noise_ratios[-1],
            median_grad_ratio=ratios[len(ratios) // 2],
            moved_median_grad_ratio=noise_ratios[len(noise_ratios) // 2],
            zero_gradient_max_rel=zero_grad,
            max_param_diff=max(e[1] for e in errs.values()), flipped_updates=flipped,
            moved_flipped_updates=noise_flipped, params=n_params,
            bars=dict(loss_rel=1e-5 if dtype == torch.float32 else 1e-3, vs_moved=3.0,
                      zero_gradient_vs_plain=10.0, max_param_diff=2 * LR))
        emit("train_kernels_vs_plain", **rec)
        if not (rec["loss_rel"] <= rec["bars"]["loss_rel"]
                and rec["worst_grad_ratio"] <= 3 * rec["moved_worst_grad_ratio"]
                and rec["median_grad_ratio"] <= 3 * rec["moved_median_grad_ratio"]
                and flipped <= 3 * noise_flipped
                and zero_grad["kernels"] <= 10 * max(zero_grad["plain"], zero_grad["moved"])
                and rec["max_param_diff"] <= 2 * LR * (1 + 1e-3)):
            fail(f"train step, kernels vs plain path, {dtype}: {rec}")
        out[rec["dtype"]] = rec
        del nets, kern, plain, noise
        torch.cuda.empty_cache()
    return out


def phase_train(args) -> dict:
    """The full-width train step of bench.py, built and timed by
    ``hdenseformer_tpu_torch.bench`` (its protocol, its zero input)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, batch, gen = bench.build("cuda", PATCH, args.depth, args.seed)
    reset_counts()
    timed = bench.time_steps(state, step, batch, gen, TRAIN_STEPS, TRAIN_WINDOWS)
    counts = read_counts()
    steps = 1 + TRAIN_WINDOWS * TRAIN_STEPS
    expect = hdf_expect(args, train=True)
    if any(counts[k] != v * steps for k, v in expect.items()):
        fail(f"the {steps} steps launched {counts}, not {steps} x {expect}")
    windows = [t * 1e3 / TRAIN_STEPS for t in timed["rep_window_s"]]
    best = min(windows)
    out = timed["metrics"]
    rec = dict(patch=PATCH, batch=bench.BATCH, depth=args.depth, dtype="bfloat16", dropout=0.5,
               input="bench.py's: zero image, background label",
               first_step_ms=timed["first_call_s"] * 1e3, first_loss=timed["first_loss"],
               window_ms_per_step=windows, window_losses=timed["window_losses"],
               ms_per_step=best, patches_128_per_s=PATCH_EQUIV / (best / 1e3),
               window_spread=max(windows) / best,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches_per_step=expect, launches_in_run=counts, steps=state.step,
               dice=float(out["dice"]), cm=out["cm"].tolist())
    emit("train", **rec)
    emit("bench", **bench.result_line(timed["best_window_s"], TRAIN_STEPS, PATCH))
    losses = timed["window_losses"]
    if not all(np.isfinite([timed["first_loss"]] + losses)) or not losses[-1] < timed["first_loss"]:
        fail(f"train losses {timed['first_loss']} -> {losses}: not finite and falling")
    del state, batch
    torch.cuda.empty_cache()
    return expect


def phase_remat_compare(args) -> None:
    """One step with remat on and off: HDenseFormer_32 at 64^3, depth 4, fp32
    through the kernels, cuDNN deterministic, one dropout seed. The loss must
    be equal, every gradient within 1e-5 of its tensor's max (the trilinear
    upsampling's backward adds with atomics; the ZERO_GRADIENT biases, whose
    gradient is noise, within 1e-5 of the model's largest) and the generator
    end in the same state (the recompute drew the forward's masks)."""
    size, depth = 64, 4
    batch = synthetic_case(args.seed, size)
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for remat in (False, True):
            net = get_net("HDenseFormer_32", 2, N_CLS, (size,) * 3, transformer_depth=depth,
                          remat=remat, device="cuda").train()
            init_weights(net, torch.Generator().manual_seed(args.seed))
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
            reset_counts()
            loss = get_loss("FocalLoss", use_ds=True)(net(batch["image"], generator=gen),
                                                      batch["label"])
            loss.backward()
            torch.cuda.synchronize()
            runs[remat] = dict(loss=float(loss.detach()), counts=read_counts(),
                               state=gen.get_state(),
                               grads={n: p.grad for n, p in net.named_parameters()})
            del net, loss
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    off, on = runs[False], runs[True]
    # the ZERO_GRADIENT biases' gradients are rounding noise: held by size,
    # against the largest gradient of the model
    top = max(float(g.abs().max()) for g in off["grads"].values())
    ratios = {n: float((on["grads"][n] - g).abs().max()) / (
        top if n in ZERO_GRADIENT else max(float(g.abs().max()), 1e-30))
        for n, g in off["grads"].items()}
    worst = max(ratios, key=ratios.get)
    rec = dict(size=size, depth=depth, dtype="float32", loss_remat=on["loss"],
               loss_plain=off["loss"], generator_state_equal=bool(torch.equal(on["state"],
                                                                              off["state"])),
               worst_tensor=worst, worst_grad_ratio=ratios[worst], bar=1e-5,
               zero_gradient_max_vs_top=max(ratios[n] for n in ZERO_GRADIENT),
               launches_remat=on["counts"], launches_plain=off["counts"])
    emit("remat_vs_plain", **rec)
    expect_on = dict(hdf_expect(argparse.Namespace(depth=depth), train=True),
                     dense_attention=4 * depth, instance_norm_relu=36)
    if on["counts"] != expect_on or off["counts"] != hdf_expect(
            argparse.Namespace(depth=depth), train=True):
        fail(f"remat step launched {on['counts']}, plain {off['counts']}")
    if not (on["loss"] == off["loss"] and rec["generator_state_equal"]
            and ratios[worst] <= 1e-5):
        fail(f"remat vs plain step: {rec}")
    del runs, off, on
    torch.cuda.empty_cache()


def phase_unetr_norms(gen) -> dict:
    """UNETR's InstanceNorm shapes at batch 2 (bf16, affine, ReLU off): the
    forward kernel against its plain version (phase 1's bf16 bar) and the
    backward kernel against its plain version (phase 1b's bars), each shape
    timed and summed over one UNETR forward and one train step."""
    per = dict(fwd_ms=0.0, fwd_plain_ms=0.0, fwd_bound_ms=0.0, bwd_ms=0.0, bwd_plain_ms=0.0,
               bwd_bound_ms=0.0)
    for (s, c), count in IN_UNETR:
        x, dy, scale, bias = norm_bwd_inputs(gen, (ZOO_BATCH, s, c), torch.bfloat16, True)
        got = instance_norm_relu(x, scale, bias, relu=False)
        plain = instance_norm_relu_ref(x, scale, bias, relu=False)
        torch.cuda.synchronize()
        abs_e, _, over = max_err(got, plain, BF16_STEP, 1e-6)
        if not over <= 1.0:
            fail(f"instance_norm_relu (2, {s}, {c}) ReLU off: {abs_e} over tolerance")
        vs_plain = norm_bwd_compare(x, dy, scale, bias, False, f"(2, {s}, {c}) ReLU off")
        fwd = instance_norm_times(x, scale, bias, library=False, relu=False)
        bwd = norm_backward_times(x, dy, scale, bias, False, library=False)
        emit("instance_norm_unetr_shape", shape=[ZOO_BATCH, s, c], dtype="bfloat16", relu=False,
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


def zoo_expect(name: str, train: bool) -> dict:
    """Launches of one zoo forward (or train step): UNETR's InstanceNorms
    (one backward each in a step), none for the others."""
    expect = dict.fromkeys(KERNELS, 0)
    if name == "unetr":
        norms = sum(n for _, n in IN_UNETR)
        expect.update(instance_norm_relu=norms,
                      instance_norm_relu_backward=norms if train else 0)
    return expect


def buffers_of(net) -> dict:
    return {n: b.detach().clone() for n, b in net.named_buffers()}


def phase_zoo(args, gen) -> dict:
    """Each model of the 3-D zoo at the Hecktor21 preset (144^3, bf16, full
    width): an eval forward of 2 windows and ZOO_STEPS train steps at batch
    2 (FocalLoss, Adam with coupled L2 1e-4, lr 1e-3, dropout from a seeded
    generator): finite loss, ms a step, peak memory, parameters, launches
    against the model's count; a BatchNorm model's running statistics must
    not move in the eval forward and must move in the step. UNETR's eval
    forward also runs through the plain versions from the same weights
    (phase 2's bars). Returns UNETR's launches (its forward and steps)."""
    t0 = time.perf_counter()
    case = synthetic_case(args.seed, PATCH)
    batch = {k: v.repeat(ZOO_BATCH, 1, 1, 1, 1) for k, v in case.items()}
    x = torch.randn((ZOO_BATCH, PATCH, PATCH, PATCH, 2), generator=gen, device="cuda")
    unetr_counts = dict.fromkeys(KERNELS, 0)
    for name in ZOO:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = get_net(name, 2, N_CLS, (PATCH,) * 3, dtype=torch.bfloat16, device="cuda")
        init_weights(net, torch.Generator().manual_seed(args.seed))
        fresh = buffers_of(net)
        with torch.inference_mode():
            reset_counts()
            logits, first_ms = timed_forward(net, x)
            fwd_counts = read_counts()
            _, warm_ms = timed_forward(net, x)
        rec = dict(net=name, params=sum(p.numel() for p in net.parameters()),
                   batch_norm_buffers=len(fresh), eval_first_ms=first_ms, eval_warm_ms=warm_ms,
                   launches_forward=fwd_counts)
        if name in ("TransBTS", "unetr"):
            # layers.self_attention: SDPA would draw its dropout from the global RNG
            rec["attention"] = "plain math, fp32 scores (layers.self_attention)"
        if name == "unetr":
            plain = get_net(name, 2, N_CLS, (PATCH,) * 3, dtype=torch.bfloat16,
                            use_kernels=False, device="cuda")
            plain.load_state_dict(net.state_dict())
            with torch.inference_mode():
                reset_counts()
                ref = plain(x)
                rec["launches_plain_forward"] = read_counts()
            rec["kernels_vs_plain"] = compare_logits(logits, ref)
            del plain, ref
        if logits.shape != x.shape[:-1] + (N_CLS,) or logits.dtype != torch.float32 or not bool(
                torch.isfinite(logits).all()):
            fail(f"{name} eval logits {tuple(logits.shape)} {logits.dtype}, or not finite")
        if any(not torch.equal(b, fresh[n]) for n, b in net.named_buffers()):
            fail(f"{name}'s eval forward moved its running statistics")
        del logits
        opt = get_optimizer("Adam", LR, weight_decay=WEIGHT_DECAY, params=net.parameters())
        state = TrainState(net, opt)
        step = make_train_step(get_loss("FocalLoss", use_ds=False), N_CLS)
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        steps = []
        for _ in range(ZOO_STEPS):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, out = step(state, batch, g)
            loss = float(out["loss"])
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss,
                              launches=read_counts()))
        moved = [n for n, b in net.named_buffers() if not torch.equal(b, fresh[n])]
        rec.update(step_ms=[st["ms"] for st in steps], losses=[st["loss"] for st in steps],
                   launches_step=steps[-1]["launches"], statistics_moved=len(moved),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit("zoo", **rec)
        if fwd_counts != zoo_expect(name, False) or any(
                st["launches"] != zoo_expect(name, True) for st in steps):
            fail(f"{name} launched {fwd_counts} a forward and {[st['launches'] for st in steps]} "
                 f"a step, expected {zoo_expect(name, False)} and {zoo_expect(name, True)}")
        if not all(np.isfinite(rec["losses"])):
            fail(f"{name} train losses {rec['losses']}")
        if len(moved) != len(fresh):
            fail(f"{name}: {len(fresh) - len(moved)} running statistics did not move in training")
        if name == "unetr":
            cmp = rec["kernels_vs_plain"]
            if any(rec["launches_plain_forward"].values()) or cmp["argmax_agreement"] < 0.99 or (
                    cmp["argmax_agreement_margin_gt_0p1"] < 0.999):
                fail(f"UNETR kernels vs plain path: {cmp}, plain launched "
                     f"{rec['launches_plain_forward']}")
            for counts in [fwd_counts] + [st["launches"] for st in steps]:
                for k, v in counts.items():
                    unetr_counts[k] += v
        del net, opt, state, step
    emit("zoo_phase", seconds=time.perf_counter() - t0)
    del batch, x
    torch.cuda.empty_cache()
    return unetr_counts


def phase_zoo_journey(args, work: str, case_format: str, device: str = "cuda") -> dict:
    """da_unet through the trainer at the Hecktor21 preset: one epoch of fold
    1 of 3 on phase 5's cases, ``-m inf-sw`` of one 200^3 volume, ``-m
    eval``. The checkpoint's running statistics must have moved off (0, 1),
    and inf-sw's labels must be ``predict_volume``'s under them in eval
    mode. da_unet launches no kernel of the port."""
    t0 = time.perf_counter()
    run = TrainerRun(args, case_format, device)
    names = [f"p{i}_{s}" for i in range(3) for s in "ab"]
    paths = write_cases(os.path.join(work, "cases"), names, args.case, args.seed, case_format)
    tests = write_cases(os.path.join(work, "test"), ["t0_a"], args.volume, args.seed + 100,
                        case_format)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cfg = run.config("da_unet", 1, version="smoke-zoo-")
        reset_counts()
        run.train(cfg, paths)
        ckpt = get_weight_path(os.path.join(cfg.output_dir, "fold1"))
        stats = {k: v for k, v in load_checkpoint(ckpt)["model"].items()
                 if k.endswith((".mean", ".var"))}
        fresh = sum(bool(torch.all(v == (0.0 if k.endswith(".mean") else 1.0)))
                    for k, v in stats.items())
        save = os.path.join("seg", cfg.version)
        run.infer(cfg, tests, ckpt, save)
        counts = read_counts()
        labels = np.load(os.path.join(save, os.path.basename(tests[0]).split(".")[0] + ".npy"))
        net = get_net("da_unet", 2, N_CLS, (PATCH,) * 3, dtype=torch.bfloat16, device=device)
        net.load_state_dict(load_checkpoint(ckpt)["model"])
        volume = (npy_reader(tests[0], "ct") if case_format == "npy"
                  else hdf5_reader(tests[0], "ct"))
        image = PETandCTNormalize()({"image": volume})["image"]
        want = predict_volume(net.eval(), image, (PATCH,) * 3, (STEP,) * 3, N_CLS,
                              window_batch=WINDOWS)
        rows = run.evaluate(cfg, tests, save)
        epochs = epoch_records(cfg)
    finally:
        os.chdir(cwd)
    rec = dict(net="da_unet", case_format=case_format, epochs=epochs, checkpoint_statistics=len(
        stats), statistics_left_at_init=fresh, label_shape=list(labels.shape),
        labels_vs_predict_volume=float((labels == want).mean()), eval_rows=rows,
        launches=counts, seconds=time.perf_counter() - t0)
    emit("zoo_journey", **rec)
    if any(counts.values()):
        fail(f"the da_unet journey launched {counts}; da_unet has no kernel of the port")
    if not stats or fresh:
        fail(f"{fresh} of the checkpoint's {len(stats)} running statistics are still (0, 1)")
    if labels.shape != (args.volume,) * 3 or rec["labels_vs_predict_volume"] < 0.999:
        fail(f"inf-sw labels {labels.shape}, {rec['labels_vs_predict_volume']} equal to "
             "predict_volume under the checkpoint")
    if len(rows) != 1 or len(epochs) != 1 or not np.isfinite(epochs[0]["train_loss"]):
        fail(f"the da_unet journey: epochs {epochs}, eval rows {rows}")
    return counts


def hdf2d_expect(args, train: bool = False) -> dict:
    """Launches of one HDenseFormer_2D_32 forward at PI-CAI22 (3 modality
    paths of depth attentions, 18 InstanceNorms), or of one train step with
    get_net's remat: the forward and its recompute, a backward per norm."""
    n = 2 if train else 1
    return {"dense_attention": n * SLICE_CH * args.depth, "instance_norm_relu": n * 18,
            "shift_pack": 0, "shift_pack_backward": 0,
            "instance_norm_relu_backward": 18 if train else 0}


def phase_2d_kernels(args, gen) -> dict:
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
    b, h, n, d = ATTN_2D
    rec["bound_ms"], rec["bound_by"] = bound(4 * q.numel() * q.element_size(),
                                             4 * b * h * n * n * d, torch.bfloat16)
    rec["ms"] = device_ms(lambda: dense_attention(q, k, v), iters=50)
    rec["plain_ms"] = device_ms(lambda: attention_ref(q, k, v), iters=20)
    rec["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
    forward = hdf2d_expect(args)
    rec["launches_per_forward"] = forward["dense_attention"]
    rec["per_forward_ms"] = rec["ms"] * forward["dense_attention"]
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
    if launches != forward["instance_norm_relu"]:
        fail(f"IN_2D holds {launches} norms, the model's forward {forward['instance_norm_relu']}")
    emit("instance_norm_per_2d_step", launches_forward=launches, launches_backward=launches,
         per_forward=fwd_sum, per_train_step_forward={k: 2 * v for k, v in fwd_sum.items()},
         per_train_step_backward=bwd_sum)
    out["instance_norm_relu"].update({f"per_forward_{k}": v for k, v in fwd_sum.items()})
    out["instance_norm_relu_backward"].update({f"per_step_{k}": v for k, v in bwd_sum.items()})
    return out


def mr_slices(seed: int, shape) -> tuple:
    """Raw synthetic MR slices (SLICE_CH, *shape) with (h, w) the last two
    dims: gamma noise around a bright centred disc of radius 0.15 h, and the
    disc's (uint8) label of ``shape``."""
    h, w = shape[-2:]
    grid = np.indices((h, w), dtype=np.float32) - np.array([h, w], np.float32)[:, None, None] / 2
    label = np.broadcast_to(np.sqrt((grid ** 2).sum(0)) < 0.15 * h, shape).astype(np.uint8)
    image = np.random.default_rng(seed).gamma(2.0, 40.0, (SLICE_CH,) + tuple(shape))
    return (image + 200.0 * label).astype(np.float32), label


def synthetic_slices(seed: int, n: int) -> dict:
    """A batch of ``n`` synthetic MR slices of SLICE^2 on the card, scaled to
    [0, 1] per slice as MRNormalize scales them, and their one-hot labels."""
    image, label = mr_slices(seed, (n, SLICE, SLICE))
    image = np.moveaxis(image, 0, -1)
    image /= image.max(axis=(1, 2, 3), keepdims=True)
    return {"image": torch.from_numpy(np.ascontiguousarray(image)).cuda(),
            "label": torch.from_numpy(np.eye(N_CLS, dtype=np.float32)[label]).cuda()}


def phase_2d_hdenseformer(args, gen) -> dict:
    """HDenseFormer_2D_32 at PI-CAI22 (get_net's remat on): an eval forward
    of 24 slices through the kernels and through the plain versions (phase
    2's bars), then 2 train steps (FocalLoss deep supervision, Adam with
    coupled L2 1e-4): ms a step, peak memory, launches against the model's
    count. Returns the launches by path."""
    nets = [get_net("HDenseFormer_2D_32", SLICE_CH, N_CLS, (SLICE, SLICE),
                    transformer_depth=args.depth, dtype=torch.bfloat16, use_kernels=use,
                    device="cuda") for use in (True, False)]
    init_weights(nets[0], torch.Generator().manual_seed(args.seed))
    nets[1].load_state_dict(nets[0].state_dict())
    batch = synthetic_slices(args.seed, SLICE_BATCH)
    expect = hdf2d_expect(args)
    moved = batch["image"] * (1 + 2.0 ** -8 * torch.randn(batch["image"].shape, generator=gen,
                                                         device="cuda"))
    with torch.inference_mode():
        reset_counts()
        outs, first_ms = timed_forward(nets[0], batch["image"])
        counts = read_counts()
        outs, warm_ms = timed_forward(nets[0], batch["image"])
        reset_counts()
        ref, plain_ms = timed_forward(nets[1], batch["image"])
        plain_counts = read_counts()
        ref_moved = nets[1](moved)
    shapes = [list(o.shape) for o in outs]
    want = [[SLICE_BATCH, SLICE // 2 ** i, SLICE // 2 ** i, N_CLS] for i in range(4)]
    if shapes != want or any(o.dtype != torch.float32 for o in outs) or not all(
            bool(torch.isfinite(o).all()) for o in outs + ref):
        fail(f"HDenseFormer_2D forward outputs {shapes}, expected finite fp32 {want}")
    if counts != expect or any(plain_counts.values()):
        fail(f"HDenseFormer_2D forward launched {counts} (plain {plain_counts}), expected {expect}")
    cmp, own = compare_logits(outs[0], ref[0]), compare_logits(ref_moved[0], ref[0])
    emit("hdenseformer_2d_forward", shape=list(batch["image"].shape), dtype="bfloat16",
         depth=args.depth, launches=counts, first_ms=first_ms, warm_ms=warm_ms,
         plain_ms=plain_ms, slices_per_s=SLICE_BATCH / (warm_ms / 1e3), kernels_vs_plain=cmp,
         plain_vs_plain_on_moved_input=own)
    # Bars: where the plain top-two margin exceeds 0.1, phase 2's 99.9 %; over
    # all pixels, at most 3x the disagreement of the plain path with itself on
    # the input moved by one bf16 step (phase 4's method): random weights
    # leave a fifth of the 384^2 pixels within 0.1 of a tie, where bf16
    # rounding alone flips the argmax
    if cmp["argmax_agreement_margin_gt_0p1"] < 0.999 or (
            1 - cmp["argmax_agreement"] > 3 * (1 - own["argmax_agreement"])):
        fail(f"HDenseFormer_2D kernels vs plain path: {cmp}; plain vs itself on the moved "
             f"input: {own}")
    net = nets[0]
    del nets, outs, ref, ref_moved, moved
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState(net, get_optimizer("Adam", LR, weight_decay=WEIGHT_DECAY,
                                          params=net.parameters()))
    step = make_train_step(get_loss("FocalLoss", use_ds=True), N_CLS)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    train_expect, steps = hdf2d_expect(args, train=True), []
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, out = step(state, batch, g)
        loss = float(out["loss"])
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss, launches=read_counts()))
    emit("hdenseformer_2d_train", batch=SLICE_BATCH, remat=net.remat, step_ms=[
        st["ms"] for st in steps], losses=[st["loss"] for st in steps],
        launches_per_step=steps[-1]["launches"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if any(st["launches"] != train_expect for st in steps) or not all(
            np.isfinite(st["loss"]) for st in steps):
        fail(f"HDenseFormer_2D steps: {steps}, expected {train_expect} launches a step")
    del state, step, net, batch
    torch.cuda.empty_cache()
    return {"2d-serve": counts,
            "2d-train": {k: sum(st["launches"][k] for st in steps) for k in KERNELS}}


def phase_2d_zoo(args) -> None:
    """Each smp-style baseline (unet, unet++, deeplabv3+ on resnet18 and
    resnet50) at PI-CAI22, bf16, batch 24: an eval forward (masks and the
    aux head's (24, 1) logits, running statistics unmoved) and 2 train
    steps (FocalLoss, Adam with coupled L2 1e-4; losses finite, every
    running statistic moved). They launch no kernel of the port."""
    t0 = time.perf_counter()
    batch = synthetic_slices(args.seed, SLICE_BATCH)
    for name, encoder in SMP_2D:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = get_net(name, SLICE_CH, N_CLS, (SLICE, SLICE), encoder_name=encoder,
                      dtype=torch.bfloat16, device="cuda")
        init_weights(net, torch.Generator().manual_seed(args.seed))
        fresh = buffers_of(net)
        with torch.inference_mode():
            reset_counts()
            (masks, labels), first_ms = timed_forward(net, batch["image"])
            fwd_counts = read_counts()
            _, warm_ms = timed_forward(net, batch["image"])
        if (tuple(masks.shape) != (SLICE_BATCH, SLICE, SLICE, N_CLS)
                or tuple(labels.shape) != (SLICE_BATCH, N_CLS - 1)
                or masks.dtype != torch.float32
                or not bool(torch.isfinite(masks).all() and torch.isfinite(labels).all())):
            fail(f"{name}/{encoder} eval outputs {tuple(masks.shape)} {tuple(labels.shape)}")
        if any(not torch.equal(b, fresh[n]) for n, b in net.named_buffers()):
            fail(f"{name}/{encoder}'s eval forward moved its running statistics")
        del masks, labels
        state = TrainState(net, get_optimizer("Adam", LR, weight_decay=WEIGHT_DECAY,
                                              params=net.parameters()))
        step = make_train_step(get_loss("FocalLoss", use_ds=False), N_CLS)
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        steps = []
        for _ in range(SMP_2D_STEPS):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, out = step(state, batch, g)
            loss = float(out["loss"])
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss,
                              launches=read_counts()))
        moved = [n for n, b in net.named_buffers() if not torch.equal(b, fresh[n])]
        emit("zoo_2d", net=name, encoder=encoder, params=sum(p.numel() for p in net.parameters()),
             batch_norm_buffers=len(fresh), eval_first_ms=first_ms, eval_warm_ms=warm_ms,
             step_ms=[st["ms"] for st in steps], losses=[st["loss"] for st in steps],
             statistics_moved=len(moved), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_forward=fwd_counts, launches_step=steps[-1]["launches"])
        if any(fwd_counts.values()) or any(any(st["launches"].values()) for st in steps):
            fail(f"{name}/{encoder} launched a kernel of the port")
        if not all(np.isfinite(st["loss"]) for st in steps) or len(moved) != len(fresh):
            fail(f"{name}/{encoder}: losses {[st['loss'] for st in steps]}, "
                 f"{len(fresh) - len(moved)} running statistics unmoved")
        del net, state, step
    emit("zoo_2d_phase", seconds=time.perf_counter() - t0)
    del batch
    torch.cuda.empty_cache()


def write_slice_cases(root: str, n: int, seed: int) -> list:
    """``n`` synthetic 2-D slice cases (raw (3, SLICE, SLICE) image, (SLICE,
    SLICE) label) as ``.npy`` case directories; their paths."""
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        image, label = mr_slices(seed + i, (SLICE, SLICE))
        path = os.path.join(root, f"s{i:03d}")
        os.makedirs(path)
        np.save(os.path.join(path, "ct.npy"), image)
        np.save(os.path.join(path, "seg.npy"), label)
        paths.append(path)
    return paths


def phase_2d_journey(args, work: str) -> dict:
    """The 2-D journey at PI-CAI22: HDenseFormer_2D_32 trains one epoch of fold
    1 of 3 on JOURNEY_SLICES synthetic slice cases (``.npy`` directories, the
    trainer with the preset's host transforms 1, 6, 7, 10); then
    ``predict_case_2d`` of 2 synthetic volumes of 30 x 400^2 (chunks of 24
    and 6, each slice resized to 384^2 and the labels back to 400^2): seconds
    a volume, slices/s, and labels equal to a direct argmax of the model's
    logits on the same preprocessed slices, resized back on the host; then
    dice and HD95 per volume. Returns the launches of the run."""
    from hdenseformer_tpu_torch.infer.slices import predict_case_2d, preprocess_slices

    t0 = time.perf_counter()
    paths = write_slice_cases(os.path.join(work, "slices"), JOURNEY_SLICES, args.seed)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cfg = get_config("PI-CAI22", net_name="HDenseFormer_2D_32", data_path="slices",
                         n_epoch=1, fold_num=3, current_fold=1, seed=args.seed,
                         transformer_depth=args.depth, version="smoke-2d")
        seg = NpySemanticSeg(**cfg.init_trainer_kwargs(), device="cuda")
        train, val = get_cross_validation_by_sample(paths, cfg.fold_num, cfg.current_fold,
                                                    shuffle_seed=cfg.seed)
        reset_counts()
        t = time.perf_counter()
        seg.trainer(train, val, 1, **cfg.setup_trainer_kwargs())
        train_s = time.perf_counter() - t
        train_counts = read_counts()
        epochs = epoch_records(cfg)
    finally:
        os.chdir(cwd)
    n_train = epochs[0]["train_steps"]
    n_val = -(-len(val) // cfg.batch_size)
    per_step = per_train_step(train_counts, n_train, n_val, hdf2d_expect(args))
    model = seg.state.model.eval()
    reset_counts()
    volumes, rows = [], []
    for i in range(2):
        image, gt = mr_slices(args.seed + 200 + i, JOURNEY_VOLUME)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred = predict_case_2d(model, image, (SLICE, SLICE), N_CLS, SLICE_CH,
                               slice_batch=SLICE_BATCH)
        torch.cuda.synchronize()
        volumes.append(time.perf_counter() - t)
        rows.append(dict(dice=multi_dice(gt, pred, 1)[1], hd95=multi_hd(gt, pred, 1)[1],
                         image=image, pred=pred))
    predict_counts = read_counts()
    # a direct argmax of the model's logits on the same slices, chunk by chunk
    direct_equal = []
    d, h, w = JOURNEY_VOLUME
    idx_h = np.minimum(np.floor(np.arange(h) * SLICE / h).astype(int), SLICE - 1)
    idx_w = np.minimum(np.floor(np.arange(w) * SLICE / w).astype(int), SLICE - 1)
    with torch.inference_mode():
        for row in rows:
            stack = preprocess_slices(row.pop("image"), (SLICE, SLICE), N_CLS, SLICE_CH)
            labels = np.concatenate([
                model(torch.from_numpy(stack[s:s + SLICE_BATCH]).cuda())[0].float()
                .argmax(-1).cpu().numpy() for s in range(0, d, SLICE_BATCH)])
            direct = labels[:, idx_h[:, None], idx_w[None, :]].astype(np.uint8)
            direct_equal.append(bool(np.array_equal(direct, row.pop("pred"))))
    chunks = -(-d // SLICE_BATCH)
    want = {k: 2 * chunks * v for k, v in hdf2d_expect(args).items()}
    rec = dict(net="HDenseFormer_2D_32", case_format="npy", slices=JOURNEY_SLICES,
               train_cases=len(train), val_cases=len(val), epochs=epochs, train_s=train_s,
               launches_per_train_step=per_step, volume=[SLICE_CH, *JOURNEY_VOLUME],
               seconds_per_volume=volumes, slices_per_s=[d / s for s in volumes],
               launches_predict=predict_counts, labels_equal_direct_argmax=direct_equal,
               eval_rows=rows, seconds=time.perf_counter() - t0)
    emit("journey_2d", **rec)
    if per_step != hdf2d_expect(args, train=True):
        fail(f"the 2-D trainer launched {per_step} a step, expected {hdf2d_expect(args, True)}")
    if predict_counts != want or not all(direct_equal):
        fail(f"predict_case_2d launched {predict_counts} (expected {want}); labels equal to "
             f"the direct argmax: {direct_equal}")
    if not np.isfinite(epochs[0]["train_loss"]) or len(rows) != 2:
        fail(f"the 2-D journey: epochs {epochs}, eval rows {rows}")
    return {k: train_counts[k] + predict_counts[k] for k in KERNELS}


def npy_reader(path: str, key: str) -> np.ndarray:
    """One volume of a case directory holding ``<key>.npy`` per key: this
    phase's case format on a machine without h5py."""
    f = os.path.join(path, key + ".npy")
    if not os.path.exists(f):
        raise KeyError(key)
    return np.load(f).astype(np.float32)


class NpySemanticSeg(SemanticSeg):
    reader = staticmethod(npy_reader)


def write_cases(root: str, names, size: int, seed: int, case_format: str) -> list:
    """Synthetic CT+PET cases (noise around a bright sphere, the sphere as
    label) as ``.hdf5`` files or ``.npy`` directories; their paths."""
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, name in enumerate(names):
        image, label = synthetic_volume(seed + i, size), sphere(size).astype(np.uint8)
        if case_format == "hdf5":
            path = os.path.join(root, name + ".hdf5")
            save_as_hdf5(image, path, "ct")
            save_as_hdf5(label, path, "seg")
        else:
            path = os.path.join(root, name)
            os.makedirs(path)
            np.save(os.path.join(path, "ct.npy"), image)
            np.save(os.path.join(path, "seg.npy"), label)
        paths.append(path)
    return paths


class TrainerRun:
    """The user's journey of the trainer phase in a work directory: through
    the CLI where cases are ``.hdf5``, else through ``SemanticSeg`` with the
    ``.npy`` reader (the same calls the CLI makes)."""

    def __init__(self, args, case_format: str, device: str = "cuda"):
        self.args, self.case_format, self.device = args, case_format, device
        self.seg_cls = SemanticSeg if case_format == "hdf5" else NpySemanticSeg

    def config(self, net: str, epochs: int, version: str = "smoke-"):
        return get_config("Hecktor21", net_name=net, data_path="cases", test_path="test",
                          n_epoch=epochs, fold_num=3, current_fold=1, seed=self.args.seed,
                          transformer_depth=self.args.depth, version=version + net,
                          input_shape=(self.args.patch,) * 3, patch_size=(self.args.patch,) * 3,
                          step_size=(self.args.patch // 2,) * 3)

    def cli_args(self, cfg) -> list:
        return ["--net", cfg.net_name, "--folds", "3", "--seed", str(cfg.seed),
                "--transformer-depth", str(cfg.transformer_depth), "--version", cfg.version,
                "--input-shape", *map(str, cfg.input_shape), "--step-size",
                *map(str, cfg.step_size), "--device", self.device]

    def split(self, cfg, paths):
        return get_cross_validation_by_sample(paths, cfg.fold_num, cfg.current_fold,
                                              shuffle_seed=cfg.seed)

    def train(self, cfg, paths) -> None:
        if self.case_format == "hdf5":
            cli.main(["-m", "train", "--data-path", cfg.data_path, "--fold", "1", "--epochs",
                      str(cfg.n_epoch)] + self.cli_args(cfg))
            return
        seg = self.seg_cls(**cfg.init_trainer_kwargs(), device=self.device)
        cli._report_params_flops(seg, cfg)
        train, val = self.split(cfg, paths)
        seg.trainer(train, val, 1, **cfg.setup_trainer_kwargs())

    def resume(self, cfg, paths, ckpt: str, epochs: int):
        seg = self.seg_cls(**dict(cfg.init_trainer_kwargs(), n_epoch=epochs, pre_trained=True,
                                  ckpt_point=True, weight_path=ckpt), device=self.device)
        train, val = self.split(cfg, paths)
        seg.trainer(train, val, 1, **cfg.setup_trainer_kwargs())
        return seg

    def infer(self, cfg, tests, ckpt: str, save: str) -> None:
        if self.case_format == "hdf5":
            cli.main(["-m", "inf-sw", "--test-path", cfg.test_path, "--save-path", save,
                      "--window-batch", str(WINDOWS)] + self.cli_args(cfg))
            return
        seg = self.seg_cls(**dict(cfg.init_trainer_kwargs(), weight_path=ckpt,
                                  pre_trained=True), device=self.device)
        seg.inference_slidingwindow(tests, save, window_batch=WINDOWS)

    def evaluate(self, cfg, tests, save: str) -> list:
        if self.case_format == "hdf5":
            return cli.main(["-m", "eval", "--test-path", cfg.test_path, "--save-path", save])
        rows = []
        for case in tests:
            gt = npy_reader(case, "seg")
            pred = np.load(os.path.join(save, os.path.basename(case) + ".npy"))
            rows.append(dict(case=os.path.basename(case), dice=multi_dice(gt, pred, 1)[1],
                             hd95=multi_hd(gt, pred, 1)[1]))
        return rows


def epoch_records(cfg) -> list:
    """Per-epoch scalars of the run's metrics.jsonl, in the order written (a
    resumed run appends its epochs)."""
    records = []
    with open(os.path.join(cfg.log_dir, f"fold{cfg.current_fold}", "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if not records or r["tag"] in records[-1][1]:
                records.append((r["step"], {}))
            records[-1][1][r["tag"]] = r["value"]
    out = []
    for epoch, v in records:
        tr_s, steps = v["time/train/seconds"], v["time/train/steps"]
        out.append(dict(epoch=epoch, train_loss=v["data/loss/train"],
                        val_loss=v["data/loss/val"], train_dice=v["data/dice/train"],
                        val_dice=v["data/dice/val"], lr=v["data/lr"],
                        wall_s=tr_s + v["time/val/seconds"], train_steps=int(steps),
                        step_s=tr_s / steps, loader_wait_share=v["time/train/loader_wait_seconds"]
                        / tr_s))
    return out


def per_train_step(counts: dict, n_train: int, n_forward: int, forward: dict) -> dict:
    """Launches of one train step: a run's counts less its ``n_forward``
    eval forwards, over its ``n_train`` steps; fails unless whole."""
    out = {}
    for name, total in counts.items():
        rest = total - n_forward * forward[name]
        if rest % n_train:
            fail(f"{name}: {total} launches are not {n_train} train steps and {n_forward} "
                 f"forwards of {forward[name]}")
        out[name] = rest // n_train
    return out


def phase_trainer(args, work: str, case_format: str, device: str = "cuda") -> dict:
    """The trainer journey at full width: train 2 epochs of fold 1 of 3, resume
    one more from the best checkpoint, sliding-window inference of two
    volumes, eval; then an epoch of Hecktor20Top1. Returns launches by path."""
    run = TrainerRun(args, case_format, device)
    names = [f"p{i}_{s}" for i in range(3) for s in "ab"]  # 3 patients x 2 cases
    paths = write_cases(os.path.join(work, "cases"), names, args.case, args.seed, case_format)
    tests = write_cases(os.path.join(work, "test"), ["t0_a", "t1_a"], args.volume,
                        args.seed + 100, case_format)
    cwd = os.getcwd()
    os.chdir(work)  # ./ckpt and ./log, as the CLI lays them out
    try:
        by_path, host = drive_trainer(args, run, paths, tests)
        by_path["trainer-device-augment"] = drive_device_augment(args, run, paths, host)
        return by_path
    finally:
        os.chdir(cwd)


def drive_trainer(args, run: TrainerRun, paths: list, tests: list) -> dict:
    on_card = run.device == "cuda"
    forward = hdf_expect(args)
    train_expect = dict(hdf_expect(args, train=True), dense_attention=4 * args.depth,
                        instance_norm_relu=36)  # remat: the forward kernels run twice
    cfg = run.config("HDenseFormer_32", TRAIN_EPOCHS)
    train, val = run.split(cfg, paths)
    n_train, n_val = -(-len(train) // cfg.batch_size), -(-len(val) // cfg.batch_size)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run.train(cfg, paths)
    train_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    # the startup report's forward, then an eval forward an epoch
    step = per_train_step(counts, TRAIN_EPOCHS * n_train, TRAIN_EPOCHS * n_val + 1,
                          forward) if on_card else None
    ckpt_dir = os.path.join(cfg.output_dir, "fold1")
    best = get_weight_path(ckpt_dir)
    best_epoch = int(os.path.basename(best).split("-")[0].split("=")[1])

    reset_counts()
    seg = run.resume(cfg, paths, best, best_epoch + 2)  # one epoch after the best
    resume_counts = read_counts()
    resume_step = per_train_step(resume_counts, n_train, n_val, forward) if on_card else None
    kept = sorted(os.listdir(ckpt_dir))
    epochs = epoch_records(cfg)
    for rec in epochs:
        emit("trainer_epoch", net=cfg.net_name, **rec)
    steady = [r["step_s"] for r in epochs[1:]]
    emit("trainer", net=cfg.net_name, case_format=run.case_format, cases=len(paths),
         case_size=args.case, patch=args.patch, batch=cfg.batch_size, depth=args.depth,
         remat=cfg.remat, dtype="bfloat16" if cfg.use_fp16 else "float32",
         lr_scheduler=cfg.lr_scheduler, loss=cfg.loss_fun, train_wall_s=train_s,
         steady_step_s=statistics.mean(steady) if steady else None,
         loader_wait_share=[r["loader_wait_share"] for r in epochs],
         peak_memory_bytes=peak, launches=counts, launches_per_train_step=step,
         resume_launches_per_train_step=resume_step, best_checkpoint_epoch=best_epoch,
         start_epoch_after_resume=seg.start_epoch, checkpoints_kept=len(kept))
    if on_card and (step != train_expect or resume_step != train_expect):
        fail(f"trainer step launched {step} (resumed {resume_step}), expected {train_expect}")
    if len(kept) > 3 or seg.start_epoch != best_epoch + 1 or len(epochs) != TRAIN_EPOCHS + 1:
        fail(f"checkpoints {kept}, start_epoch {seg.start_epoch}, epochs {epochs}")
    if not all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in epochs):
        fail(f"trainer losses are not finite: {epochs}")

    save = os.path.join("seg", cfg.version)
    newest = get_weight_path(ckpt_dir)
    reset_counts()
    t0 = time.perf_counter()
    run.infer(cfg, tests, newest, save)
    infer_s = time.perf_counter() - t0
    infer_counts = read_counts()
    labels = [np.load(os.path.join(save, os.path.basename(t).split(".")[0] + ".npy"))
              for t in tests]
    rows = run.evaluate(cfg, tests, save)
    emit("trainer_inference", volumes=len(tests), volume=args.volume, window_batch=WINDOWS,
         seconds=infer_s, seconds_per_case=infer_s / len(tests), launches=infer_counts,
         eval_rows=rows, mean_dice=float(np.nanmean([r["dice"] for r in rows])),
         mean_hd95=float(np.nanmean([r["hd95"] for r in rows])))
    if any(lab.shape != (args.volume,) * 3 or lab.min() < 0 or lab.max() >= N_CLS
           for lab in labels) or len(rows) != len(tests):
        fail(f"inference labels {[lab.shape for lab in labels]}, eval rows {rows}")
    if on_card and infer_counts != {k: v * len(tests) for k, v in forward.items()}:
        fail(f"inference launched {infer_counts}, expected {len(tests)} x {forward}")

    # Hecktor20Top1, one epoch: the preset's remat (on), level 1 packed
    hcfg = run.config("hecktor20top1", 1)
    reset_counts()
    run.train(hcfg, paths)
    hcounts = read_counts()
    hstep = per_train_step(hcounts, n_train, n_val + 1, HECKTOR_EXPECT) if on_card else None
    hepoch = epoch_records(hcfg)
    for rec in hepoch:
        emit("trainer_epoch", net=hcfg.net_name, **rec)
    emit("trainer_hecktor", launches=hcounts, launches_per_train_step=hstep,
         loss=hcfg.loss_fun, deep_supervision=hcfg.use_ds, remat=hcfg.remat)
    if on_card and hstep != HECKTOR_TRAIN_EXPECT:
        fail(f"Hecktor20Top1's train step launched {hstep}, expected {HECKTOR_TRAIN_EXPECT}")
    # phase 5's first run alone (not the resumed epoch), as 5b runs it
    first_run = epochs[:TRAIN_EPOCHS]
    host = dict(steady_step_s=statistics.mean(r["step_s"] for r in first_run[1:]),
                loader_wait_share=[r["loader_wait_share"] for r in first_run],
                peak_memory_bytes=peak, launches_per_train_step=step, train_wall_s=train_s)
    return ({"trainer": {k: counts[k] + resume_counts[k] + infer_counts[k] for k in counts},
             "trainer-hecktor20top1": hcounts}, host)


def drive_device_augment(args, run: TrainerRun, paths: list, host: dict) -> dict:
    """Phase 5b: phase 5's first run (HDenseFormer_32, 2 epochs of fold 1 at
    the Hecktor21 preset) with ``device_augment=True``, through
    ``SemanticSeg`` (the CLI has no flag for it). Its steady step, loader
    wait and peak beside phase 5's (``host``); launches per train step must
    equal phase 5's (the augmentation launches no custom kernel). Returns
    the run's launches."""
    on_card = run.device == "cuda"
    forward = hdf_expect(args)
    cfg = run.config("HDenseFormer_32", TRAIN_EPOCHS, version="smoke-augment-")
    train, val = run.split(cfg, paths)
    n_train, n_val = -(-len(train) // cfg.batch_size), -(-len(val) // cfg.batch_size)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    seg = run.seg_cls(**cfg.init_trainer_kwargs(), device_augment=True, device=run.device)
    seg.trainer(train, val, 1, **cfg.setup_trainer_kwargs())
    train_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    step = per_train_step(counts, TRAIN_EPOCHS * n_train, TRAIN_EPOCHS * n_val,
                          forward) if on_card else None
    epochs = epoch_records(cfg)
    for rec in epochs:
        emit("trainer_epoch", net=cfg.net_name, device_augment=True, **rec)
    steady = [r["step_s"] for r in epochs[1:]]
    emit("trainer_device_augment", net=cfg.net_name, cases=len(paths), case_size=args.case,
         patch=args.patch, batch=cfg.batch_size, depth=args.depth, remat=cfg.remat,
         train_wall_s=train_s, steady_step_s=statistics.mean(steady) if steady else None,
         loader_wait_share=[r["loader_wait_share"] for r in epochs], peak_memory_bytes=peak,
         launches=counts, launches_per_train_step=step,
         train_losses=[r["train_loss"] for r in epochs], host_augmentation=host)
    if on_card and step != host["launches_per_train_step"]:
        fail(f"device_augment train step launched {step}, host augmentation "
             f"{host['launches_per_train_step']}")
    if len(epochs) != TRAIN_EPOCHS or not all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in epochs):
        fail(f"device_augment trainer epochs {epochs}")
    return counts


def remat_memory(args, net_name: str = "HDenseFormer_32") -> dict:
    """Peak memory and time of one full-width train step at batch 2 (bf16)
    with remat on and off, one synthetic batch: HDenseFormer_32 with DS
    FocalLoss, Hecktor20Top1 (level 1 packed, n_filters 32) with FocalLoss,
    as the Hecktor21 preset trains each. Each step's launches are checked
    against the model's count."""
    case = synthetic_case(args.seed, args.patch)
    batch = {"image": case["image"].repeat(2, 1, 1, 1, 1),
             "label": case["label"].repeat(2, 1, 1, 1, 1)}
    hecktor = net_name == "hecktor20top1"
    peaks = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        net = get_net(net_name, 2, N_CLS, (args.patch,) * 3, transformer_depth=args.depth,
                      dtype=torch.bfloat16, remat=remat, device="cuda")
        init_weights(net, torch.Generator().manual_seed(args.seed))
        state = TrainState(net, get_optimizer("Adam", LR, weight_decay=WEIGHT_DECAY,
                                              params=net.parameters()))
        step = make_train_step(get_loss("FocalLoss", use_ds=not hecktor), N_CLS)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        step(state, batch, gen)  # the first step builds cuDNN's plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        _, out = step(state, batch, gen)
        torch.cuda.synchronize()
        peaks[remat] = dict(peak_bytes=torch.cuda.max_memory_allocated(),
                            step_ms=(time.perf_counter() - t0) * 1e3, launches=read_counts(),
                            loss=float(out["loss"]))
        del net, state
    if hecktor:
        expect = {True: HECKTOR_TRAIN_EXPECT,
                  False: dict(HECKTOR_TRAIN_EXPECT, instance_norm_relu=30, shift_pack=4)}
    else:
        expect = {False: hdf_expect(args, train=True),
                  True: dict(hdf_expect(args, train=True), dense_attention=4 * args.depth,
                             instance_norm_relu=36)}
    emit("remat_memory", net=net_name, batch=2, patch=args.patch, depth=args.depth,
         dtype="bfloat16", remat_on=peaks[True], remat_off=peaks[False])
    for remat in (True, False):
        if peaks[remat]["launches"] != expect[remat]:
            fail(f"{net_name} step (remat {remat}) launched {peaks[remat]['launches']}, "
                 f"expected {expect[remat]}")
    if not all(np.isfinite(p["loss"]) for p in peaks.values()):
        fail(f"{net_name} remat on and off: losses {peaks[True]['loss']}, {peaks[False]['loss']}")
    del case, batch
    torch.cuda.empty_cache()
    return peaks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=24, help="transformer_depth (24 = full)")
    args = ap.parse_args()
    args.patch, args.case, args.volume = PATCH, CASE, VOLUME
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    smi = phase_env(args)
    main_shapes = phase_kernels(gen)
    main_shapes["instance_norm_relu_backward"] = phase_norm_backward(gen)
    by_path = {"shift_grad": phase_shift_grad(gen)}
    phase_augment(args)
    net, plain = build_models(args)
    phase_forward(args, net, plain, gen)
    by_path["serve-200"] = phase_serving(args, net, plain, "serving", hdf_expect(args))
    del net, plain
    torch.cuda.empty_cache()
    nets = build_hecktor(args.seed, PATCH, torch.bfloat16)
    phase_hecktor_forward(args, nets, gen)
    by_path["serve-200-hecktor"] = phase_serving(
        args, nets["packed"], nets["packed_plain"], "serving_hecktor", HECKTOR_EXPECT)
    del nets
    phase_train_compare(args)
    by_path["train"] = phase_train(args)
    phase_remat_compare(args)
    remat_memory(args)
    remat_memory(args, "hecktor20top1")
    t_zoo = time.perf_counter()
    unetr = phase_unetr_norms(gen)
    main_shapes["instance_norm_relu"].update(
        {f"per_unetr_forward_{k}": unetr[f"fwd_{k}"] for k in ("ms", "plain_ms", "bound_ms")})
    main_shapes["instance_norm_relu_backward"].update(
        {f"per_unetr_step_{k}": unetr[f"bwd_{k}"] for k in ("ms", "plain_ms", "bound_ms")})
    by_path["zoo-unetr"] = phase_zoo(args, gen)
    case_format = "hdf5" if importlib.util.find_spec("h5py") else "npy"
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        by_path["zoo-da_unet-trainer"] = phase_zoo_journey(args, os.path.join(WORK, "zoo"),
                                                           case_format)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    emit("zoo_total", seconds=time.perf_counter() - t_zoo)
    t_2d = time.perf_counter()
    at_2d = phase_2d_kernels(args, gen)
    for name, rec in at_2d.items():
        main_shapes[name]["at_2d_shape"] = rec
    by_path.update(phase_2d_hdenseformer(args, gen))
    phase_2d_zoo(args)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        by_path["2d-journey"] = phase_2d_journey(args, os.path.join(WORK, "2d"))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    emit("phase_2d_total", seconds=time.perf_counter() - t_2d)
    try:
        by_path.update(phase_trainer(args, WORK, case_format))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    missing = [name for name in KERNELS
               if not by_path["trainer"][name] + by_path["trainer-hecktor20top1"][name]]
    if missing:
        fail(f"the trainer paths launched no {missing}")

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
