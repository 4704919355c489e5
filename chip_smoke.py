#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hdenseformer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--depth 24] [--phase all|mha]

(``--dp-worker gloo|nccl`` runs one rank of phase 4d; the phase starts
those processes itself. ``--phase mha`` runs phases 0 and 1m alone.)

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
1m. the fused attention at head width 64 (``ops/mha.py``) at TransBTS's
   (2, 8, 5832, 64) bf16 in training (dropout 0.1 by a drawn keep mask):
   forward and backward against the plain math (largest error of O, dQ,
   dK, dV over the plain output's largest), rerun bitwise; device times of
   the forward and of the backward's two kernels beside their bounds (the
   larger of products over 989 TFLOP/s with dS's three-part split counted
   once, exponentials at 16 a clock per SM at the maximum SM clock, and the
   mask's bytes over 3.35 TB/s), the mask's draw, the plain math's forward
   and backward, and ``F.scaled_dot_product_attention`` with dropout 0.1
   as ``library_ms`` (a yardstick: the port never calls it);
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
   144^3, step 72^3, window_batch 8, one model call of 8 windows), the
   whole call (window gather, forward, accumulation, argmax) captured as
   one CUDA graph of its lattice cell at the first call (the default on a
   card): first call, then captured and eager (``capture=False``) calls in
   turns, p50 and peak device memory of each, launch counts (a warm-up's
   and a capture's at the first call, none at a replay), the CUDA
   runtime's launches of a warm call (one graph launch, no kernel launch),
   the captured labels equal to the eager ones on every voxel; a 190^3
   volume in the same cell, then 200 x 200 x 144 and 190 x 196 x 120
   (shorter than the patch, in the cell of the volume before), each equal
   to eager, one graph a cell; and the labels against the plain path's;
   3b. the same for Hecktor20Top1;
4. training: one train step of HDenseFormer_32 at 64^3, depth 4, through
   the kernels and through the plain versions from the same weights and
   dropout seed, in fp32 and in bf16, beside the plain path on an input
   moved by one rounding step (the network's own sensitivity, which sets
   the bars); then the full-width train step of bench.py (2 modalities,
   144^3, batch 1, depth 24, bf16, FocalLoss deep supervision, Adam with
   coupled L2 1e-4, lr 1e-3, dropout 0.5, no rematerialisation) on its zero
   image, built and timed by ``hdenseformer_tpu_torch.bench`` (one warm
   step, the best of 4 chained windows of 8 steps), captured as the
   trainer runs it and then eagerly on the same state: the loss after every
   window, peak memory, launches, and the bench's JSON line (captured);
   then one 64^3 fp32 step with remat on and off (cuDNN deterministic, one
   dropout seed: equal loss, gradients within 1e-5 of their max, the
   generator in one state), and the peak memory and time of one full-width
   step at batch 2 with remat on and off, of HDenseFormer_32 and of
   Hecktor20Top1;
4g. the captured step (``train.loop.make_multi_train_step``): bench.py's
   model and optimizer (made capturable) on 8 synthetic cases, 8 steps
   captured once as a CUDA graph and replayed, against 8 eager steps from
   the same weights and dropout seeds: the launches at capture (one step's),
   the losses step by step (bars from eager steps on an input moved by one
   bf16 step, and a control step with another dropout seed), ms a step in
   turns, and a profile of the replays (the port's kernels by name, the
   card's idle share);
4d. data parallel (``parallel/mesh.py``) on the one card: two gloo
   processes of this script (the JAX package's env contract), bench.py's
   model at batch 1 a rank, two steps against one process's batch-2 steps;
   a 200^3 volume's windows split over the two ranks (``capture=False``)
   against one process; each rank's ``capture=True`` calls refused (gloo
   cannot be captured); then under torchrun's env NCCL at world size 1 with
   the collectives run (``always_reduce``): the captured train steps, eval
   step and ``predict_volume(mesh=...)`` against the eager ones on the same
   mesh, steps timed in turns; launches checked on each rank;
4p. the packed levels (space-to-depth, ``ops/s2d.py``), which get_net's
   default ``s2d=None`` runs in every phase, as JAX's does: (a) the shifted
   InstanceNorm forward and backward kernels against their plain versions
   at HDenseFormer_32's level 0 in serving (8 windows of 144 x 73 x 73
   shifted cells of 4 x 32 channels; backward at batch 1) and at
   HDenseFormer_2D_32's (24 x 193 x 193 cells; backward at batch 24), with
   garbage in the pad slots, which must come out 0: phase 1's and 1b's
   bars, timed against their bounds and plain versions, and in turns with
   the unshifted kernels on the same bytes (the shifted mode's own cost),
   by pass, with each instantiation's registers and blocks per
   multiprocessor, beside the shifted kernels' first design's; (b)
   HDenseFormer_32 at 144^3 (level 0 packed over (H, W)) against
   ``s2d=False`` on the same weights: argmax agreement (phase 2's bars), a
   forward of 8 windows and a batch-2 remat train step each timed in turns
   (packed, fine, fine, packed), peak memory, launches; (c) the same for
   HDenseFormer_2D_32 at 384^2, batch 24 (level 0 at full rank); (d)
   Hecktor20Top1 with ``s2d={1: True, 2: (2,)}`` (level 2 packed over W)
   against its default, 2 windows and a batch-2 step; (e) da_unet and
   TransBTS, packed default against ``s2d=False``, at phase 4b's sizes
   (agreement bar 0.99: their packed norms keep bf16 where the fine ones
   return fp32, as JAX's);
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
   which must have moved off (0, 1)), eval; its training run captured,
   then in turns eager and eager on moved inputs (as phase 5);
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
   slice cases (.npy; captured, then in turns eager and eager on moved
   inputs, as phase 5), ``predict_case_2d`` of two 3 x 30 x 400^2 volumes,
   its chunk captured as one graph, and eagerly in turns (seconds a volume
   of each, slices/s; labels equal to eager's and to a direct argmax of the
   model's logits on the same preprocessed slices) and their dice and HD95;
5. the trainer: 6 synthetic 152^3 cases (3 patients x 2), written as .hdf5
   where h5py imports and driven through the CLI (``cli.main``), else as
   .npy case directories driven through ``SemanticSeg`` with a .npy reader
   (the CLI's own calls; the line says which). Fold 1 of 3 trains 2 epochs
   at the Hecktor21 preset (HDenseFormer_32, 144^3, depth 24, batch 2, bf16,
   remat, DS FocalLoss, Adam with coupled L2 1e-4, poly LR), resumes 3
   epochs from its best checkpoint, infers two 200^3 volumes (window batch
   8) and is evaluated (dice, HD95); then one epoch of Hecktor20Top1 (with
   the preset's remat, as JAX). Per epoch: losses, dice, seconds, step time
   and the share spent waiting on the loader; launches per train step,
   checked against the counts the models' code gives. The resumed epochs
   run under ``utils.profiling.profiler_trace`` (the CLI's ``--profile``):
   the trace must name the attention, InstanceNorm forward and backward
   kernels and their shifted instantiations; its size and the epochs' step
   time beside the unprofiled epochs', and the card's idle share over their
   5 replayed steps, loader waits left out. Every training run is the
   trainer's default, its train and eval steps captured as CUDA graphs,
   then the same fold runs in turns eagerly (``capture=False``) and
   eagerly on inputs moved by a relative N(0, 2^-8): step losses of the captured run against the eager
   one, the first within 1e-3, each later one within that or 3x the moved
   run's spread (the graph phase's bars); steady step, loader-wait share,
   graphs captured and peak memory of each run side by side; launches at
   capture (a warm-up's and a capture's a graph) and by the eager steps;
5b. the same 2 epochs of HDenseFormer_32 with ``device_augment=True``
   (through ``SemanticSeg``: the CLI has no flag for it, as JAX's has
   none): the loader ships raw cases and the augmentation runs in the step
   on the card. Steady step time, loader-wait share and peak memory beside
   phase 5's; launches per train step equal to phase 5's; finite losses;
   captured and in turns eager, as phase 5;
6. a {"kernels": [...]} line with each kernel's numbers;
7. the result line {"ok": true, "device": {...}}.

Each path is driven with every kernel's launch count set to 0 just before
it and read just after; a kernel of the path that did not launch fails the
run. A wrapper counts in Python, so on a captured path it counts the
warm-up's and the capture's launches, and a replay none. The InstanceNorm
kernels' shifted mode counts as two kernels of its own
(``instance_norm_relu_shifted`` and its backward); HDenseFormer_32's and
HDenseFormer_2D_32's paths launch it at level 0's first BasicConvs.

Any failed check exits non-zero before the result line, as does a machine
without a CUDA device. fp32 comparisons run with TF32 off in cuDNN and
cuBLAS (set below for the whole run), since a float32 convolution otherwise
runs in TF32 on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import unittest.mock
import zlib

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
from hdenseformer_tpu_torch.models.layers import dropout_keep, init_weights
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
from hdenseformer_tpu_torch.train import loop as train_loop
from hdenseformer_tpu_torch.train.checkpoint import get_weight_path, load_checkpoint
from hdenseformer_tpu_torch.parallel.mesh import make_mesh, maybe_distributed_init
from hdenseformer_tpu_torch.train.loop import (
    SemanticSeg,
    TrainState,
    make_multi_train_step,
    make_train_step,
    pad_and_mask_batch,
    step_seed,
)
from hdenseformer_tpu_torch.utils import profiler_trace
from hdenseformer_tpu_torch.train.state import get_optimizer, make_capturable

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SM_COUNT = 132  # H100 SXM
EX2_PER_CLOCK_SM = 16  # ex2 results a clock per SM, compute capability 9.0
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
# shifted, HDF_SHIFTED), and the UpConv pyramid's four (no affine), each on
# the grid it reads before its upsample: deep_conv on the 9^3 token grid,
# up1-up3
IN_FORWARD = (((PATCH ** 3, 32), 2, True), (((PATCH // 2) ** 3, 64), 4, True),
              (((PATCH // 4) ** 3, 128), 4, True), (((PATCH // 8) ** 3, 256), 2, True),
              (((PATCH // 16) ** 3, 256), 1, False), (((PATCH // 8) ** 3, 128), 1, False),
              (((PATCH // 4) ** 3, 64), 1, False), (((PATCH // 2) ** 3, 32), 1, False))
HDF_NORMS, HDF_SHIFTED = 18, 2  # a forward's InstanceNorms, and its shifted ones
IN_PASSES = ("partial_stats_kernel", "finalize_kernel", "normalize_kernel")
IN_BWD_PASSES = ("bwd_persistent_kernel",)
HECKTOR_EXPECT = {"dense_attention": 0, "instance_norm_relu": 30, "shift_pack": 4,
                  "shift_pack_backward": 0, "instance_norm_relu_backward": 0,
                  "instance_norm_relu_shifted": 0, "instance_norm_relu_shifted_backward": 0}
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
                        "shift_pack_backward": 3, "instance_norm_relu_backward": 30,
                        "instance_norm_relu_shifted": 0, "instance_norm_relu_shifted_backward": 0}
# the train step of bench.py: batch 1, Adam with coupled L2, 4 chained
# windows of 8 steps; a 144^3 patch counts (144 / 128)^3 128^3 patches
LR, WEIGHT_DECAY = bench.LR, bench.WEIGHT_DECAY
TRAIN_WINDOWS, TRAIN_STEPS = bench.REPS, bench.STEPS
PATCH_EQUIV = (PATCH / 128) ** 3
# the trainer phase: 6 synthetic cases of CASE^3 (3 patients x 2; RandomCrop3D
# draws a 144^3 patch), fold 1 of 3, 2 epochs, then RESUME_EPOCHS resumed and
# profiled (2 train steps an epoch: the first captures, 5 replays)
CASE, TRAIN_EPOCHS, RESUME_EPOCHS = 152, 2, 3
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
SMP_2D = tuple((net, enc) for net in ("unet", "unet++", "deeplabv3+")
               for enc in ("resnet18", "resnet50"))
SMP_2D_STEPS = 2
# the 2-D journey: 72 slice cases (fold 1 of 3: 48 train, 2 steps of 24), then
# per-slice prediction of 2 volumes of 30 slices of 400^2 (chunks of 24 and 6)
JOURNEY_SLICES, JOURNEY_VOLUME = 72, (30, 400, 400)
# the packed levels phase: the shifted InstanceNorm at HDenseFormer_32's
# level 0 in serving (8 windows of 144^3, packed over (H, W): 144 x 73 x 73
# shifted cells of 4 x 32 channels; its backward at the train step's batch
# 1) and at HDenseFormer_2D_32's (24 slices of 384^2, full rank: 193 x 193
# cells of 4 x 32; backward at batch 24): (tag, (N, *cells), dims, backward N)
SHIFTED_SHAPES = (("3d", (WINDOWS, PATCH, PATCH // 2 + 1, PATCH // 2 + 1), (1, 2), 1),
                  ("2d", (SLICE_BATCH, SLICE // 2 + 1, SLICE // 2 + 1), (0, 1), SLICE_BATCH))
HECKTOR_LEVEL2 = {1: True, 2: (2,)}  # level 1 packed at full rank, level 2 over W
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


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


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
    t_exp = b * h * n * n / (EX2_PER_CLOCK_SM * SM_COUNT * sm_clock_hz()) * 1e3
    rec = dict(bound_ms=t, bound_by=by, exp_bound_ms=t_exp, sm_clock_hz=sm_clock_hz())
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
         depth=args.depth, kernel_build_s=round(build_s, 3), ptxas=ptxas)
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
    expect = dict(dict.fromkeys(KERNELS, 0), shift_pack=1, shift_pack_backward=1)
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


def hdf_expect(args, train: bool = False, remat: bool = False, packed: bool = True) -> dict:
    """Launches of one HDenseFormer_32 forward (or train step) at full width:
    with ``remat`` the forward's kernels run twice (the recompute); ``packed``
    (get_net's default) puts HDF_SHIFTED norms in the shifted mode."""
    shifted, fwd = HDF_SHIFTED if packed else 0, 2 if remat else 1
    return {"dense_attention": 2 * args.depth * fwd,
            "instance_norm_relu": (HDF_NORMS - shifted) * fwd, "shift_pack": 0,
            "shift_pack_backward": 0,
            "instance_norm_relu_backward": HDF_NORMS - shifted if train else 0,
            "instance_norm_relu_shifted": shifted * fwd,
            "instance_norm_relu_shifted_backward": shifted if train else 0}


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
        if counts["instance_norm_relu"] != sum(count for _, count, _ in IN_FORWARD):
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


# other volumes of serve-200's run, each in the lattice cell of the call
# before it: 190^3 in 200^3's cell (216^3, 8 windows; other origins), then
# 200 x 200 x 144 (a new cell: 216 x 216 x 144, 4 windows) and 190 x 196 x
# 120, shorter than the patch in its last dim, whose windows read the 24
# pad slices the volume before filled in the call's buffers
CELL_VOLUMES = (("190", (190, 190, 190)), ("200x200x144", (200, 200, 144)),
                ("190x196x120", (190, 196, 120)))
RUNTIME_LAUNCHES = {"graph": ("cudaGraphLaunch", "cuGraphLaunch"),
                    "kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")}


def runtime_launches(fn) -> dict:
    """The CUDA runtime's graph launches, kernel launches and copies of one
    call of ``fn``, read from torch.profiler's runtime events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {k: 0 for k in list(RUNTIME_LAUNCHES) + ["memcpy", "memset"]}
    for e in prof.key_averages():
        for k, names in RUNTIME_LAUNCHES.items():
            if e.key in names:
                counts[k] += e.count
        if e.key.startswith(("cudaMemcpy", "cuMemcpy")):
            counts["memcpy"] += e.count
        if e.key.startswith(("cudaMemset", "cuMemset")):
            counts["memset"] += e.count
    return counts


def phase_serving(args, net, plain, tag: str, expect: dict) -> dict:
    """predict_volume of a 200^3 volume as ``-m inf-sw`` serves it: the
    whole call (window gather, forward, accumulation, argmax) captured as
    one graph of the volume's lattice cell at the first call (its warm-up
    and capture count two forwards' launches; later calls replay and count
    none), then captured and eager (``capture=False``) calls in turns: p50
    of each, peak memory of each, the labels of the two equal on every
    voxel; the CUDA runtime's launches of one warm call of each (captured:
    one graph launch and no kernel launch); CELL_VOLUMES captured against
    eager, equal on every voxel, one graph a cell; and the plain path's
    labels, agreeing on 99 % of the voxels. Returns the first call's
    launches."""
    from hdenseformer_tpu_torch.utils.graphs import model_graphs

    image = PETandCTNormalize()({"image": synthetic_volume(args.seed)})["image"]

    def serve(model, capture=True, volume=image):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = predict_volume(model, volume, (PATCH,) * 3, (STEP,) * 3, N_CLS,
                                window_batch=WINDOWS, capture=capture)
        return labels, (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    labels, first_ms = serve(net)
    first_counts = read_counts()
    peaks = {"captured": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eager_labels, eager_first_ms = serve(net, capture=False)
    peaks["eager"] = torch.cuda.max_memory_allocated()
    eager_first_counts = read_counts()
    turns, per_call = [], {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured", "captured", "eager"):
        reset_counts()
        again, ms = serve(net, mode == "captured")
        turns.append([mode, ms])
        per_call[mode].append(read_counts())
        if not np.array_equal(again, labels if mode == "captured" else eager_labels):
            fail(f"repeated {mode} serving calls gave different labels")
    warm = {mode: [ms for m, ms in turns if m == mode] for mode in per_call}
    runtime = {mode: runtime_launches(lambda: serve(net, mode == "captured"))
               for mode in ("captured", "eager")}
    graphs = [model_graphs(net).captured]
    cells = {}
    for i, (name, shape) in enumerate(CELL_VOLUMES):
        vol = PETandCTNormalize()({"image": synthetic_volume(args.seed + 1 + i)[
            (slice(None),) + tuple(slice(0, n) for n in shape)]})["image"]
        got, ms = serve(net, volume=vol)
        want, eager_ms = serve(net, False, vol)
        graphs.append(model_graphs(net).captured)
        cells[name] = dict(shape=list(shape), first_call_ms=ms, eager_ms=eager_ms,
                           labels_equal_eager=float((got == want).mean()),
                           graphs=graphs[-1], foreground=float(got.mean()))
    acc = single_accumulator(net, image)
    top = acc.topk(2, dim=-1).values
    decided = (top[..., 0] - top[..., 1] > 0.1).cpu().numpy()
    same = labels == eager_labels
    ref, plain_ms = serve(plain, capture=False)
    agree = float((labels == ref).mean())
    p50 = {mode: statistics.median(v) for mode, v in warm.items()}
    n_windows = int(np.prod([len(s) for s in cal_steps((VOLUME,) * 3, (PATCH,) * 3,
                                                        (STEP,) * 3)]))
    emit(tag, volume=[VOLUME] * 3, patch=PATCH, step=STEP, window_batch=WINDOWS,
         windows=n_windows, label_shape=list(labels.shape), label_dtype=str(labels.dtype),
         class_histogram=np.bincount(labels.ravel(), minlength=N_CLS).tolist(),
         first_call_ms=first_ms, eager_first_call_ms=eager_first_ms, ms_in_turns=turns,
         p50_ms=p50["captured"], eager_p50_ms=p50["eager"],
         windows_per_s=n_windows / (p50["captured"] / 1e3),
         max_memory_allocated_bytes=peaks["captured"],
         eager_max_memory_allocated_bytes=peaks["eager"],
         launches_first_call=first_counts, launches_per_warm_call=per_call,
         eager_launches_first_call=eager_first_counts, runtime_per_warm_call=runtime,
         graphs_after=graphs, cells=cells,
         labels_equal_eager=float(same.mean()), decided_fraction=float(decided.mean()),
         labels_equal_eager_margin_gt_0p1=float(same[decided].mean()),
         plain_path_ms=plain_ms, label_agreement_vs_plain=agree)
    if labels.shape != (VOLUME,) * 3 or labels.min() < 0 or labels.max() >= N_CLS:
        fail(f"labels {labels.shape} in [{labels.min()}, {labels.max()}]")
    zero = {k: 0 for k in expect}
    if (first_counts != {k: 2 * v for k, v in expect.items()} or eager_first_counts != expect
            or any(c != zero for c in per_call["captured"])
            or any(c != expect for c in per_call["eager"])):
        fail(f"{tag} launched {first_counts} at capture, {per_call} in turns, expected "
             f"{expect} a forward")
    if not same.all():
        fail(f"{tag}: captured and eager labels differ on {int((~same).sum())} voxels")
    if runtime["captured"]["graph"] != 1 or runtime["captured"]["kernel"] != 0:
        fail(f"{tag}: a warm captured call issued {runtime['captured']}, expected one graph "
             "launch and no kernel launch")
    if graphs != [1, 1, 2, 2] or any(c["labels_equal_eager"] != 1.0 for c in cells.values()):
        fail(f"{tag}: graphs after each cell {graphs} (expected [1, 1, 2, 2]), cells {cells}")
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
    ``hdenseformer_tpu_torch.bench`` (its protocol, its zero input): the
    step the trainer runs, captured (its first step warms up and captures,
    so the wrappers count two steps' launches, whatever the replays), then
    the eager step by the same protocol on the same state. Returns the
    captured run's launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, batch, gen = bench.build("cuda", PATCH, args.depth, args.seed)
    expect = hdf_expect(args, train=True)
    reset_counts()
    timed = bench.time_steps(state, step, batch, gen, TRAIN_STEPS, TRAIN_WINDOWS)
    counts = read_counts()
    if counts != {k: 2 * v for k, v in expect.items()}:
        fail(f"the captured steps launched {counts}, not a warm-up's and a capture's {expect}")
    captured_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eager = bench.time_steps(state, step.eager, batch, gen, TRAIN_STEPS, TRAIN_WINDOWS)
    eager_counts = read_counts()
    steps = 1 + TRAIN_WINDOWS * TRAIN_STEPS
    if any(eager_counts[k] != v * steps for k, v in expect.items()):
        fail(f"the {steps} eager steps launched {eager_counts}, not {steps} x {expect}")
    recs = {}
    for mode, t in (("captured", timed), ("eager", eager)):
        windows = [w * 1e3 / TRAIN_STEPS for w in t["rep_window_s"]]
        recs[mode] = dict(first_step_ms=t["first_call_s"] * 1e3, first_loss=t["first_loss"],
                          window_ms_per_step=windows, window_losses=t["window_losses"],
                          ms_per_step=min(windows), patches_128_per_s=PATCH_EQUIV / (
                              min(windows) / 1e3), window_spread=max(windows) / min(windows))
        losses = t["window_losses"]
        if not all(np.isfinite([t["first_loss"]] + losses)) or not losses[-1] < t["first_loss"]:
            fail(f"{mode} train losses {t['first_loss']} -> {losses}: not finite and falling")
    out = timed["metrics"]
    emit("train", patch=PATCH, batch=bench.BATCH, depth=args.depth, dtype="bfloat16",
         dropout=0.5, input="bench.py's: zero image, background label",
         captured=recs["captured"], eager=recs["eager"],
         max_memory_allocated_bytes=captured_peak,
         eager_max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches_per_step=expect, launches_captured_run=counts,
         launches_eager_run=eager_counts, steps=state.step, dice=float(out["dice"]),
         cm=out["cm"].tolist())
    emit("bench", **bench.result_line(timed["best_window_s"], TRAIN_STEPS, PATCH))
    del state, batch, step
    torch.cuda.empty_cache()
    return counts


GRAPH_STEPS = 8  # K: the chained steps of the graph phase


def graph_state(args):
    """bench.py's model and optimizer (HDenseFormer_32, 144^3, depth 24,
    bf16, dropout 0.5, Adam with coupled L2), the optimizer capturable."""
    state, _, _, _ = bench.build("cuda", PATCH, args.depth, args.seed)
    make_capturable(state.optimizer, "cuda")
    return state


def eager_steps(state, batches: dict, seed: int) -> tuple:
    """The K single steps the trainer would run: dropout seeded
    ``step_seed(seed, step)`` before each. Returns the losses and the wall
    ms a step (synchronised)."""
    step = make_train_step(get_loss("FocalLoss", use_ds=True), N_CLS)
    gen = torch.Generator(device="cuda")
    k = batches["image"].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(k):
        gen.manual_seed(step_seed(seed, state.step))
        _, out = step(state, {n: v[i] for n, v in batches.items()}, gen)
        losses.append(out["loss"])
    losses = torch.stack(losses).tolist()
    return losses, (time.perf_counter() - t0) * 1e3 / k


def captured_steps(multi, state, batches: dict, seed: int) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = multi(state, batches, seed)
    losses = out["loss"].tolist()
    return losses, (time.perf_counter() - t0) * 1e3 / batches["image"].shape[0]


def busy_union_ms(prof) -> float:
    """The device's busy time in a profile: the union of its kernels'
    intervals (kernels of one graph may overlap)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return busy / 1e3


def phase_graph(args) -> dict:
    """K = 8 train steps of bench.py's model captured as one CUDA graph and
    replayed (``train.loop.make_multi_train_step``), against 8 eager steps
    from the same weights and dropout seeds, on 8 synthetic cases (144^3,
    batch 1). The captured launches of every kernel (the wrappers count at
    capture: one step's), the losses step by step: the first within phase
    4's bf16 bar (1e-3 relative; a control step with another dropout seed
    must move the loss more than the capture does), each later one within
    that bar or 3x the largest spread of eager steps on the input moved by
    one bf16 step (phase 4's method: Adam turns the rounding of cuDNN's
    backward into whole-lr moves, so the runs drift apart step by step as two
    correct runs do), wall ms a step in turns
    (captured, eager, eager, captured), and a profile of 8 replays: the
    port's kernels by name in it, and the card's idle share, 1 - busy /
    wall, the busy time the kernels' device time under the profiler and the
    wall time the unprofiled captured calls' (busy: the union of the
    kernels' intervals, which a graph may run side by side). Returns the
    captured launches."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cases = [synthetic_case(args.seed + i, PATCH) for i in range(GRAPH_STEPS)]
    batches = {n: torch.stack([c[n] for c in cases]) for n in ("image", "label")}
    del cases
    expect = hdf_expect(args, train=True)
    multi = make_multi_train_step(get_loss("FocalLoss", use_ds=True), N_CLS)
    captured = graph_state(args)
    multi.warmup(captured, batches)
    reset_counts()
    t_capture = time.perf_counter()
    cap_losses, _ = captured_steps(multi, captured, batches, args.seed)
    first_call_s = time.perf_counter() - t_capture
    capture_counts = read_counts()
    eager = graph_state(args)
    reset_counts()
    eager_losses, eager_ms = eager_steps(eager, batches, args.seed)
    eager_counts = read_counts()
    control = graph_state(args)
    control_loss = eager_steps(control, {n: v[:1] for n, v in batches.items()},
                               args.seed + 1)[0][0]
    del control
    moved_state = graph_state(args)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    moved = dict(batches, image=batches["image"] * (1 + 2.0 ** -8 * torch.randn(
        batches["image"].shape, generator=g, device="cuda")))
    moved_losses = eager_steps(moved_state, moved, args.seed)[0]
    del moved_state, moved
    torch.cuda.empty_cache()
    turns = dict(captured=[], eager=[eager_ms])
    turns["captured"].append(captured_steps(multi, captured, batches, args.seed)[1])
    turns["eager"].append(eager_steps(eager, batches, args.seed)[1])
    turns["eager"].append(eager_steps(eager, batches, args.seed)[1])
    turns["captured"].append(captured_steps(multi, captured, batches, args.seed)[1])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        multi(captured, batches, args.seed)
        torch.cuda.synchronize()
    busy, names = 0.0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.time_range.elapsed_us() / 1e3
            names[e.name] = names.get(e.name, 0) + 1
    busy_per_step = busy / GRAPH_STEPS
    wall = min(turns["captured"])
    union = busy_union_ms(prof) / GRAPH_STEPS
    port_kernels = {n: c // GRAPH_STEPS for n, c in names.items() if any(
        k in n for k in ("dense_attention_kernel", "partial_stats_kernel", "finalize_kernel",
                         "normalize_kernel", "bwd_persistent_kernel", "shift_kernel"))}
    rel = [abs(a - b) / abs(b) for a, b in zip(cap_losses, eager_losses)]
    spread = [abs(a - b) / abs(b) for a, b in zip(moved_losses, eager_losses)]
    bars = [1e-3] + [max(1e-3, 3 * max(spread))] * (GRAPH_STEPS - 1)
    control_rel = abs(control_loss - eager_losses[0]) / abs(eager_losses[0])
    rec = dict(net="HDenseFormer_32", patch=PATCH, depth=args.depth, batch=1, dtype="bfloat16",
               dropout=0.5, steps=GRAPH_STEPS, first_call_s=first_call_s,
               launches_captured=capture_counts, launches_eager_8_steps=eager_counts,
               captured_losses=cap_losses, eager_losses=eager_losses, loss_rel=rel,
               moved_input_loss_rel=spread, loss_bars=bars,
               control_seed_loss_rel=control_rel,
               ms_per_step_in_turns=[["captured", turns["captured"][0]],
                                     ["eager", turns["eager"][1]],
                                     ["eager", turns["eager"][2]],
                                     ["captured", turns["captured"][1]]],
               eager_ms_first_run=turns["eager"][0], replay_kernel_ms_per_step=busy_per_step,
               replay_busy_ms_per_step=union, replay_idle_share=1 - union / wall,
               port_kernels_per_replay=port_kernels, seconds=time.perf_counter() - t0)
    emit("graph", **rec)
    if capture_counts != expect:
        fail(f"the captured step launched {capture_counts}, expected one step's {expect}")
    if eager_counts != {k: v * GRAPH_STEPS for k, v in expect.items()}:
        fail(f"the eager steps launched {eager_counts}, expected {GRAPH_STEPS} x {expect}")
    if not all(np.isfinite(cap_losses)) or any(r > b for r, b in zip(rel, bars)) or (
            control_rel <= rel[0]):
        fail(f"captured against eager losses: {rel}, bars {bars} (control {control_rel})")
    seen = {k: any(k in n for n in port_kernels) for k in (
        "dense_attention_kernel", "partial_stats_kernel", "normalize_kernel",
        "bwd_persistent_kernel")}
    if not all(seen.values()):
        fail(f"the replays' profile lacks the port's kernels: {seen}, names {sorted(names)[:40]}")
    del multi, captured, eager, batches
    torch.cuda.empty_cache()
    return capture_counts


DP_WORK = os.path.join(WORK, "dp")


def dp_case(seed: int) -> dict:
    """A synthetic case as a host batch of one (numpy), the data-parallel
    phase's global batch being two of them."""
    image = PETandCTNormalize()({"image": synthetic_volume(seed, PATCH)})["image"]
    return {"image": np.moveaxis(image, 0, -1)[None].astype(np.float32),
            "label": np.eye(N_CLS, dtype=np.float32)[sphere(PATCH).astype(np.int64)][None]}


def dp_global_batch(args, nudge: float = 0.0) -> dict:
    cases = [dp_case(args.seed + i) for i in range(2)]
    batch = {n: np.concatenate([c[n] for c in cases]) for n in ("image", "label")}
    if nudge:  # the input moved by one rounding step: the bars' reference spread
        rng = np.random.RandomState(args.seed + 7)
        batch["image"] = batch["image"] * (1 + nudge * rng.randn(*batch["image"].shape)
                                           ).astype(np.float32)
    return batch


def dp_steps(args, device, mesh=None, nudge: float = 0.0, capture: bool = False) -> dict:
    """Two train steps of bench.py's model on the global batch of two cases
    (this rank's share under ``mesh``), dropout seeded per step as the
    trainer seeds it: the losses, launches and the parameters after, and
    what a later step needs (state, step, batch, generator). The steps run
    eagerly, or with ``capture`` as the trainer's captured step (under an
    NCCL mesh with the collectives inside the graph)."""
    state, step, _, _ = bench.build(device, PATCH, args.depth, args.seed)
    if not capture:
        step = step.eager
    host = dp_global_batch(args, nudge)
    batch = pad_and_mask_batch(host, 2, mesh or device)
    gen = torch.Generator(device=device)
    losses = []
    reset_counts()
    with mesh or contextlib.nullcontext():
        for _ in range(2):
            gen.manual_seed(step_seed(args.seed, state.step))
            _, out = step(state, batch, gen)
            losses.append(float(out["loss"]))
    return dict(losses=losses, launches=read_counts(), state=state, step=step, batch=batch,
                gen=gen,
                params={n: p.detach().float().cpu() for n, p in state.model.named_parameters()})


def scalars(metrics: dict) -> dict:
    return {k: v.cpu().tolist() for k, v in metrics.items()}


def dp_nccl_capture(args, mesh) -> dict:
    """The NCCL world-1 rank's captured calls against the eager ones on the
    same mesh (``always_reduce``: the collectives run, each the identity):
    two train steps each way from the same weights (the captured graph
    holds the global sums, forward and backward, and the gradients'
    all-reduce), then steps of the two in turns, each timed to its loss;
    the eval step, captured and eager, on the eager run's state; and
    ``predict_volume(mesh=...)`` of a 200^3 volume captured (its
    accumulator's all-reduce in the graph) against ``capture=False``, in
    turns."""
    runs = {mode: dp_steps(args, mesh.device, mesh, capture=mode == "captured")
            for mode in ("eager", "captured")}
    step_ms = {"eager": [], "captured": []}
    with mesh:
        for mode in ("eager", "captured", "captured", "eager", "eager", "captured"):
            run = runs[mode]
            run["gen"].manual_seed(step_seed(args.seed, run["state"].step))
            t0 = time.perf_counter()
            _, out = run["step"](run["state"], run["batch"], run["gen"])
            float(out["loss"])
            step_ms[mode].append((time.perf_counter() - t0) * 1e3)
        ev = train_loop.CapturedEvalStep(get_loss("FocalLoss", use_ds=True), N_CLS)
        state, batch = runs["eager"]["state"], runs["eager"]["batch"]
        evals = {"eager": scalars(ev.eager(state, batch)), "captured": scalars(ev(state, batch))}
    net = get_net("HDenseFormer_32", 2, N_CLS, (PATCH,) * 3, transformer_depth=args.depth,
                  dtype=torch.bfloat16, device=mesh.device)
    init_weights(net, torch.Generator().manual_seed(args.seed))
    image = PETandCTNormalize()({"image": synthetic_volume(args.seed)})["image"]
    reset_counts()
    labels, serve_ms = {}, {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels[mode] = predict_volume(net, image, (PATCH,) * 3, (STEP,) * 3, N_CLS,
                                      window_batch=WINDOWS, mesh=mesh,
                                      capture=mode == "captured")
        serve_ms[mode].append((time.perf_counter() - t0) * 1e3)
    serve_counts = read_counts()
    return dict(
        losses={m: r["losses"] for m, r in runs.items()},
        launches={m: r["launches"] for m, r in runs.items()}, step_ms=step_ms, eval=evals,
        serve_labels_equal=float((labels["captured"] == labels["eager"]).mean()),
        serve_ms=serve_ms, serve_launches=serve_counts)


def dp_worker(args) -> int:
    """One rank of the data-parallel phase, started by ``phase_data_parallel``
    (``--dp-worker gloo`` under the JAX package's env contract, or ``nccl``
    under torchrun's at world size 1). Prints one JSON line."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dp_worker == "nccl":
        if not maybe_distributed_init("cuda"):
            fail("no launch contract in the environment")
        mesh = make_mesh(1, always_reduce=True)  # one card: the collectives run, at world 1
        t = torch.ones(3, device=mesh.device) * (mesh.rank + 1)
        torch.distributed.all_reduce(t)
        run = dp_nccl_capture(args, mesh)
        print(json.dumps(dict(rank=mesh.rank, world=mesh.world_size,
                              backend=torch.distributed.get_backend(), all_reduce=t.tolist(),
                              **run)), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    if not maybe_distributed_init("cuda", backend="gloo"):
        fail("no launch contract in the environment")
    mesh = make_mesh(2, "cuda:0")  # both ranks on the one card
    net = get_net("HDenseFormer_32", 2, N_CLS, (PATCH,) * 3, transformer_depth=args.depth,
                  dtype=torch.bfloat16, device=mesh.device)
    init_weights(net, torch.Generator().manual_seed(args.seed))
    image = PETandCTNormalize()({"image": synthetic_volume(args.seed)})["image"]
    refused = {}  # gloo's collectives cannot be captured: capture=True raises on a card
    state = TrainState(net, get_optimizer("Adam", 1e-3, params=net.parameters()))
    step = train_loop.CapturedTrainStep(get_loss("FocalLoss", use_ds=True), N_CLS)
    for call, fn in (("predict_volume", lambda: predict_volume(
            net, image, (PATCH,) * 3, (STEP,) * 3, N_CLS, window_batch=WINDOWS, mesh=mesh)),
                     ("train_step", lambda: step(state, pad_and_mask_batch(
                         dp_global_batch(args), 2, mesh), torch.Generator(device="cuda")))):
        try:
            with mesh:
                fn()
            refused[call] = "ran"
        except RuntimeError as e:
            refused[call] = str(e)
    del state, step
    run = dp_steps(args, mesh.device, mesh)
    if mesh.rank == 0:
        torch.save(run["params"], os.path.join(DP_WORK, "params.pt"))
    reset_counts()
    labels = predict_volume(net, image, (PATCH,) * 3, (STEP,) * 3, N_CLS,
                            window_batch=WINDOWS, mesh=mesh, capture=False)
    serve_counts = read_counts()
    if mesh.rank == 0:
        np.save(os.path.join(DP_WORK, "labels.npy"), labels)
    print(json.dumps(dict(rank=mesh.rank, world=mesh.world_size,
                          backend=torch.distributed.get_backend(), losses=run["losses"],
                          launches=run["launches"], serve_launches=serve_counts,
                          refused=refused)), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def spawn_workers(args, kind: str, envs: list, timeout: int = 600) -> list:
    """Run this script as ``--dp-worker kind`` once a given env; returns
    each process's JSON line, failing the run if one fails."""
    script = os.path.abspath(__file__)
    root = os.path.dirname(script)
    procs = [subprocess.Popen(
        [sys.executable, script, "--dp-worker", kind, "--depth", str(args.depth),
         "--seed", str(args.seed)],
        env=dict(os.environ, PYTHONPATH=root, GLOO_SOCKET_IFNAME="lo", **env), cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for env in envs]
    lines = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                fail(f"data-parallel worker ({kind}) exited {p.returncode}: {out[-3000:]}")
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return lines


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def update_errors(run: dict, ref: dict, start: dict) -> list:
    """Per tensor |d_run - d_ref| / |d_ref| of the updates (after - start)."""
    out = []
    for n, p0 in start.items():
        d_ref = ref["params"][n] - p0
        out.append(float((run["params"][n] - p0 - d_ref).norm())
                   / max(float(d_ref.norm()), 1e-30))
    return sorted(out)


def phase_data_parallel(args) -> dict:
    """Data parallel on the one card (parallel/mesh.py): two gloo processes,
    each bench.py's model (144^3, depth 24, bf16, dropout 0.5) at batch 1 a
    rank, two steps of a global batch of 2 against one process's two
    batch-2 steps (losses within phase 4's bf16 bar, 1e-3 relative, or 3x
    the spread of one process on an input moved by one bf16 step; the
    parameter updates, worst and median tensor, within 3x that spread's);
    then ``predict_volume(mesh=..., capture=False)`` of a 200^3 volume over
    the two ranks against one process (argmax agreement >= 0.99999 where the
    single run's accumulated top-two margin > 0.1); each gloo rank's
    ``capture=True`` calls refused (gloo's collectives run through the
    host). Then through ``maybe_distributed_init`` under torchrun's env,
    NCCL at world size 1 with ``always_reduce`` (``dp_nccl_capture``): an
    NCCL all-reduce, the captured train steps against the eager ones on the
    same mesh (first loss equal, the second within the bf16 bar above),
    timed in turns, the captured eval step against the eager one (loss
    within that bar), and the captured ``predict_volume(mesh=...)`` against
    ``capture=False`` (labels equal on every voxel). Each rank's launches
    are checked. Returns the launches by path."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    shutil.rmtree(DP_WORK, ignore_errors=True)
    os.makedirs(DP_WORK)
    port = free_port()
    ranks = spawn_workers(args, "gloo", [dict(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                                        JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r))
                                   for r in range(2)])
    gloo_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    (nccl,) = spawn_workers(args, "nccl", [dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))])
    nccl_s = time.perf_counter() - t1
    one = dp_steps(args, "cuda")
    moved = dp_steps(args, "cuda", nudge=2.0 ** -8)  # one bf16 step, as phase 4
    start = {n: p.detach().float().cpu() for n, p in bench.build(
        "cuda", PATCH, args.depth, args.seed)[0].model.named_parameters()}
    dp = dict(params=torch.load(os.path.join(DP_WORK, "params.pt")), losses=ranks[0]["losses"])
    errs, spread = update_errors(dp, one, start), update_errors(moved, one, start)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(dp["losses"], one["losses"])]
    moved_rel = [abs(a - b) / abs(b) for a, b in zip(moved["losses"], one["losses"])]

    net = get_net("HDenseFormer_32", 2, N_CLS, (PATCH,) * 3, transformer_depth=args.depth,
                  dtype=torch.bfloat16, device="cuda")
    init_weights(net, torch.Generator().manual_seed(args.seed))
    image = PETandCTNormalize()({"image": synthetic_volume(args.seed)})["image"]
    single = predict_volume(net, image, (PATCH,) * 3, (STEP,) * 3, N_CLS, window_batch=WINDOWS)
    acc = single_accumulator(net, image)
    top = acc.topk(2, dim=-1).values
    decided = (top[..., 0] - top[..., 1] > 0.1).cpu().numpy()
    sharded = np.load(os.path.join(DP_WORK, "labels.npy"))
    same = sharded == single
    expect_step = {k: 2 * v for k, v in hdf_expect(args, train=True).items()}
    expect_serve = hdf_expect(args)
    rec = dict(net="HDenseFormer_32", patch=PATCH, depth=args.depth, dtype="bfloat16",
               batch_per_rank=1, ranks=[{k: r[k] for k in ("rank", "world", "backend", "losses")}
                                        for r in ranks],
               one_process_losses=one["losses"], loss_rel=loss_rel, moved_loss_rel=moved_rel,
               update_rel_worst=errs[-1], update_rel_median=errs[len(errs) // 2],
               moved_update_rel_worst=spread[-1], moved_update_rel_median=spread[len(spread) // 2],
               launches_by_rank=[r["launches"] for r in ranks],
               serve_launches_by_rank=[r["serve_launches"] for r in ranks],
               refused_by_rank=[r["refused"] for r in ranks], nccl_world_1=nccl,
               sharded_200_agreement=float(same.mean()),
               sharded_200_agreement_margin_gt_0p1=float(same[decided].mean()),
               decided_fraction=float(decided.mean()), gloo_s=gloo_s, nccl_s=nccl_s,
               seconds=time.perf_counter() - t0)
    emit("data_parallel", **rec)
    loss_bar = max(1e-3, 3 * max(moved_rel))
    if max(loss_rel) > loss_bar or ranks[0]["losses"] != ranks[1]["losses"]:
        fail(f"two ranks against one process: losses {loss_rel} (bar {loss_bar}), ranks "
             f"{ranks[0]['losses']} / {ranks[1]['losses']}")
    if errs[-1] > 3 * spread[-1] or errs[len(errs) // 2] > 3 * spread[len(spread) // 2]:
        fail(f"two ranks against one process: updates {errs[-1]}, {errs[len(errs) // 2]} "
             f"against 3x {spread[-1]}, {spread[len(spread) // 2]}")
    if any(c != expect_step for c in [r["launches"] for r in ranks] + list(
            nccl["launches"].values()) + [one["launches"]]):
        fail(f"data-parallel steps launched {[r['launches'] for r in ranks]}, NCCL "
             f"{nccl['launches']}, one process {one['launches']}; expected {expect_step} "
             "(captured: the warm-up's and the capture's)")
    if any(r["serve_launches"] != expect_serve for r in ranks):
        fail(f"sharded serving launched {[r['serve_launches'] for r in ranks]}, expected "
             f"{expect_serve} a rank (its 4 windows in one call)")
    if any("capture=False" not in r["refused"][call] for r in ranks for call in r["refused"]):
        fail(f"gloo on a card with capture=True: {[r['refused'] for r in ranks]}, expected "
             "refusals that name capture=False")
    eager, captured = nccl["losses"]["eager"], nccl["losses"]["captured"]
    eval_rel = abs(nccl["eval"]["captured"]["loss"] - nccl["eval"]["eager"]["loss"]) / abs(
        nccl["eval"]["eager"]["loss"])
    if (nccl["backend"] != "nccl" or nccl["all_reduce"] != [1.0, 1.0, 1.0]
            or not np.isfinite(eager + captured).all() or captured[0] != eager[0]
            or abs(captured[1] - eager[1]) / abs(eager[1]) > loss_bar or eval_rel > loss_bar
            or nccl["serve_labels_equal"] != 1.0
            or nccl["serve_launches"] != {k: 4 * v for k, v in expect_serve.items()}):
        fail(f"NCCL world of one, captured against eager (loss bar {loss_bar}, serving "
             f"launches expected 4x {expect_serve}): {nccl}")
    if rec["sharded_200_agreement_margin_gt_0p1"] < 0.99999:
        fail(f"sharded 200^3 labels agree with one process on {same[decided].mean()} of the "
             "decided voxels")
    shutil.rmtree(DP_WORK, ignore_errors=True)
    del net, acc
    torch.cuda.empty_cache()
    by_rank = {k: sum(r["launches"][k] + r["serve_launches"][k] for r in ranks)
               for k in KERNELS}
    return {"data-parallel-2-ranks": by_rank,
            "data-parallel-nccl-1": {k: nccl["launches"]["captured"][k] + nccl["serve_launches"][k]
                                     for k in KERNELS}}


def single_accumulator(net, image) -> torch.Tensor:
    """One process's fp32 window accumulator of ``predict_volume`` (the
    labels are its argmax), to read each voxel's top-two margin."""
    from hdenseformer_tpu_torch.infer.sliding import (
        _lattice_pad_targets,
        _origins_array,
        accumulate_windows,
    )

    image_cl = np.moveaxis(np.asarray(image, np.float32), 0, -1)
    spatial = image_cl.shape[:-1]
    tgt = _lattice_pad_targets(spatial, (PATCH,) * 3, (STEP,) * 3)
    device = next(net.parameters()).device
    volume = torch.zeros(tuple(tgt) + image_cl.shape[-1:], device=device)
    volume[tuple(slice(0, s) for s in spatial)] = torch.from_numpy(image_cl).to(device)
    origins = _origins_array(cal_steps(spatial, (PATCH,) * 3, (STEP,) * 3))
    acc = accumulate_windows(net, volume, origins, np.ones(len(origins), np.float32),
                             (PATCH,) * 3, N_CLS, None, len(origins), capture=False)
    return acc[tuple(slice(0, s) for s in spatial)]


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
    expect_on = hdf_expect(argparse.Namespace(depth=depth), train=True, remat=True)
    if on["counts"] != expect_on or off["counts"] != hdf_expect(
            argparse.Namespace(depth=depth), train=True):
        fail(f"remat step launched {on['counts']}, plain {off['counts']}")
    if not (on["loss"] == off["loss"] and rec["generator_state_equal"]
            and ratios[worst] <= 1e-5):
        fail(f"remat vs plain step: {rec}")
    del runs, off, on
    torch.cuda.empty_cache()


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
    """Part (a): the shifted InstanceNorm forward and backward kernels against
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


def packed_vs_fine(tag: str, nets: dict, x, batch, expect: dict, step_expect: dict,
                   loss_name: str, use_ds: bool, bar: float, seed: int) -> dict:
    """One model, packed and fine, on the same weights: the forward's logits
    (the argmax agreement of phase 2: where fine's top-two margin > 0.1,
    ``bar``), a forward and a train step each timed in turns (packed, fine,
    fine, packed), peak memory, and each call's launches against ``expect``
    and ``step_expect`` (by layout). Returns the launches of the packed
    model's calls (its forward and its three steps)."""
    rec, outs, states = {}, {}, {}
    counts = dict.fromkeys(KERNELS, 0)
    step = make_train_step(get_loss(loss_name, use_ds=use_ds), N_CLS)
    for name, net in nets.items():
        net.eval()
        with torch.inference_mode():
            reset_counts()
            outs[name] = net(x)
            rec[name] = dict(launches_forward=read_counts())
        states[name] = TrainState(net, get_optimizer("Adam", LR, weight_decay=WEIGHT_DECAY,
                                                     params=net.parameters()))
        reset_counts()
        _, out = step(states[name], batch, torch.Generator(device="cuda").manual_seed(seed))
        rec[name].update(first_loss=float(out["loss"]), launches_step=read_counts())
        if name == "packed":
            counts = {k: rec[name]["launches_forward"][k] + rec[name]["launches_step"][k]
                      for k in KERNELS}
    cmp = compare_logits(outs["packed"][0] if isinstance(outs["packed"], list) else outs["packed"],
                         outs["fine"][0] if isinstance(outs["fine"], list) else outs["fine"])
    if not cmp["decided_fraction"]:  # random weights may leave no margin over 0.1
        cmp["argmax_agreement_margin_gt_0p1"] = None
    del outs
    for name in ("packed", "fine", "fine", "packed"):
        net = nets[name].eval()  # the step left it in training
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, ms = timed_forward(net, x)
            rec[name].setdefault("forward_ms", []).append(ms)
            rec[name]["forward_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        _, out = step(states[name], batch, torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        rec[name].setdefault("step_ms", []).append((time.perf_counter() - t0) * 1e3)
        rec[name]["step_peak_bytes"] = torch.cuda.max_memory_allocated()
        step_counts = read_counts()
        if name == "packed":
            counts = {k: counts[k] + step_counts[k] for k in KERNELS}
        rec[name].setdefault("losses", []).append(float(out["loss"]))
    emit("packed_vs_fine", model=tag, input=list(x.shape), batch=list(batch["image"].shape),
         dtype="bfloat16", packed=rec["packed"], fine=rec["fine"], logits=cmp, bar=bar)
    for name in ("packed", "fine"):
        if rec[name]["launches_forward"] != expect[name]:
            fail(f"{tag} {name} forward launched {rec[name]['launches_forward']}, expected "
                 f"{expect[name]}")
        if rec[name]["launches_step"] != step_expect[name]:
            fail(f"{tag} {name} step launched {rec[name]['launches_step']}, expected "
                 f"{step_expect[name]}")
        if not np.isfinite([rec[name]["first_loss"]] + rec[name]["losses"]).all():
            fail(f"{tag} {name}: losses {rec[name]['first_loss']}, {rec[name]['losses']}")
    decided = cmp["argmax_agreement_margin_gt_0p1"]
    if (decided is not None and decided < bar) or cmp["argmax_agreement"] < 0.99:
        fail(f"{tag} packed vs fine: {cmp}, bar {bar} where the margin > 0.1")
    del states
    torch.cuda.empty_cache()
    return counts


def phase_packed(args, gen) -> tuple:
    """The packed levels: (a) the shifted kernels alone; (b) HDenseFormer_32 at
    144^3, depth ``args.depth``, s2d=None (level 0 packed over (H, W)) against
    s2d=False on the same weights: 8 windows a forward, a batch-2 remat train
    step; (c) HDenseFormer_2D_32 at 384^2, batch 24 (level 0 at full rank);
    (d) Hecktor20Top1 with HECKTOR_LEVEL2 against its default (level 1 only),
    2 windows, a batch-2 remat step; (e) da_unet and TransBTS, their packed
    default against s2d=False, at the zoo phase's 144^3 and batch 2. Returns
    (the kernels' main numbers, the packed models' launches by path)."""
    t0 = time.perf_counter()
    main = shifted_kernel_checks(gen)
    by_path = {}
    bf16 = torch.bfloat16

    def weights_of(nets):
        init_weights(nets["packed"], torch.Generator().manual_seed(args.seed))
        nets["fine"].load_state_dict(nets["packed"].state_dict())
        return nets

    # (b) HDenseFormer_32, 144^3
    nets = weights_of({layout: get_net("HDenseFormer_32", 2, N_CLS, (PATCH,) * 3,
                                       transformer_depth=args.depth, dtype=bf16, s2d=s2d,
                                       device="cuda")
                       for layout, s2d in (("packed", None), ("fine", False))})
    if nets["packed"].packed != ((1, 2), None, None) or nets["fine"].packed != (None,) * 3:
        fail(f"HDenseFormer_32 packs {nets['packed'].packed}, fine {nets['fine'].packed}")
    x = torch.randn((WINDOWS, PATCH, PATCH, PATCH, 2), generator=gen, device="cuda")
    case = synthetic_case(args.seed, PATCH)
    batch = {k: v.repeat(2, 1, 1, 1, 1) for k, v in case.items()}
    by_path["packed-hdf32"] = packed_vs_fine(
        "HDenseFormer_32", nets, x, batch,
        {"packed": hdf_expect(args), "fine": hdf_expect(args, packed=False)},
        {"packed": hdf_expect(args, train=True, remat=True),
         "fine": hdf_expect(args, train=True, remat=True, packed=False)},
        "FocalLoss", True, 0.999, args.seed)
    del nets, x, case, batch
    # (c) HDenseFormer_2D_32, 384^2, 24 slices
    nets = weights_of({layout: get_net("HDenseFormer_2D_32", SLICE_CH, N_CLS, (SLICE, SLICE),
                                       transformer_depth=args.depth, dtype=bf16, s2d=s2d,
                                       device="cuda")
                       for layout, s2d in (("packed", None), ("fine", False))})
    if nets["packed"].packed != ((0, 1), None, None):
        fail(f"HDenseFormer_2D_32 packs {nets['packed'].packed}")
    batch = synthetic_slices(args.seed, SLICE_BATCH)
    by_path["packed-hdf2d32"] = packed_vs_fine(
        "HDenseFormer_2D_32", nets, batch["image"], batch,
        {"packed": hdf2d_expect(args), "fine": hdf2d_expect(args, packed=False)},
        {"packed": hdf2d_expect(args, train=True),
         "fine": hdf2d_expect(args, train=True, packed=False)},
        "FocalLoss", True, 0.999, args.seed)
    del nets, batch
    # (d) Hecktor20Top1: level 2 packed over W too, against the default
    nets = weights_of({layout: get_net("hecktor20top1", 2, N_CLS, (PATCH,) * 3, dtype=bf16,
                                       s2d=s2d, device="cuda")
                       for layout, s2d in (("packed", HECKTOR_LEVEL2), ("fine", None))})
    if nets["packed"].packed2 != (2,) or nets["fine"].packed2 is not None:
        fail("Hecktor20Top1's dict s2d did not pack level 2 over W")
    x = torch.randn((ZOO_BATCH, PATCH, PATCH, PATCH, 2), generator=gen, device="cuda")
    case = synthetic_case(args.seed, PATCH)
    batch = {k: v.repeat(2, 1, 1, 1, 1) for k, v in case.items()}
    # level 2's partial-rank convs shift with plain_to_shifted, no kernel: the
    # launches are the default's
    by_path["packed-hecktor-level2"] = packed_vs_fine(
        "Hecktor20Top1 {1: True, 2: (2,)} vs default", nets, x, batch,
        dict.fromkeys(("packed", "fine"), HECKTOR_EXPECT),
        dict.fromkeys(("packed", "fine"), HECKTOR_TRAIN_EXPECT),
        "FocalLoss", False, 0.999, args.seed)
    del nets
    # (e) the 3-D zoo's packed defaults: da_unet (level 0), TransBTS (levels 0-1);
    # their packed BatchNorm and GroupNorm keep bf16 where the fine ones return
    # fp32 (as JAX's), so the agreement bar is 0.99
    for name in ("da_unet", "TransBTS"):
        nets = weights_of({layout: get_net(name, 2, N_CLS, (PATCH,) * 3, dtype=bf16, s2d=s2d,
                                           device="cuda")
                           for layout, s2d in (("packed", None), ("fine", False))})
        by_path[f"packed-{name}"] = packed_vs_fine(
            name, nets, x, batch,
            {"packed": zoo_expect(name, False), "fine": zoo_expect(name, False, packed=False)},
            {"packed": zoo_expect(name, True), "fine": zoo_expect(name, True, packed=False)},
            "FocalLoss", False, 0.99, args.seed)
        del nets
    del x, case, batch
    torch.cuda.empty_cache()
    emit("packed_phase", seconds=time.perf_counter() - t0)
    return main, by_path


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


def zoo_expect(name: str, train: bool, packed: bool = True) -> dict:
    """Launches of one zoo forward (or train step): UNETR's InstanceNorms
    (one backward each in a step); packed (the default), TransBTS's InitConv,
    the one packed conv that is not of the shift-free pair, shifts its packed
    input once (no backward: the input needs no gradient); none for the
    others (the DAUNet family's packed level 0 runs the shift-free pair and
    plain BatchNorms)."""
    expect = dict.fromkeys(KERNELS, 0)
    if name == "TransBTS" and packed:
        expect["shift_pack"] = 1
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
    not move in the eval forward and must move in the step. UNETR's and
    TransBTS's eval forwards also run through the plain versions
    (``use_kernels=False``: no kernel may launch, TransBTS's packed InitConv
    takes the half-shift's plain version) from the same weights (phase 2's
    bars). Returns UNETR's launches (its forward and steps)."""
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
            mha.launches = 0
            logits, first_ms = timed_forward(net, x)
            fwd_counts = read_counts()
            mha_forward = mha.launches
            _, warm_ms = timed_forward(net, x)
        rec = dict(net=name, params=sum(p.numel() for p in net.parameters()),
                   batch_norm_buffers=len(fresh), eval_first_ms=first_ms, eval_warm_ms=warm_ms,
                   launches_forward=fwd_counts)
        if name in ("TransBTS", "unetr"):
            # layers.self_attention: bf16 heads of 64 take the fused kernel (ops/mha.py); the
            # plain build below runs the plain math, fp32 scores
            rec.update(attention="fused kernel (ops/mha.py)", mha_launches_forward=mha_forward)
            if mha_forward != {"TransBTS": 4, "unetr": 12}[name]:
                fail(f"{name} forward launched the fused attention {mha_forward} times")
        if name in ("TransBTS", "unetr"):
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
        if name in ("TransBTS", "unetr"):
            cmp = rec["kernels_vs_plain"]
            if any(rec["launches_plain_forward"].values()) or cmp["argmax_agreement"] < 0.99 or (
                    cmp["argmax_agreement_margin_gt_0p1"] < 0.999):
                fail(f"{name} kernels vs plain path: {cmp}, plain launched "
                     f"{rec['launches_plain_forward']}")
        if name == "unetr":
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
        def train_fn(mode, **knobs):
            c = run.config("da_unet", 1, version=f"smoke-zoo-{mode}-")
            return run.train(c, paths, **knobs), c

        none = {k: 0 for k in KERNELS}
        runs = captured_and_eager("zoo-da_unet", train_fn, none, none, extra_forwards=1)
        cfg = runs["captured"]["cfg"]
        reset_counts()
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
        counts = {k: v + runs["captured"]["counts"][k] for k, v in counts.items()}
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


def hdf2d_expect(args, train: bool = False, packed: bool = True) -> dict:
    """Launches of one HDenseFormer_2D_32 forward at PI-CAI22 (3 modality
    paths of depth attentions, 18 InstanceNorms), or of one train step with
    get_net's remat: the forward and its recompute, a backward per norm."""
    n = 2 if train else 1
    shifted = HDF_SHIFTED if packed else 0  # level 0's first BasicConvs, at full rank
    return {"dense_attention": n * SLICE_CH * args.depth,
            "instance_norm_relu": n * (HDF_NORMS - shifted),
            "shift_pack": 0, "shift_pack_backward": 0,
            "instance_norm_relu_backward": HDF_NORMS - shifted if train else 0,
            "instance_norm_relu_shifted": n * shifted,
            "instance_norm_relu_shifted_backward": shifted if train else 0}


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
    rec.update(attention_bound(ATTN_2D, torch.bfloat16))
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
    captured = captured_2d_steps(state, step, batch, g, train_expect)
    del state, step, net, batch
    torch.cuda.empty_cache()
    return {"2d-serve": counts,
            "2d-train": {k: sum(st["launches"][k] for st in steps) for k in KERNELS},
            "2d-train-captured": captured}


def captured_2d_steps(state, eager_step, batch, g, train_expect: dict) -> dict:
    """The batch-24 step of HDenseFormer_2D_32 as the trainer runs it
    (``CapturedTrainStep``), against the eager step on the same state in
    turns (captured, eager, eager, captured), each a chained window of 4
    steps ended by reading the loss: ms a step of each, and the capture's
    first call. Returns the captured launches (a warm-up's and a
    capture's)."""
    from hdenseformer_tpu_torch.train.loop import CapturedTrainStep

    captured = CapturedTrainStep(get_loss("FocalLoss", use_ds=True), N_CLS)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, out = captured(state, batch, g)
    float(out["loss"])
    first_ms = (time.perf_counter() - t) * 1e3
    counts = read_counts()

    def window(step) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            _, out = step(state, batch, g)
        float(out["loss"])
        return (time.perf_counter() - t0) * 1e3 / 4

    turns = [[mode, window(captured if mode == "captured" else eager_step)]
             for mode in ("captured", "eager", "eager", "captured")]
    emit("hdenseformer_2d_captured", batch=SLICE_BATCH, remat=state.model.remat,
         first_call_ms=first_ms, ms_per_step_in_turns=turns, launches_at_capture=counts)
    if counts != {k: 2 * v for k, v in train_expect.items()}:
        fail(f"the captured 2-D step launched {counts}, not a warm-up's and a capture's "
             f"{train_expect}")
    return counts


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
    ``predict_case_2d`` of 2 synthetic volumes of 30 x 400^2 (chunks of 24,
    the last 6 padded to 24; each slice resized to 384^2 and the labels back
    to 400^2), captured (one graph for every chunk: its warm-up and capture
    count two forwards' launches) and eager (``capture=False``) in turns:
    seconds a volume of each, slices/s, labels of the two equal, and equal
    to a direct argmax of the model's logits on the same preprocessed
    slices, chunked and padded alike, resized back on the host; then dice
    and HD95 per volume. Returns the launches of the run."""
    from hdenseformer_tpu_torch.infer.slices import predict_case_2d, preprocess_slices

    t0 = time.perf_counter()
    paths = write_slice_cases(os.path.join(work, "slices"), JOURNEY_SLICES, args.seed)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        def train_fn(mode, capture=True, move=False):
            cfg = get_config("PI-CAI22", net_name="HDenseFormer_2D_32", data_path="slices",
                             n_epoch=1, fold_num=3, current_fold=1, seed=args.seed,
                             transformer_depth=args.depth, version=f"smoke-2d-{mode}")
            seg_cls = moved(NpySemanticSeg) if move else NpySemanticSeg
            seg = seg_cls(**cfg.init_trainer_kwargs(), device="cuda", capture=capture)
            train, val = get_cross_validation_by_sample(paths, cfg.fold_num, cfg.current_fold,
                                                        shuffle_seed=cfg.seed)
            seg.trainer(train, val, 1, **cfg.setup_trainer_kwargs())
            return seg, cfg

        runs = captured_and_eager("2d-journey", train_fn, hdf2d_expect(args),
                                  hdf2d_expect(args, train=True))
        seg, cfg = runs["captured"]["seg"], runs["captured"]["cfg"]
        train, val = get_cross_validation_by_sample(paths, cfg.fold_num, cfg.current_fold,
                                                    shuffle_seed=cfg.seed)
        train_s, train_counts = runs["captured"]["wall_s"], runs["captured"]["counts"]
        epochs = runs["captured"]["epochs"]
    finally:
        os.chdir(cwd)
    model = seg.state.model.eval()
    volumes, rows = {"captured": [], "eager": []}, []
    predict_counts = {}
    for i in range(2):
        image, gt = mr_slices(args.seed + 200 + i, JOURNEY_VOLUME)
        preds = {}
        for mode in ("captured", "eager") if i == 0 else ("eager", "captured"):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            preds[mode] = predict_case_2d(model, image, (SLICE, SLICE), N_CLS, SLICE_CH,
                                          slice_batch=SLICE_BATCH, capture=mode == "captured")
            torch.cuda.synchronize()
            volumes[mode].append(time.perf_counter() - t)
            counts = read_counts()
            predict_counts[mode] = {k: predict_counts.get(mode, {}).get(k, 0) + v
                                    for k, v in counts.items()}
        pred = preds["captured"]
        rows.append(dict(dice=multi_dice(gt, pred, 1)[1], hd95=multi_hd(gt, pred, 1)[1],
                         image=image, pred=pred,
                         equal_eager=bool(np.array_equal(pred, preds["eager"]))))
    # a direct argmax of the model's logits on the same slices, chunk by chunk,
    # the last chunk padded with zeros as predict_case_2d pads it
    direct_equal = []
    d, h, w = JOURNEY_VOLUME
    idx_h = np.minimum(np.floor(np.arange(h) * SLICE / h).astype(int), SLICE - 1)
    idx_w = np.minimum(np.floor(np.arange(w) * SLICE / w).astype(int), SLICE - 1)
    chunks = -(-d // SLICE_BATCH)
    with torch.inference_mode():
        for row in rows:
            stack = preprocess_slices(row.pop("image"), (SLICE, SLICE), N_CLS, SLICE_CH)
            stack = np.concatenate([stack, np.zeros((chunks * SLICE_BATCH - d,)
                                                    + stack.shape[1:], stack.dtype)])
            labels = np.concatenate([
                model(torch.from_numpy(stack[s:s + SLICE_BATCH]).cuda())[0].float()
                .argmax(-1).cpu().numpy() for s in range(0, len(stack), SLICE_BATCH)])[:d]
            direct = labels[:, idx_h[:, None], idx_w[None, :]].astype(np.uint8)
            direct_equal.append(bool(np.array_equal(direct, row.pop("pred"))))
    forward = hdf2d_expect(args)
    want = {"captured": {k: 2 * v for k, v in forward.items()},
            "eager": {k: 2 * chunks * v for k, v in forward.items()}}
    rec = dict(net="HDenseFormer_2D_32", case_format="npy", slices=JOURNEY_SLICES,
               train_cases=len(train), val_cases=len(val), epochs=epochs, train_s=train_s,
               launches_train_captured=train_counts, volume=[SLICE_CH, *JOURNEY_VOLUME],
               seconds_per_volume=volumes["captured"], eager_seconds_per_volume=volumes["eager"],
               slices_per_s=[d / s for s in volumes["captured"]],
               launches_predict=predict_counts, labels_equal_direct_argmax=direct_equal,
               eval_rows=rows, seconds=time.perf_counter() - t0)
    emit("journey_2d", **rec)
    if (predict_counts != want or not all(direct_equal)
            or not all(r["equal_eager"] for r in rows)):
        fail(f"predict_case_2d launched {predict_counts} (expected {want}); labels equal to "
             f"the direct argmax: {direct_equal}, captured equal to eager: "
             f"{[r['equal_eager'] for r in rows]}")
    if not np.isfinite(epochs[0]["train_loss"]) or len(rows) != 2:
        fail(f"the 2-D journey: epochs {epochs}, eval rows {rows}")
    return {k: train_counts[k] + predict_counts["captured"][k] for k in KERNELS}


def npy_reader(path: str, key: str) -> np.ndarray:
    """One volume of a case directory holding ``<key>.npy`` per key: this
    phase's case format on a machine without h5py."""
    f = os.path.join(path, key + ".npy")
    if not os.path.exists(f):
        raise KeyError(key)
    return np.load(f).astype(np.float32)


class StepLosses:
    """A ``SemanticSeg`` mixin: keeps each train step's loss (a tensor on the
    card, read after the run, so the loop waits for nothing more) in
    ``step_losses``, and marks each train step and epoch for the profiler
    (``chip_smoke_train_step`` / ``chip_smoke_train_epoch``)."""

    def _run_epoch(self, state, loader, step_fn, epoch, generators, train, mesh=None):
        if not train:
            return super()._run_epoch(state, loader, step_fn, epoch, generators, train, mesh)
        losses = self.__dict__.setdefault("step_losses", [])

        def recorded(*step_args):
            with torch.profiler.record_function("chip_smoke_train_step"):
                state, metrics = step_fn(*step_args)
            losses.append(metrics["loss"])
            return state, metrics

        with torch.profiler.record_function("chip_smoke_train_epoch"):
            return super()._run_epoch(state, loader, recorded, epoch, generators, train, mesh)


class NpySemanticSeg(StepLosses, SemanticSeg):
    reader = staticmethod(npy_reader)


class HdfSemanticSeg(StepLosses, SemanticSeg):
    pass


MOVE = 2.0 ** -8  # the moved input: a relative N(0, 2^-8) factor, about one bf16 step


def moved(seg_cls):
    """``seg_cls`` reading every image (key ``ct``) moved by a factor 1 +
    MOVE * N(0, 1) seeded by the case's path: the bars' spread, the
    network's own sensitivity to one rounding of its input."""
    base = seg_cls.reader

    def reader(path: str, key: str) -> np.ndarray:
        arr = base(path, key)
        if key != "ct":
            return arr
        rng = np.random.default_rng(zlib.crc32(path.encode()))
        return (arr * (1 + MOVE * rng.standard_normal(arr.shape))).astype(np.float32)

    return type("Moved" + seg_cls.__name__, (seg_cls,), {"reader": staticmethod(reader)})


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
        self.seg_cls = HdfSemanticSeg if case_format == "hdf5" else NpySemanticSeg

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

    def train(self, cfg, paths, move: bool = False, **knobs):
        """Train ``cfg``'s fold 1 (the CLI's calls); ``knobs`` go to
        ``SemanticSeg`` (``capture``, ``device_augment``), ``move`` reads
        moved images. Where cases are ``.hdf5`` and no knob is given the
        CLI runs it, its trainer made as ``HdfSemanticSeg`` so that the step
        losses are kept as on the other route. Returns the trainer."""
        if self.case_format == "hdf5" and not knobs and not move:
            made = []

            class Kept(HdfSemanticSeg):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    made.append(self)

            with unittest.mock.patch.object(train_loop, "SemanticSeg", Kept):
                cli.main(["-m", "train", "--data-path", cfg.data_path, "--fold", "1",
                          "--epochs", str(cfg.n_epoch)] + self.cli_args(cfg))
            if len(made) != 1:
                fail(f"the CLI made {len(made)} trainers for one fold")
            return made[0]
        seg_cls = moved(self.seg_cls) if move else self.seg_cls
        seg = seg_cls(**cfg.init_trainer_kwargs(), device=self.device, **knobs)
        cli._report_params_flops(seg, cfg)
        train, val = self.split(cfg, paths)
        seg.trainer(train, val, 1, **cfg.setup_trainer_kwargs())
        return seg

    def resume(self, cfg, paths, ckpt: str, epochs: int, profile_dir=None):
        """The resumed run, traced by ``profiler_trace(profile_dir)`` as the
        CLI's ``--profile`` traces a fold's training; returns the trainer and
        the trace's path."""
        seg = self.seg_cls(**dict(cfg.init_trainer_kwargs(), n_epoch=epochs, pre_trained=True,
                                  ckpt_point=True, weight_path=ckpt), device=self.device)
        train, val = self.split(cfg, paths)
        with profiler_trace(profile_dir) as trace:
            seg.trainer(train, val, 1, **cfg.setup_trainer_kwargs())
        return seg, trace

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
                        val_steps=int(v["time/val/steps"]), step_s=tr_s / steps,
                        loader_wait_share=v["time/train/loader_wait_seconds"] / tr_s,
                        train_graphs=int(v["time/train/graphs_captured"]),
                        val_graphs=int(v["time/val/graphs_captured"])))
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


def captured_launches(tag: str, counts: dict, epochs: list, train_step: dict, forward: dict,
                      extra_forwards: int = 0) -> dict:
    """Check a captured trainer run's launches: each train graph's warm-up
    and capture run one train step through the wrappers, each eval graph's
    one forward each, ``extra_forwards`` eager forwards besides (the
    startup report's); the replays launch nothing through them (their
    kernels run inside the graphs). Returns the count by graph and replay."""
    train_graphs = sum(r["train_graphs"] for r in epochs)
    eval_graphs = sum(r["val_graphs"] for r in epochs)
    want = {k: 2 * train_graphs * train_step[k] + (2 * eval_graphs + extra_forwards) * forward[k]
            for k in counts}
    if counts != want:
        fail(f"{tag}: the captured run launched {counts}, expected {want} ({train_graphs} train "
             f"and {eval_graphs} eval graphs, {extra_forwards} eager forwards)")
    if not train_graphs or not eval_graphs:
        fail(f"{tag}: the run captured {train_graphs} train and {eval_graphs} eval graphs")
    return dict(train_graphs=train_graphs, eval_graphs=eval_graphs,
                launches_at_capture_per_train_graph=train_step,
                train_replays=sum(r["train_steps"] for r in epochs),
                eval_replays=sum(r["val_steps"] for r in epochs))


def loss_bars(tag: str, runs: dict) -> dict:
    """The captured run's step losses against the eager run's, with the graph
    phase's bars: the first within 1e-3 relative (phase 4's bf16 bar), each later
    one within that or 3x the largest spread of the run on moved inputs
    against the eager run (Adam turns rounding into whole-lr moves, so two
    correct runs drift apart step by step)."""
    losses = {mode: getattr(r["seg"], "step_losses", None) for mode, r in runs.items()}
    if not all(losses.values()):
        fail(f"{tag}: a run kept no step losses: {sorted(m for m, v in losses.items() if not v)}")
    cap, eager, mov = (torch.stack(losses[m]).tolist() for m in ("captured", "eager", "moved"))
    if not (len(cap) == len(eager) == len(mov)) or not np.isfinite(cap + eager + mov).all():
        fail(f"{tag}: step losses captured {cap}, eager {eager}, moved {mov}")
    rel = [abs(a - b) / abs(b) for a, b in zip(cap, eager)]
    spread = [abs(a - b) / abs(b) for a, b in zip(mov, eager)]
    bars = [1e-3] + [max(1e-3, 3 * max(spread))] * (len(rel) - 1)
    if any(r > b for r, b in zip(rel, bars)):
        fail(f"{tag}: captured against eager step losses {rel}, bars {bars}")
    return dict(captured_losses=cap, eager_losses=eager, moved_input_losses=mov, loss_rel=rel,
                moved_input_loss_rel=spread, loss_bars=bars)


def captured_and_eager(tag: str, train_fn, forward: dict, train_step: dict,
                       extra_forwards: int = 0) -> dict:
    """A journey's training run as the trainer runs it (captured: the main
    run), then in turns the same fold eagerly (``capture=False``) and
    eagerly on moved inputs (the bars' spread), each in its own directories.
    ``train_fn(mode, **knobs) -> (trainer or None, cfg)``. Each run's
    launches are checked (captured: at capture; eager: ``train_step`` a
    step and ``forward`` an eval step); the step losses are held to
    ``loss_bars``; steady step, loader-wait share, graphs and peak memory
    are printed side by side. Returns the runs."""
    runs = {}
    for mode, knobs in (("captured", {}), ("eager", dict(capture=False)),
                        ("moved", dict(capture=False, move=True))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        seg, cfg = train_fn(mode, **knobs)
        wall = time.perf_counter() - t0
        counts = read_counts()
        epochs = epoch_records(cfg)
        runs[mode] = dict(seg=seg, cfg=cfg, counts=counts, epochs=epochs, wall_s=wall,
                          peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                          peak_reserved_bytes=torch.cuda.max_memory_reserved())
    cap = captured_launches(tag, runs["captured"]["counts"], runs["captured"]["epochs"],
                            train_step, forward, extra_forwards)
    for mode in ("eager", "moved"):
        ep = runs[mode]["epochs"]
        step = per_train_step(runs[mode]["counts"], sum(r["train_steps"] for r in ep),
                              sum(r["val_steps"] for r in ep) + extra_forwards, forward)
        if step != train_step or any(r["train_graphs"] or r["val_graphs"] for r in ep):
            fail(f"{tag}: the {mode} run launched {step} a step (expected {train_step}), "
                 f"graphs {[(r['train_graphs'], r['val_graphs']) for r in ep]}")
    bars = loss_bars(tag, runs)
    side = {mode: dict(wall_s=r["wall_s"], step_s=[e["step_s"] for e in r["epochs"]],
                       loader_wait_share=[e["loader_wait_share"] for e in r["epochs"]],
                       graphs=[(e["train_graphs"], e["val_graphs"]) for e in r["epochs"]],
                       peak_allocated_bytes=r["peak_allocated_bytes"],
                       peak_reserved_bytes=r["peak_reserved_bytes"],
                       train_losses=[e["train_loss"] for e in r["epochs"]],
                       val_losses=[e["val_loss"] for e in r["epochs"]])
            for mode, r in runs.items()}
    emit("captured_vs_eager", journey=tag, launches_captured=runs["captured"]["counts"],
         capture=cap, runs=side, **bars)
    return runs


# the port's kernels by the names the profiler gives them
TRACE_KERNELS = {"dense_attention": "dense_attention_kernel",
                 "instance_norm_relu": "normalize_kernel",
                 "instance_norm_relu_backward": "bwd_persistent_kernel"}


def profile_check(trace: str, epochs: list, resume_s: float) -> None:
    """Phase 5's resumed epochs ran under ``profiler_trace``: the trace file
    exists and names the attention, InstanceNorm forward and backward
    kernels, each also in its shifted instantiation (``kShifted`` true), and
    the epochs' step time beside the unprofiled epochs'."""
    if not trace or not os.path.exists(trace):
        fail(f"the profiled resume wrote no trace ({trace})")
    with open(trace) as f:
        names = set(re.findall(r'"name":\s*"([^"]*)"', f.read()))
    kernels = sorted(n for n in names if any(k in n for k in TRACE_KERNELS.values()))
    named = {k: any(sub in n for n in kernels) for k, sub in TRACE_KERNELS.items()}
    # a template's bool argument, demangled
    shifted = {k: any(sub in n and re.search(r"(true|\(bool\)1|, 1)>", n) for n in kernels)
               for k, sub in (("instance_norm_relu_shifted", "normalize_kernel"),
                              ("instance_norm_relu_shifted_backward", "bwd_persistent_kernel"))}
    emit("profile", trace=os.path.basename(trace), trace_mb=os.path.getsize(trace) / 1e6,
         kernels_named=named, shifted_named=shifted, kernel_names=kernels[:12],
         profiled_epoch_step_s=[r["step_s"] for r in epochs[-RESUME_EPOCHS:]],
         unprofiled_epoch_step_s=[r["step_s"] for r in epochs[:-RESUME_EPOCHS]],
         profiled_resume_wall_s=resume_s)
    if not all(named.values()) or not all(shifted.values()):
        fail(f"the trace lacks a kernel of the port: {named}, shifted {shifted}, {kernels}")


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


def trace_idle(trace: str) -> dict:
    """The card's idle share over the replayed train steps of a profiled
    captured run, from its trace. A step's window runs from the start of
    its host span to the end of the last device event (kernel, copy, set)
    that a runtime call inside the span queued (the trace's correlation
    ids): the batch copied into the graph's buffers, the replay, the cloned
    outputs; the loader's wait and copies before the next step stay out.
    The run's first step (the warm-up and the capture) is left out. Idle is
    1 - the device's busy time over the union of the windows; beside it the
    idle share of the whole train epochs, capture and loader waits
    included."""
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("name") == name and e.get("cat") == "user_annotation")

    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    queued = {}  # correlation id -> end of the last device event it queued
    for e in dev:
        c = e.get("args", {}).get("correlation")
        queued[c] = max(queued.get(c, 0), e["ts"] + e["dur"])
    calls = sorted((e["ts"], e["args"]["correlation"]) for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {}))

    def busy(windows):
        """The device's busy time inside the union of ``windows`` and that union's length."""
        merged = []
        for a, b in sorted(windows):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        total, covered = sum(b - a for a, b in merged), 0.0
        for a, b in merged:
            end = a
            for lo, hi in device:
                lo, hi = max(lo, end), min(hi, b)
                if hi > lo:
                    covered, end = covered + hi - lo, hi
        return covered, total

    steps, epochs = spans("chip_smoke_train_step"), spans("chip_smoke_train_epoch")
    windows = []
    for a, b in steps[1:]:  # the first step captures
        ends = [queued[c] for t, c in calls if a <= t <= b and c in queued]
        if ends:
            windows.append((a, max(ends)))
    if len(windows) != len(steps) - 1 or len(windows) < 2 or not device:
        fail(f"the profiled run's trace holds {len(steps)} train steps in {len(epochs)} train "
             f"epochs, {len(windows)} replay windows with device work and {len(device)} "
             f"device events")
    replay_busy, replay_total = busy(windows)
    epoch_busy, epoch_total = busy(epochs)
    return dict(idle_share_replayed_steps=1 - replay_busy / replay_total,
                idle_share_train_epochs=1 - epoch_busy / epoch_total,
                replayed_steps=len(windows), replay_windows_ms=replay_total / 1e3,
                replay_busy_ms=replay_busy / 1e3, train_epochs=len(epochs),
                train_steps=len(steps))


def drive_trainer(args, run: TrainerRun, paths: list, tests: list) -> dict:
    on_card = run.device == "cuda"
    forward = hdf_expect(args)
    train_expect = hdf_expect(args, train=True, remat=True)  # the forward kernels run twice
    cfg = run.config("HDenseFormer_32", TRAIN_EPOCHS)

    def train_fn(mode, **knobs):
        c = cfg if mode == "captured" else run.config("HDenseFormer_32", TRAIN_EPOCHS,
                                                      version=f"smoke-{mode}-")
        return run.train(c, paths, **knobs), c

    # the startup report's forward, then an eval forward an epoch
    runs = captured_and_eager("trainer", train_fn, forward, train_expect, extra_forwards=1)
    counts, peak = runs["captured"]["counts"], runs["captured"]["peak_allocated_bytes"]
    train_s = runs["captured"]["wall_s"]
    ckpt_dir = os.path.join(cfg.output_dir, "fold1")
    best = get_weight_path(ckpt_dir)
    best_epoch = int(os.path.basename(best).split("-")[0].split("=")[1])

    reset_counts()
    t_resume = time.perf_counter()
    seg, trace = run.resume(cfg, paths, best, best_epoch + 1 + RESUME_EPOCHS,
                            profile_dir=os.path.join("trace", cfg.version))
    resume_s = time.perf_counter() - t_resume
    resume_counts = read_counts()
    kept = sorted(os.listdir(ckpt_dir))
    epochs = epoch_records(cfg)
    resume_capture = captured_launches("trainer resume", resume_counts, epochs[-RESUME_EPOCHS:],
                                       train_expect, forward)
    for rec in epochs:
        emit("trainer_epoch", net=cfg.net_name, **rec)
    steady = [r["step_s"] for r in epochs[1:]]
    emit("trainer", net=cfg.net_name, case_format=run.case_format, cases=len(paths),
         case_size=args.case, patch=args.patch, batch=cfg.batch_size, depth=args.depth,
         remat=cfg.remat, dtype="bfloat16" if cfg.use_fp16 else "float32",
         lr_scheduler=cfg.lr_scheduler, loss=cfg.loss_fun, train_wall_s=train_s,
         steady_step_s=statistics.mean(steady) if steady else None,
         loader_wait_share=[r["loader_wait_share"] for r in epochs],
         graphs_captured=[(r["train_graphs"], r["val_graphs"]) for r in epochs],
         peak_memory_bytes=peak, eager_peak_memory_bytes=runs["eager"]["peak_allocated_bytes"],
         launches=counts, launches_per_train_step_at_capture=train_expect,
         resume_capture=resume_capture, best_checkpoint_epoch=best_epoch,
         start_epoch_after_resume=seg.start_epoch, checkpoints_kept=len(kept))
    if on_card:
        profile_check(trace, epochs, resume_s)
        emit("trainer_idle", net=cfg.net_name, profiled="the resumed epochs, captured",
             **trace_idle(trace))
    if (len(kept) > 3 or seg.start_epoch != best_epoch + 1
            or len(epochs) != TRAIN_EPOCHS + RESUME_EPOCHS):
        fail(f"checkpoints {kept}, start_epoch {seg.start_epoch}, epochs {epochs}")
    if not all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in epochs):
        fail(f"trainer losses are not finite: {epochs}")

    save = os.path.join("seg", cfg.version)
    newest = get_weight_path(ckpt_dir)
    emit("trainer_cpu_resume", checkpoint=os.path.basename(newest), **cpu_resume(run, cfg, newest))
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
    # one window batch a volume, one shape: the first volume's warm-up and
    # capture launch through the wrappers, every batch after replays
    if on_card and infer_counts != {k: 2 * v for k, v in forward.items()}:
        fail(f"inference launched {infer_counts}, expected a warm-up and a capture of {forward}")

    # Hecktor20Top1, one epoch: the preset's remat (on), level 1 packed
    def hecktor_fn(mode, **knobs):
        c = run.config("hecktor20top1", 1, version="smoke-" if mode == "captured"
                       else f"smoke-{mode}-")
        return run.train(c, paths, **knobs), c

    hruns = captured_and_eager("trainer-hecktor20top1", hecktor_fn, HECKTOR_EXPECT,
                               HECKTOR_TRAIN_EXPECT, extra_forwards=1)
    hcfg, hcounts = hruns["captured"]["cfg"], hruns["captured"]["counts"]
    for rec in hruns["captured"]["epochs"]:
        emit("trainer_epoch", net=hcfg.net_name, **rec)
    emit("trainer_hecktor", launches=hcounts, launches_per_train_step=HECKTOR_TRAIN_EXPECT,
         loss=hcfg.loss_fun, deep_supervision=hcfg.use_ds, remat=hcfg.remat)
    # phase 5's first run alone (not the resumed epochs), as 5b runs it
    first_run = epochs[:TRAIN_EPOCHS]
    host = dict(steady_step_s=statistics.mean(r["step_s"] for r in first_run[1:]),
                loader_wait_share=[r["loader_wait_share"] for r in first_run],
                peak_memory_bytes=peak, launches_per_train_step=train_expect,
                train_wall_s=train_s)
    return ({"trainer": {k: counts[k] + resume_counts[k] + infer_counts[k] for k in counts},
             "trainer-hecktor20top1": hcounts}, host)


def cpu_resume(run: TrainerRun, cfg, ckpt: str) -> dict:
    """A captured run's checkpoint resumed on the CPU, as ``--device cpu``
    resumes it: the weights and the optimizer's state load into a CPU
    trainer's plain Adam (no capturable flag, host rates and counters,
    ``plain_state_dict``), which then takes a step (zero gradients: the
    moments and the coupled decay still move every weight)."""
    seg = run.seg_cls(**cfg.init_trainer_kwargs(), device="cpu")
    state = seg.load_pretrained(seg.build_state(), ckpt, ckpt_point=True)
    opt = state.optimizer
    plain = (all(not g.get("capturable", False) and isinstance(g["lr"], float)
                 for g in opt.param_groups)
             and all(st["step"].device.type == "cpu" for st in opt.state.values()))
    before = [p.detach().clone() for p in state.model.parameters()]
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    moved = sum(not torch.equal(p, q) for p, q in zip(state.model.parameters(), before))
    rec = dict(start_epoch=seg.start_epoch, step=state.step, plain_optimizer_state=plain,
               adam_states=len(opt.state), weights_moved_by_a_step=moved,
               weights=len(before))
    if not plain or len(opt.state) != len(before) or not moved or not state.step:
        fail(f"the captured run's checkpoint does not resume on the CPU: {rec}")
    return rec


def drive_device_augment(args, run: TrainerRun, paths: list, host: dict) -> dict:
    """Phase 5b: phase 5's first run (HDenseFormer_32, 2 epochs of fold 1 at
    the Hecktor21 preset) with ``device_augment=True``, through
    ``SemanticSeg`` (the CLI has no flag for it), captured and in turns
    eager and on moved inputs. Its steady step, loader wait and peak beside
    phase 5's (``host``); launches a train step equal phase 5's (the
    augmentation launches no custom kernel). Returns the captured run's
    launches."""
    forward = hdf_expect(args)

    def train_fn(mode, **knobs):
        c = run.config("HDenseFormer_32", TRAIN_EPOCHS, version=f"smoke-augment-{mode}-")
        return run.train(c, paths, device_augment=True, **knobs), c

    runs = captured_and_eager("trainer-device-augment", train_fn, forward,
                              host["launches_per_train_step"], extra_forwards=1)
    cfg, epochs = runs["captured"]["cfg"], runs["captured"]["epochs"]
    for rec in epochs:
        emit("trainer_epoch", net=cfg.net_name, device_augment=True, **rec)
    steady = [r["step_s"] for r in epochs[1:]]
    emit("trainer_device_augment", net=cfg.net_name, cases=len(paths), case_size=args.case,
         patch=args.patch, batch=cfg.batch_size, depth=args.depth, remat=cfg.remat,
         train_wall_s=runs["captured"]["wall_s"],
         steady_step_s=statistics.mean(steady) if steady else None,
         loader_wait_share=[r["loader_wait_share"] for r in epochs],
         graphs_captured=[(r["train_graphs"], r["val_graphs"]) for r in epochs],
         peak_memory_bytes=runs["captured"]["peak_allocated_bytes"],
         eager_peak_memory_bytes=runs["eager"]["peak_allocated_bytes"],
         launches=runs["captured"]["counts"], train_losses=[r["train_loss"] for r in epochs],
         host_augmentation=host)
    if len(epochs) != TRAIN_EPOCHS or not all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in epochs):
        fail(f"device_augment trainer epochs {epochs}")
    return runs["captured"]["counts"]


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
                  True: hdf_expect(args, train=True, remat=True)}
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
    ap.add_argument("--phase", choices=["all", "mha"], default="all",
                    help="mha: the environment and the fused attention's phase alone")
    ap.add_argument("--dp-worker", choices=["gloo", "nccl"], default=None,
                    help="run one rank of the data-parallel phase (the phase starts them)")
    args = ap.parse_args()
    args.patch, args.case, args.volume = PATCH, CASE, VOLUME
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.dp_worker:
        return dp_worker(args)
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
    by_path["graph-captured-step"] = phase_graph(args)
    by_path.update(phase_data_parallel(args))
    phase_remat_compare(args)
    remat_memory(args)
    remat_memory(args, "hecktor20top1")
    packed_main, packed_paths = phase_packed(args, gen)
    main_shapes.update(packed_main)
    by_path.update(packed_paths)
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
    ] + [dict(name="mha64", route="cuda", source="hdenseformer_tpu_torch/csrc/mha64.cu",
              replaces=None, **fused)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
