"""The training window: ``SemanticSeg._run_epoch`` epoch after epoch.

Set-up builds the trainer's objects as ``SemanticSeg.trainer`` does (the
model, Adam with coupled L2, the configuration's loss, the captured train
step, the generators, the shuffling loader over the cases and its
transforms) with the benchmark's weights and the family's starting buffers
(``weights.start``), then runs epoch 0 through the
same call and feed as the window: its first step warms up and captures the
step, and its first three steps are recorded for the check. The window
runs epochs 1, 2, ... with the poly rate set per epoch, until ``seconds``
have passed; it ends with the epoch in which they did, so every step of
every epoch counts.

The mix's ``device_augment`` picks the feed. True (3-D only): the loader
ships the raw cases and the step augments them on the device; the recorded
batches are named by a fingerprint of each raw image. False: the loader's
threads augment each sample on the host (the configuration's
``transform_2d``, or the mix's ``transform_3d``); the reference works the
batches out again from the loader's seeding rule and its own augmentation
(``reference.augment2d``, ``reference.augment3d``), and ``augment_gap``
says how far the recorded batches lie from them.

After the window the system is freed and the family's reference model runs
the three recorded steps from the same weights and buffers on the same
samples, with the family's loss.
"""
from __future__ import annotations

import functools
import gc
import time

import numpy as np
import torch

from portbench import check, families, flops, roofline, traffic, weights
from portbench.drivers import Context, memory_peak, reset_memory_peak, sync
from portbench.reference import augment, augment2d, augment3d, exact
from portbench.reference.train import run_steps
from portbench.trace import profiled, span, summarize

RECORDED = 3


class _Recorder:
    """The window's step call, recording its first three steps: the batch
    (a fingerprint of each raw image, or the augmented batch itself), the
    loss, the optimizer's first moment after step 1 and the weights after
    step 3."""

    def __init__(self, step, fingerprints=None):
        self.step, self.fingerprints = step, fingerprints
        self.batches, self.losses, self.first_moment, self.params = [], [], None, None

    def __call__(self, state, batch, *generators):
        n = len(self.losses)
        if n < RECORDED and self.fingerprints is not None:
            prints = batch["image"][:, 0, 0, :8, 0].cpu()
            self.batches.append([self.fingerprints.get(tuple(p.tolist())) for p in prints])
        elif n < RECORDED:
            self.batches.append({k: batch[k].clone() for k in ("image", "label")})
        state, metrics = self.step(state, batch, *generators)
        if n < RECORDED:
            self.losses.append(metrics["loss"])
        if n == 0:  # Adam's first moment after one step is (1 - beta1) times the gradient
            names = {p: name for name, p in state.model.named_parameters()}
            opt = state.optimizer
            self.first_moment = {
                names[p]: (opt.state[p]["exp_avg"] if "exp_avg" in opt.state.get(p, {})
                           else torch.zeros_like(p)) / (1.0 - group["betas"][0])
                for group in opt.param_groups for p in group["params"]}
        if n == RECORDED - 1:
            self.params = {name: p.detach().clone() for name, p in state.model.named_parameters()}
        return state, metrics


class _SpannedLoader:
    """The loader, each wait for its next batch inside a harness span."""

    def __init__(self, loader):
        self.loader = loader

    def epoch(self, epoch):
        batches = iter(self.loader.epoch(epoch))
        while True:
            with span("loader_wait"):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch


def case_batch(store: dict, paths, device) -> dict:
    """The reference's batch of the named raw cases: channels-last images,
    class labels, every sample real."""
    return {"image": torch.stack([torch.from_numpy(store[p][0]).movedim(0, -1)
                                  for p in paths]).to(device),
            "label": torch.stack([torch.from_numpy(store[p][1]) for p in paths]).to(device),
            "weight": torch.ones(len(paths), device=device)}


def host_batches(store: dict, cfg: dict, mix: dict, seed: int, device, steps: int = RECORDED,
                 sample_rng=augment2d.sample_rng, **augment_kw) -> list:
    """The first ``steps`` batches of epoch 0 of the host-augmented feed, as
    the reference works them out: the loader's order and each sample's
    generator ``sample_rng(seed, epoch, index)``, then ``reference.augment2d``
    with the configuration's ``transform_2d`` or ``reference.augment3d`` with
    the mix's ``transform_3d`` (``augment_kw`` such as ``flip_axes`` as
    there)."""
    tr, paths, ncls = cfg["train"], sorted(store), cfg["model"]["num_classes"]
    order = augment2d.epoch_order(len(paths), seed, 0)
    if len(cfg["model"]["image_size"]) == 2:
        augment_fn = functools.partial(augment2d.augment, transforms=tr["transform_2d"],
                                       num_classes=ncls, **augment_kw)
    else:
        augment_fn = functools.partial(augment3d.augment, transforms=mix["transform_3d"],
                                       num_classes=ncls, patch=tuple(cfg["patch_size"]),
                                       **augment_kw)
    out = []
    for t in range(steps):
        rows = [augment_fn(*store[paths[i]], sample_rng(seed, 0, int(i)))
                for i in order[t * tr["batch_size"]:(t + 1) * tr["batch_size"]]]
        out.append({"image": torch.from_numpy(np.stack([r[0] for r in rows])).to(device),
                    "onehot": torch.from_numpy(np.stack([r[1] for r in rows])).to(device),
                    "weight": torch.ones(len(rows), device=device)})
    return out


def run(ctx: Context) -> dict:
    from hdenseformer_tpu_torch.data.augment_device import augment_batch_3d
    from hdenseformer_tpu_torch.data.pipeline import BatchLoader, SegDataset
    from hdenseformer_tpu_torch.data.transforms import Compose, RawChannelsLast
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.train.loop import CapturedTrainStep, SemanticSeg, TrainState
    from hdenseformer_tpu_torch.train.state import (get_lr_scheduler, get_optimizer,
                                                    set_learning_rate)
    from hdenseformer_tpu_torch.utils.graphs import GraphCache

    cfg, mix, dev, tr = ctx.config, ctx.mix, ctx.device, ctx.config["train"]
    m, family = cfg["model"], families.of(cfg)
    on_device, is_3d = mix["device_augment"], len(m["image_size"]) == 3
    if on_device and not is_3d:
        raise ValueError("the system augments on the device in 3-D only")
    phases = {"imports": time.perf_counter() - ctx.t_start}
    store = {f"case{i:04d}": c for i, c in enumerate(traffic.train_cases(mix, ctx.seed, dev))}
    phases["cases"] = time.perf_counter() - ctx.t_start

    def reader(path, key):
        return store[path][0 if key == cfg["keys"][0] else 1]

    seg = SemanticSeg(
        net_name=m["name"], channels=m["in_channels"], num_classes=m["num_classes"],
        roi_number=None, input_shape=tuple(m["image_size"]), batch_size=tr["batch_size"],
        num_workers=mix["num_workers"], device=dev, lr=tr["lr"], n_epoch=tr["n_epoch"],
        weight_decay=tr["weight_decay"], use_fp16=cfg["compute_dtype"] == "bfloat16",
        transform_2d=tr.get("transform_2d"), transform_3d=mix.get("transform_3d"),
        patch_size=tuple(cfg["patch_size"]), step_size=tuple(cfg["step_size"]),
        key_touple=tuple(cfg["keys"]), seed=ctx.seed, device_augment=on_device,
        remat=cfg["remat"], s2d=cfg["s2d"], capture=True, **family.system_kwargs(cfg))
    start, buffers = weights.start(cfg, ctx.seed, dev)
    seg.model.load_state_dict({**start, **buffers}, strict=True)
    state = TrainState(seg.model, get_optimizer(tr["optimizer"], tr["lr"],
                                                weight_decay=tr["weight_decay"],
                                                params=seg.model.parameters()))
    criterion = get_loss(tr["loss"], use_ds=tr["use_ds"])
    patch, ncls = tuple(cfg["patch_size"]), m["num_classes"]
    if on_device:
        def augment_fn(generator, image, label):
            return augment_batch_3d(generator, image, label, patch, num_classes=ncls)

        transform = Compose([RawChannelsLast()])
        generators = (torch.Generator(device=dev), torch.Generator(device=dev))
        recorder_prints = {tuple(image[0, 0, 0, :8].tolist()): path
                           for path, (image, _) in store.items()}
    else:
        augment_fn = None
        transform = Compose(seg.train_transform_3d if is_3d else seg.train_transform_2d)
        generators = (torch.Generator(device=dev), None)
        recorder_prints = None
    step = CapturedTrainStep(criterion, ncls, augment_fn, GraphCache())
    dataset = SegDataset(sorted(store), roi_number=None, num_class=ncls, transform=transform,
                         img_key=cfg["keys"][0], lab_key=cfg["keys"][1], reader=reader)
    loader = _SpannedLoader(BatchLoader(dataset, tr["batch_size"], shuffle=True,
                                        num_workers=mix["num_workers"], seed=ctx.seed))
    sched = get_lr_scheduler(tr["lr_scheduler"], tr["lr"], n_epoch=tr["n_epoch"])
    lr0 = sched.step(None)
    set_learning_rate(state.optimizer, lr0)
    recorder = _Recorder(step, recorder_prints)
    phases["built"] = time.perf_counter() - ctx.t_start

    def spanned_step(state, batch, *gens):
        with span("step_call"):
            return recorder(state, batch, *gens) if recorder.params is None else step(
                state, batch, *gens)

    state, _ = seg._run_epoch(state, loader, spanned_step, 0, generators, train=True)
    phases["epoch0"] = time.perf_counter() - ctx.t_start
    recorded = {"losses": [float(v) for v in recorder.losses], "batches": recorder.batches,
                "first_grads": recorder.first_moment, "params": recorder.params}
    step_flops = flops.count(cfg, tr["batch_size"], train=True)
    step_bound = (family.train_step_bound_s(cfg, tr["batch_size"], roofline.sm_clock_hz())
                  if ctx.on_card else None)
    sync(dev)
    setup_peak = memory_peak(dev)
    setup_s = time.perf_counter() - ctx.t_start

    seconds = min(ctx.seconds, mix["trace_seconds"]) if ctx.trace else ctx.seconds
    reset_memory_peak(dev)
    steps, samples, wait, epoch = 0, 0, 0.0, 1
    with profiled(ctx.trace) as prof:
        t0 = time.perf_counter()
        while True:
            set_learning_rate(state.optimizer, sched.step(None))
            state, out = seg._run_epoch(state, loader, spanned_step, epoch, generators,
                                        train=True)
            steps, samples = steps + out["steps"], samples + len(dataset)
            wait += out["loader_wait_seconds"]
            epoch += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        window_s = time.perf_counter() - t0
    window_peak = memory_peak(dev)
    summary = summarize(prof["prof"], window_s, family.kernel_patterns()) if ctx.trace else None

    del seg, state, step, loader, recorder, spanned_step, criterion, generators
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, diagnostics = _check(ctx, recorded, store, start, buffers, lr0)
    diagnostics["setup_phases_s"] = phases
    return {"kind": "train", "setup_s": setup_s, "window_s": window_s, "units": steps,
            "attempted": steps, "failed": 0, "samples": samples, "loader_wait_s": wait,
            "flops": steps * step_flops,
            "kernel_bound_s": None if step_bound is None else steps * step_bound,
            "window_peak_bytes": window_peak,
            "peak_bytes": None if window_peak is None else max(setup_peak, window_peak),
            "trace": summary, "readings": readings, "diagnostics": diagnostics}


def _check(ctx: Context, recorded: dict, store: dict, start: dict, buffers: dict, lr: float
           ) -> tuple:
    """The reference's three steps on the recorded batches; (readings,
    diagnostics)."""
    cfg, dev, family = ctx.config, ctx.device, families.of(ctx.config)
    tr, ncls = cfg["train"], cfg["model"]["num_classes"]
    diagnostics, device_augment, fed = {}, None, {}
    if ctx.mix["device_augment"]:
        if any(p is None for paths in recorded["batches"] for p in paths):  # not the cases
            return {k: 1.0 for k in check.TRAIN_READINGS}, diagnostics
        batches = [case_batch(store, paths, dev) for paths in recorded["batches"]]
        device_augment = functools.partial(augment.augment, patch=tuple(cfg["patch_size"]),
                                           num_classes=ncls)
    else:
        batches = host_batches(store, cfg, ctx.mix, ctx.seed, dev)
        fed["augment_gap"] = check.augment_gap(recorded["batches"], batches)
    with exact():
        net = family.build(cfg, dev)
        net.load_state_dict({**start, **buffers}, strict=True)
        ref = run_steps(net, batches, ctx.seed, lr, tr["weight_decay"], device_augment,
                        loss_fn=family.loss)
    gaps = check.leaf_gaps(recorded["first_grads"], ref["first_grads"], list(start))
    diagnostics["grad_gap_every_leaf"] = max(gaps.values())
    print("portbench: widest gradient gaps", sorted(gaps.items(), key=lambda kv: -kv[1])[:4])
    return dict(check.train_readings(recorded, ref, start), **fed), diagnostics
