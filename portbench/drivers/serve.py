"""The serving window: a closed loop of one client, volume after volume,
``PETandCTNormalize`` and then ``predict_volume`` (no gaussian, the mix's
``window_batch``), as ``inference_slidingwindow`` serves a case without its
file I/O.

Set-up builds the model as ``get_net`` does with the benchmark's weights and
the family's starting buffers (``weights.start``),
makes the mix's pool of volumes and serves one volume of each lattice cell
the pool falls in, which warms up and captures that cell's call. The window
serves the pool round and round until ``seconds`` have passed and ends with
the volume in flight then. A volume's latency runs from the start of its
normalisation to its int32 labels on the host.

After the window the system is freed, and the family's reference model
serves a sample of
the finished volumes drawn from the seed (the largest volume among them)
and judges the labels they were last served.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import check, families, flops, roofline, traffic, weights
from portbench.drivers import Context, memory_peak, reset_memory_peak, sync
from portbench.reference import exact
from portbench.reference import serve as ref_serve
from portbench.trace import profiled, span, summarize


def lattice_cell(shape, patch, step) -> tuple:
    """The padded shape of a volume's call: patch + step * k an axis."""
    return tuple(p + t * (0 if s <= p else -(-(s - p) // t))
                 for s, p, t in zip(shape, patch, step))


def sample_of(pool, mix: dict, seed: int) -> list:
    """The pool indices checked: the largest volume and ``check_volumes`` - 1
    others drawn from the seed."""
    rng = np.random.default_rng(traffic.derive_seed(seed, "sample"))
    largest = int(np.argmax([math.prod(image.shape[1:]) for image, _ in pool]))
    others = [int(i) for i in rng.permutation(len(pool)) if i != largest]
    return [largest] + others[:mix["check_volumes"] - 1]


def run(ctx: Context) -> dict:
    from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize
    from hdenseformer_tpu_torch.infer import sliding
    from hdenseformer_tpu_torch.models import get_net

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    m, family = cfg["model"], families.of(cfg)
    phases = {"imports": time.perf_counter() - ctx.t_start}
    patch, step, ncls = tuple(cfg["patch_size"]), tuple(cfg["step_size"]), m["num_classes"]
    model = get_net(m["name"], m["in_channels"], ncls, tuple(m["image_size"]),
                    dtype=torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else None,
                    remat=cfg["remat"], s2d=cfg["s2d"], device=dev,
                    **family.system_kwargs(cfg))
    start, buffers = weights.start(cfg, ctx.seed, dev)
    model.load_state_dict({**start, **buffers}, strict=True)
    model.eval()
    phases["built"] = time.perf_counter() - ctx.t_start
    pool = traffic.serve_pool(mix, ctx.seed, dev)
    phases["volumes"] = time.perf_counter() - ctx.t_start
    norm = PETandCTNormalize()

    def serve(image):
        t0 = time.perf_counter()
        with span("normalize"):
            ready = norm({"image": image})["image"]
        t1 = time.perf_counter()
        with span("predict_volume"):
            labels = sliding.predict_volume(model, ready, patch, step, ncls,
                                            use_gaussian=False,
                                            window_batch=mix["window_batch"], capture=True)
        return labels, t1 - t0, time.perf_counter() - t0

    cells = {}
    for image, _ in pool:
        cells.setdefault(lattice_cell(image.shape[1:], patch, step), image)
    for image in cells.values():
        serve(image)
    phases["warmed"] = time.perf_counter() - ctx.t_start
    windows = [len(ref_serve.origins(image.shape[1:], patch, step)) for image, _ in pool]
    window_flops = flops.count(cfg, 1, train=False)
    window_bound = (family.forward_bound_s(cfg, 1, roofline.sm_clock_hz())
                    if ctx.on_card else None)
    sample = sample_of(pool, mix, ctx.seed)
    served = {}
    sync(dev)
    setup_peak = memory_peak(dev)
    setup_s = time.perf_counter() - ctx.t_start

    seconds = min(ctx.seconds, mix["trace_seconds"]) if ctx.trace else ctx.seconds
    reset_memory_peak(dev)
    latencies, normalize, n_windows = [], [], 0
    with profiled(ctx.trace) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(latencies) % len(pool)
            labels, t_norm, t_all = serve(pool[i][0])
            latencies.append(t_all)
            normalize.append(t_norm)
            n_windows += windows[i]
            if i in sample:
                served[i] = labels
        window_s = time.perf_counter() - t0
    window_peak = memory_peak(dev)
    summary = summarize(prof["prof"], window_s, family.kernel_patterns()) if ctx.trace else None

    del model, serve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = []
    with exact():
        net = family.build(cfg, dev)
        net.load_state_dict({**start, **buffers}, strict=True)
        for i in sample:
            if i not in served:
                continue
            probs = ref_serve.mean_probs(net, ref_serve.normalize(pool[i][0], dev), patch,
                                         step, ncls)
            gaps.append(check.label_gap(served[i], probs))
    return {"kind": "serve", "setup_s": setup_s, "window_s": window_s,
            "units": len(latencies), "attempted": len(latencies), "failed": 0,
            "latencies_s": latencies, "normalize_s": normalize,
            "flops": n_windows * window_flops,
            "kernel_bound_s": None if window_bound is None else n_windows * window_bound,
            "window_peak_bytes": window_peak,
            "peak_bytes": None if window_peak is None else max(setup_peak, window_peak),
            "trace": summary, "readings": {"label_gap": max(gaps) if gaps else 1.0},
            "diagnostics": {"setup_phases_s": phases, "volumes_checked": len(gaps),
                            "latency_ms_by_tenth": _tenths(latencies),
                            "normalize_ms_by_tenth": _tenths(normalize)}}


def _tenths(seconds: list) -> list:
    """The mean of each tenth of the window's volumes, in ms: how the
    window's pace moved."""
    n = len(seconds)
    cuts = [round(i * n / 10) for i in range(11)]
    return [round(1e3 * float(np.mean(seconds[a:b])), 2) for a, b in zip(cuts, cuts[1:]) if b > a]
