"""The traced window: spans the harness opens around its calls into the
system, and what ``torch.profiler`` saw on the device meanwhile.

Spans are ``record_function`` ranges named ``portbench.<what>``; without a
profiler they cost a few microseconds. ``summarize`` reads the profiler's
raw events once: the device's busy time as the union of its operations'
intervals (the operations of one graph may overlap), the idle gaps between
them, each named by the innermost harness span open at its middle, the time
by device operation, and the time of the kernels that a pattern names (a
substring of the kernel's name): those whose bound the configuration's
family gives (``portbench.families``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

SPAN = "portbench."


def span(what: str):
    return torch.profiler.record_function(SPAN + what)


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over the block where ``enabled``; yields a dict that
    holds the profile under "prof" once the block has ended."""
    out: Dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
    out["prof"] = prof


def union(intervals: List[tuple]) -> List[tuple]:
    """Merged (start, end) intervals, sorted."""
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy_union_s(intervals: List[tuple]) -> float:
    """Seconds covered by the (start_ns, end_ns) intervals."""
    return sum(b - a for a, b in union(intervals)) / 1e9


def _label(spans: List[tuple], t: float) -> str:
    """The innermost (shortest) span holding ``t``, else "host_other"."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2][len(SPAN):] if best else "host_other"


def idle_gaps(busy: List[tuple], spans: List[tuple], start: float, end: float
              ) -> Dict[str, float]:
    """Idle seconds of [start, end] outside ``busy``, summed by the label of
    the span open at each gap's middle."""
    out: Dict[str, float] = {}
    t = start
    for a, b in busy + [(end, end)]:
        if a > t:
            name = _label(spans, (t + a) / 2)
            out[name] = out.get(name, 0.0) + (min(a, end) - t) / 1e9
        t = max(t, b)
    return out


def summarize(prof, window_s: float, patterns: Sequence[str] = ()) -> Optional[dict]:
    """busy_s, kernel_s (the kernels that ``patterns`` name; 0 where none
    does), idle by span and time by device operation over the profile; None
    where it saw no device operation."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN):
            if e.device_type() == torch.autograd.DeviceType.CPU:
                spans.append((e.start_ns(), e.end_ns(), name))
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), name))
    if not device:
        return None
    by_op: Dict[str, float] = {}
    kernel_ns = 0
    for a, b, name in device:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e9
        if any(p in name for p in patterns):
            kernel_ns += b - a
    busy = union([(a, b) for a, b, _ in device])
    start = min([a for a, _, _ in spans] + [busy[0][0]])
    end = max([b for _, b, _ in spans] + [busy[-1][1]])
    gaps = idle_gaps(busy, spans, start, end)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_union_s(busy), "window_s": window_s,
            "kernel_s": kernel_ns / 1e9,
            "device_ops": [[name[:160], s] for name, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
