"""The program's own spans and counters over the traced window, beside what
``torch.profiler`` saw on the device meanwhile.

The system records spans at its layer boundaries (the serving call, a
graph's replay, a train step, the trainer loop, the loader's threads) and
counters there, inside ``hdenseformer_tpu_torch.utils.profiling.tracing()``,
on ``time.time_ns()``: the clock on which the profiler reports its host and
device events. ``traced(enabled)`` opens that recording; a program without
it (an older checkout) records nothing, and ``attach`` then adds nothing.
A window driver opens it inside its ``trace.profiled`` block and hands
both to ``attach`` with the run's record:

    with profiled(ctx.trace) as prof, program.traced(ctx.trace) as window:
        ...  # the window
    record = {...}
    program.attach(record, window, prof.get("prof"), loader_workers=...)

The profiler converts its own clock to Unix time once a profile; ``traced``
takes a clock mark at each end of the window, and ``attach`` moves the
spans by the least shift that the marks call for (``clock_shift``; 0 where
the clocks agree within the marks' brackets).

``attach`` reads the profile's device operations once more (as
``trace.summarize`` does), puts ``record["program"]`` and adds to the
record's diagnostics:

- ``program_spans``: by span name, the count, the total seconds and the
  self seconds (a span's time less that of its children on its thread);
- ``program_counters``: the counters over the window;
- ``idle_by_program_span``: each idle interval of the device over the
  window, split at the boundaries of the main thread's spans, each piece
  under the innermost span open there, else ``outside_program``;
- ``clock_check``: "serve.fetch", the share of the labels' fetches during
  whose span (within 0.1 ms) a device-to-host copy ended; "graph.launch",
  the share of graph launches whose first device operation started after
  the launch's span began. Either is None where no such span ran;
- ``program_metrics``: ``layer_metrics``, the per-layer numbers that the
  spans give (serving's staging, replay and fetch a volume; training's
  batch, step and drain a step and the loader threads' busy share).
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import namedtuple
from typing import Dict, List, Optional

from portbench.trace import union

OUTSIDE = "outside_program"
MARK = "program.clock_mark"  # not "portbench.": trace.py names idle gaps by those
FETCH_SLACK_NS = 100_000  # 0.1 ms

Span = namedtuple("Span", "id name key thread start_ns end_ns parent")


class Window:
    """The program's recording of the window and the clock marks taken at
    its ends (``clock_mark``)."""

    def __init__(self, recording):
        self.recording, self.marks = recording, []


def clock_mark() -> tuple:
    """A zero-length ``record_function`` named ``MARK`` between two reads of
    ``time.time_ns()``, which it returns. The mark's event in the profile
    says how far the profile's clock lies from the spans'."""
    from torch.profiler import record_function

    before = time.time_ns()
    with record_function(MARK):
        pass
    return before, time.time_ns()


def clock_shift(marks: list, seen: list) -> Optional[tuple]:
    """(least, most, chosen) shift in ns that puts each mark's profile event
    ``seen`` (start, end) inside its ``time.time_ns()`` bracket ``marks``
    (before, after); chosen is the one nearest 0, so clocks that agree to
    within the brackets (which also hold the first ``record_function``'s own
    set-up, a few hundred us) are left as they are. None without both
    marks."""
    if len(marks) != 2 or len(seen) != 2:
        return None
    lows = [end - after for (_, after), (_, end) in zip(marks, seen)]
    highs = [start - before for (before, _), (start, _) in zip(marks, seen)]
    least, most = max(lows), min(highs)
    if least > most:  # the clocks drifted between the marks: the hull
        least, most = min(lows), max(highs)
    return least, most, min(max(0, least), most)


@contextlib.contextmanager
def traced(enabled: bool):
    """The program's ``tracing()`` over the block where ``enabled``, inside
    the harness's profile, marked at both ends; yields a ``Window``, or None
    where not enabled or the program has no ``tracing()``."""
    if not enabled:
        yield None
        return
    from hdenseformer_tpu_torch.utils import profiling

    tracing = getattr(profiling, "tracing", None)
    if tracing is None:
        yield None
        return
    with tracing() as recording:
        window = Window(recording)
        window.marks.append(clock_mark())
        yield window
        window.marks.append(clock_mark())


def attach(record: dict, window: Optional[Window], prof,
           loader_workers: Optional[int] = None) -> None:
    """Add ``record["program"]`` (the spans, counters and window of
    ``window``'s recording moved onto the profile's clock, the device's
    intervals of ``prof``) and its summary to ``record["diagnostics"]``;
    nothing where ``window`` is None."""
    if window is None:
        return
    view = device_view(prof)
    bounds = clock_shift(window.marks, view.pop("marks"))
    shift = 0 if bounds is None else bounds[2]
    rec = window.recording
    program = {"spans": [Span(s.id, s.name, s.key, s.thread, s.start_ns + shift,
                              s.end_ns + shift, s.parent) for s in rec.spans],
               "counters": dict(rec.counters), "start_ns": rec.start_ns + shift,
               "end_ns": rec.end_ns + shift, "main_thread": threading.get_native_id(),
               "loader_workers": loader_workers,
               "profile_clock_ahead_us": None if bounds is None else [
                   round(b / 1e3, 1) for b in bounds], **view}
    record["program"] = program
    record["diagnostics"].update(summary(program))


def device_view(prof) -> dict:
    """From the profile: ``busy``, the merged (start_ns, end_ns) intervals of
    the device's operations; ``d2h_ends``, the sorted ends of its
    device-to-host copies; ``launches``, (start_ns, first device start_ns or
    None) of each graph launch the runtime saw, by start; ``marks``, the
    clock marks' (start_ns, end_ns)."""
    import torch

    device, launches, marks = [], [], []
    first: Dict[int, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() == MARK and e.device_type() == torch.autograd.DeviceType.CPU:
            marks.append((e.start_ns(), e.end_ns()))
        elif e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name()))
            c = e.correlation_id()  # the runtime call's that launched it
            if c not in first or e.start_ns() < first[c]:
                first[c] = e.start_ns()
        elif e.name().startswith("cudaGraphLaunch"):
            launches.append((e.start_ns(), e.correlation_id()))
    return {"busy": union([(a, b) for a, b, _ in device]),
            "d2h_ends": sorted(b for _, b, name in device if "DtoH" in name),
            "launches": sorted((a, first.get(c)) for a, c in launches), "marks": sorted(marks)}


def summary(program: dict) -> dict:
    return {"program_spans": span_table(program["spans"]),
            "program_counters": program["counters"],
            "program_metrics": layer_metrics(program),
            "idle_by_program_span": idle_by_span(program),
            "clock_check": clock_check(program)}


def span_table(spans: List[Span]) -> Dict[str, list]:
    """{name: [count, total s, self s]}, by total, largest first."""
    children: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    table: Dict[str, list] = {}
    for s in spans:
        row = table.setdefault(s.name, [0, 0.0, 0.0])
        dur = s.end_ns - s.start_ns
        row[0] += 1
        row[1] += dur / 1e9
        row[2] += (dur - children.get(s.id, 0)) / 1e9
    return dict(sorted(table.items(), key=lambda kv: -kv[1][1]))


def segments(spans: List[Span], start: int, end: int) -> List[tuple]:
    """[start, end] cut at the boundaries of ``spans`` (one thread's, so
    nested), each (a, b, name of the innermost span open there, else
    ``OUTSIDE``)."""
    out, stack, pos = [], [], start

    def emit(a, b, name):
        a, b = max(a, start), min(b, end)
        if b > a:
            out.append((a, b, name))

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            top = stack.pop()
            emit(pos, top.end_ns, top.name)
            pos = max(pos, top.end_ns)
        emit(pos, s.start_ns, stack[-1].name if stack else OUTSIDE)
        pos = max(pos, s.start_ns)
        stack.append(s)
    while stack:
        top = stack.pop()
        emit(pos, top.end_ns, top.name)
        pos = max(pos, top.end_ns)
    emit(pos, end, OUTSIDE)
    return out


def idle_by_span(program: dict) -> Optional[Dict[str, float]]:
    """Idle seconds of the window by the main thread's innermost span,
    largest first; None where the device ran nothing."""
    busy, start, end = program["busy"], program["start_ns"], program["end_ns"]
    if not busy:
        return None
    idle, t = [], start
    for a, b in busy + [(end, end)]:
        if a > t:
            idle.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    main = [s for s in program["spans"] if s.thread == program["main_thread"]]
    out: Dict[str, float] = {}
    i = 0
    for a, b, name in segments(main, start, end):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            overlap = min(b, idle[j][1]) - max(a, idle[j][0])
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap / 1e9
            j += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def clock_check(program: dict) -> dict:
    """Whether the spans and the device's events share a clock (module
    docstring). Beside the shares: the number of graph launches the runtime
    saw, and [least, tenth percentile, median] in us of the runtime's launch
    call after its ``graph.launch`` span began, and of the first device
    operation after each (how far apart the clocks could be)."""
    main = [s for s in program["spans"] if s.thread == program["main_thread"]]
    fetches = [s for s in main if s.name == "serve.fetch"]
    ends = program["d2h_ends"]
    hits = 0
    for s in fetches:
        k = bisect.bisect_left(ends, s.start_ns - FETCH_SLACK_NS)
        hits += k < len(ends) and ends[k] <= s.end_ns + FETCH_SLACK_NS
    launches = [s for s in main if s.name == "graph.launch"]
    starts = [a for a, _ in program["launches"]]
    ordered, call_after, device_after = 0, [], []
    for s in launches:
        k = bisect.bisect_left(starts, s.start_ns)
        if k < len(starts) and starts[k] <= s.end_ns:
            call, first = program["launches"][k]
            call_after.append((call - s.start_ns) / 1e3)
            if first is not None:
                device_after.append((first - s.start_ns) / 1e3)
                ordered += first >= s.start_ns
    return {"serve.fetch": hits / len(fetches) if fetches else None,
            "graph.launch": ordered / len(launches) if launches else None,
            "profile_clock_ahead_us": program.get("profile_clock_ahead_us"),
            "graph_launches_seen": len(starts),
            "launch_call_after_span_us": _low_quantiles(call_after),
            "first_device_op_after_span_us": _low_quantiles(device_after)}


def _low_quantiles(values: List[float]) -> Optional[list]:
    if not values:
        return None
    v = sorted(values)
    return [round(v[0], 1), round(v[len(v) // 10], 1), round(v[len(v) // 2], 1)]


def mean_ms(program: dict, name: str, per: str, under: Optional[str] = None
            ) -> Optional[float]:
    """The seconds of the ``name`` spans (those whose parent is a ``under``
    span, where given) over the number of ``per`` spans, in ms; None where
    no ``per`` span ran."""
    units = sum(s.name == per for s in program["spans"])
    if not units:
        return None
    parents = {s.id for s in program["spans"] if s.name == under}
    spans = [s for s in program["spans"]
             if s.name == name and (under is None or s.parent in parents)]
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / units


def loader_busy_pct(program: dict) -> Optional[float]:
    """The seconds of the ``loader.sample`` spans inside the window over the
    loader's thread count times the window, in %; None without a loader."""
    samples = [s for s in program["spans"] if s.name == "loader.sample"]
    if not samples or not program["loader_workers"]:
        return None
    start, end = program["start_ns"], program["end_ns"]
    busy = sum(max(0, min(s.end_ns, end) - max(s.start_ns, start)) for s in samples)
    return 100.0 * busy / (program["loader_workers"] * (end - start))


def layer_metrics(program: dict) -> Dict[str, Optional[float]]:
    """The per-layer numbers that the program's spans give, each None where
    its spans did not run: serving's ``stage_ms``, ``replay_host_ms`` and
    ``fetch_wait_ms`` a volume; training's ``batch_ms``, ``step_host_ms``
    and ``drain_ms`` a step and ``loader_busy_pct``."""
    return {"stage_ms.serve": mean_ms(program, "serve.stage", "serve.call"),
            "replay_host_ms.serve": mean_ms(program, "graph.replay", "serve.call",
                                            under="serve.call"),
            "fetch_wait_ms.serve": mean_ms(program, "serve.fetch", "serve.call"),
            "batch_ms.train": mean_ms(program, "train.batch", "train.step"),
            "step_host_ms.train": mean_ms(program, "train.step", "train.step"),
            "drain_ms.train": mean_ms(program, "train.drain", "train.step"),
            "loader_busy_pct.train": loader_busy_pct(program)}
