"""Profiling and introspection of the port: parameter and FLOP counts, wall
time, profiler traces, the program's spans and counters, and the process
title.

Counterpart of ``hdenseformer_tpu/utils/profiling.py``. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` (the matmuls and convolutions
of one forward) where JAX reads XLA's cost analysis; ``profiler_trace``
runs ``torch.profiler`` where JAX runs ``jax.profiler``, and writes a
Chrome trace (JSON, readable in Perfetto or ``chrome://tracing``) without
tensorboard.

Spans and counters. ``span(name, key)`` marks a piece of the program's host
work at a layer boundary (the serving call, a graph's replay, a train step,
the trainer loop, the loader's threads); ``count(name, n)`` adds to a
counter there. Both record only inside ``tracing()``, which yields the
recording: ``.spans``, one ``Span`` each (name, key, thread, start and end
on ``time.time_ns()``, the clock on which ``torch.profiler`` reports its
host and device events, and the id of the innermost span open on the same
thread), and ``.counters``. Spans are kept in memory and work from any
thread: a ``record_function`` opened on a thread started under the profiler
is not recorded, so the loader's threads could not ride on it.
``profiler_trace`` traces too and writes the spans into its Chrome trace.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of ``fn(*args, **kwargs)`` under FlopCounterMode, run without
    gradients; None where the counter cannot trace the call."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), counter:
            fn(*args, **kwargs)
    except (RuntimeError, NotImplementedError):
        return None
    return float(counter.get_total_flops())


class Timer:
    """``with Timer() as t: ...`` sets ``t.elapsed``, the wall seconds of
    the block (host clock: a caller timing card work synchronises inside)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start


class Span(NamedTuple):
    """One recorded span: ``parent`` is the ``id`` of the innermost span open
    on the same thread when it began (None at the top)."""
    id: int
    name: str
    key: Any
    thread: int  # threading.get_native_id(), the profiler's tid
    start_ns: int
    end_ns: int
    parent: Optional[int]


class Recording:
    """What one ``tracing()`` block recorded: its spans, its counters and its
    own start and end on ``time.time_ns()``."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.threads: Dict[int, str] = {}  # native id: name, of the threads that recorded
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None
        self._lock = threading.Lock()

    def add(self, name: str, n) -> None:
        with self._lock:  # the loader's threads count too
            self.counters[name] = self.counters.get(name, 0) + n


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# Off, ``span`` is one check of ``_RECORDING`` that returns this shared object:
# 0.3 us a span with its ``with``, where a ``record_function`` with no profiler
# costs 10.9 us, and 2.7 us on (timeit on a CPU host): the spans stay in the
# serving call and the train step for good.
_NO_SPAN = _NoSpan()
_RECORDING: Optional[Recording] = None
_IDS = itertools.count()
_OPEN = threading.local()  # each thread's stack of open span ids


class _Span:
    __slots__ = ("recording", "name", "key", "id", "parent", "start_ns")

    def __init__(self, recording: Recording, name: str, key):
        self.recording, self.name, self.key = recording, name, key

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.stack.pop()
        recording = self.recording
        if recording is _RECORDING:  # a span that outlives its tracing() is dropped
            thread = threading.get_native_id()
            if thread not in recording.threads:
                recording.threads[thread] = threading.current_thread().name
            recording.spans.append(Span(self.id, self.name, self.key, thread, self.start_ns,
                                        end, self.parent))
        return False


def span(name: str, key=None):
    """A context manager over a piece of the program's host work, recorded
    inside ``tracing()`` (module docstring); ``key`` names the unit of work
    (a step number, an (epoch, sample index), a volume's lattice cell)."""
    recording = _RECORDING
    if recording is None:
        return _NO_SPAN
    return _Span(recording, name, key)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` inside ``tracing()``; nothing
    outside it."""
    recording = _RECORDING
    if recording is not None:
        recording.add(name, n)


@contextlib.contextmanager
def tracing() -> Iterator[Recording]:
    """Record the program's spans and counters over the block; yields the
    ``Recording``. Tracing is one recording at a time: nesting raises."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("tracing() is already on: it does not nest")
    recording = _RECORDING = Recording()
    try:
        yield recording
    finally:
        recording.end_ns = time.time_ns()
        _RECORDING = None


_MARK = "hdenseformer_tpu_torch.clock_mark"


def _clock_mark() -> tuple:
    """A zero-length ``record_function`` named ``_MARK`` between two reads of
    ``time.time_ns()``, which it returns. The profiler converts its own clock
    to Unix time once a profile: the mark's event says how far that lies
    from the spans' clock."""
    before = time.time_ns()
    with torch.profiler.record_function(_MARK):
        pass
    return before, time.time_ns()


def _clock_shift(before: int, after: int, start: int, end: int) -> int:
    """The least shift (ns) that puts a profile event seen at [``start``,
    ``end``] between ``before`` and ``after``, the ``time.time_ns()`` reads
    around it: 0 where the two clocks agree that far (the bracket also holds
    the first ``record_function``'s own set-up, a few hundred us)."""
    return min(max(0, end - after), start - before)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """A ``torch.profiler`` trace of the block, host and (where a card is
    present) device activity, written on exit as
    ``<log_dir>/trace.<pid>.<ms>.json``; yields that path. The program's
    spans of the block (``tracing()``) are in the trace too, as complete
    events of category "program" on their thread's row, and its counters
    are written beside it as ``counters.<pid>.<ms>.json``. Nothing is traced
    for ``log_dir`` None (yields None)."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    stem = f"{os.getpid()}.{int(time.time() * 1e3)}.json"
    path = os.path.join(log_dir, f"trace.{stem}")
    with tracing() as recording, torch.profiler.profile(activities=activities) as prof:
        mark = _clock_mark()
        yield path
    prof.export_chrome_trace(path)
    _add_spans(path, recording, prof, mark)
    with open(os.path.join(log_dir, f"counters.{stem}"), "w") as f:
        json.dump(recording.counters, f, indent=1, sort_keys=True)


def _add_spans(path: str, recording: Recording, prof, mark: tuple) -> None:
    """Write ``recording``'s spans into the Chrome trace at ``path``, whose
    times are microseconds from a base of its own: the ``_clock_mark``
    ``mark``'s event, in the profile (Unix ns) and in the file, places them."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    start, end = next((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                      if e.name() == _MARK)
    shift = _clock_shift(*mark, start, end)
    mark_us = next(e["ts"] for e in events if e.get("name") == _MARK and e.get("ph") == "X")
    pid = os.getpid()
    for s in recording.spans:
        events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": mark_us + (s.start_ns + shift - start) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"key": s.key, "id": s.id, "parent": s.parent}})
    for tid, name in recording.threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": name}})
    with open(path, "w") as f:
        json.dump(trace, f, default=str)


def set_process_title(title: str) -> None:
    """Best-effort process-title update: setproctitle where it is installed,
    else the thread name through prctl(PR_SET_NAME), else nothing."""
    try:
        import setproctitle
    except ImportError:
        try:
            libc = ctypes.CDLL("libc.so.6")
            libc.prctl(15, title.encode()[:15], 0, 0, 0)  # PR_SET_NAME
        except (OSError, AttributeError):
            pass
        return
    setproctitle.setproctitle(title)
