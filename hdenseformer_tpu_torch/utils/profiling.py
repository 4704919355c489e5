"""Profiling and introspection of the port: parameter and FLOP counts, wall
time, profiler traces and the process title.

Counterpart of ``hdenseformer_tpu/utils/profiling.py``. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` (the matmuls and convolutions
of one forward) where JAX reads XLA's cost analysis; ``profiler_trace``
runs ``torch.profiler`` where JAX runs ``jax.profiler``, and writes a
Chrome trace (JSON, readable in Perfetto or ``chrome://tracing``) without
tensorboard.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import time
from typing import Iterator, Optional

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


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """A ``torch.profiler`` trace of the block, host and (where a card is
    present) device activity, written on exit as
    ``<log_dir>/trace.<pid>.<ms>.json``; yields that path. Nothing is
    traced for ``log_dir`` None (yields None)."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


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
