"""Introspection helpers of the port: parameter and FLOP counts, the process title.

Counterpart of ``hdenseformer_tpu/utils/profiling.py``'s ``count_params``,
``count_flops`` and ``set_process_title``. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` (the matmuls and convolutions
of one forward) where JAX reads XLA's cost analysis.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
