"""Window drivers, one a kind of traffic ("train", "serve"): ``run(ctx)``
sets up, measures the window, frees the system, checks its outputs against
the reference and returns the run's record."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Context:
    name: str  # the cell
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # the process's start, on time.perf_counter

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_memory_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> Optional[int]:
    """The caching allocator's peak of reserved bytes: a CUDA graph's private
    pool holds its memory while the graph lives, and the allocated bytes
    leave it out between replays."""
    return torch.cuda.max_memory_reserved(device) if device.type == "cuda" else None
