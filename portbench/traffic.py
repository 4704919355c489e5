"""The one generator of the benchmark's traffic, driven by a mix's data file.

A mix (``portbench/traffic/<name>.json``) is parameters only: its ``kind``
("train" or "serve") picks the window driver, and the rest says what to
make. Inputs come from the run's ``--seed`` alone, made on the run's device
in a few large draws and handed to the system as host arrays, as a
page-cached dataset would hold them.

Synthetic CT+PET ("ct_pet"): CT noise N(0, 200^2) HU plus 300 inside a
ball, PET an Exp(1) uptake plus 8 inside the same ball. Synthetic MR
("mr"): each channel 100 Exp(1) plus 150 inside the ball (a disc in 2-D).
The label is the ball. Each ball has its centre within a fifth of the size
of the middle and a radius of 0.10 to 0.20 of the smallest side.

Serving mixes fix the set of volume shapes by ``shape_seed`` (a constant of
the mix): every run serves the same shapes, in an order and with contents
drawn from its seed, so that two seeds do the same work.
"""
from __future__ import annotations

import math
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    words = [int(seed) % 2 ** 64] + [zlib.crc32(str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def _volumes(shapes: Sequence[Tuple[int, ...]], seed: int, device, channels: int = 2,
             modality: str = "ct_pet") -> List[Tuple]:
    """(image (channels, *shape) float32, label (*shape) float32) host
    arrays, 2-D or 3-D."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "volumes"))
    sizes = [math.prod(s) for s in shapes]
    total = sum(sizes)
    if modality == "ct_pet":
        noise = [torch.randn(total, generator=gen, device=device).mul_(200.0),
                 torch.rand(total, generator=gen, device=device).clamp_min_(1e-7).log_().neg_()]
        inside = [300.0, 8.0]
    elif modality == "mr":
        noise = [torch.rand(total, generator=gen, device=device).clamp_min_(1e-7).log_()
                 .mul_(-100.0) for _ in range(channels)]
        inside = [150.0] * channels
    else:
        raise ValueError(f"modality {modality!r}: ct_pet or mr")
    balls = torch.rand((len(shapes), 4), generator=gen, device=device)
    out, start = [], 0
    for i, shape in enumerate(shapes):
        n, nd = sizes[i], len(shape)
        centre = [s / 2 + (balls[i, d] - 0.5) * 0.4 * s for d, s in enumerate(shape)]
        radius = (0.10 + 0.10 * balls[i, 3]) * min(shape)
        dist2 = sum((torch.arange(s, device=device, dtype=torch.float32) - c).square()
                    .view([-1 if a == d else 1 for a in range(nd)])
                    for d, (s, c) in enumerate(zip(shape, centre)))
        ball = (dist2 < radius * radius).float()
        image = torch.stack([x[start:start + n].view(shape) + v * ball
                             for x, v in zip(noise, inside)])
        out.append((image, ball))
        start += n
    return [(image.cpu().numpy(), ball.cpu().numpy()) for image, ball in out]


def train_cases(mix: dict, seed: int, device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The mix's ``cases`` training cases (2-D slices or 3-D volumes) of
    ``case_size``."""
    shape = tuple(mix["case_size"])
    return _volumes([shape] * mix["cases"], seed, device, mix.get("channels", 2),
                    mix.get("modality", "ct_pet"))


def serve_shapes(mix: dict) -> List[Tuple[int, int, int]]:
    """The mix's fixed pool of volume shapes, each axis uniform in
    [``size_low``, ``size_high``]."""
    rng = np.random.default_rng(mix["shape_seed"])
    dims = rng.integers(mix["size_low"], mix["size_high"] + 1, size=(mix["pool"], 3))
    return [tuple(int(v) for v in row) for row in dims]


def serve_pool(mix: dict, seed: int, device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The volumes in serving order, served round and round: the pool's
    shapes permuted by the seed, contents from the seed."""
    shapes = serve_shapes(mix)
    order = np.random.default_rng(derive_seed(seed, "order")).permutation(len(shapes))
    return _volumes([shapes[i] for i in order], seed, device)
