"""Weights made from the run's seed, on the run's device, for both sides.

One ``torch.rand`` over every parameter at once from a generator on the
device, then each parameter's slice scaled in place: a conv or dense kernel
U(-b, b) with b = 1 / sqrt(fan_in) (its dims after the first), its bias the
same b, the token positions U(-0.02, 0.02), a norm's scale 1 + U(-0.1, 0.1)
and its shift U(-0.1, 0.1). The names and shapes are the reference model's,
which mirror the system's: ``load_state_dict(strict=True)`` into the system
checks that they agree.

Buffers, such as a BatchNorm's running statistics, are not drawn: both
sides start from those of a fresh reference model (``start``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench import families
from portbench.traffic import derive_seed


def make(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} for the named ``shapes``, in order."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights"))
    flat = torch.rand(total, generator=gen, device=device)
    out, start, bounds = {}, 0, {}
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[start:start + n].view(shape)
        start += n
        module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if len(shape) >= 2 and leaf == "weight":
            bounds[module] = 1.0 / math.sqrt(math.prod(shape[1:]))
            u.mul_(2 * bounds[module]).sub_(bounds[module])
        elif leaf == "pos_embed":
            u.mul_(0.04).sub_(0.02)
        elif leaf == "bias" and module in bounds:
            u.mul_(2 * bounds[module]).sub_(bounds[module])
        elif leaf == "weight":  # a norm's scale
            u.mul_(0.2).add_(0.9)
        else:  # a norm's shift
            u.mul_(0.2).sub_(0.1)
        out[name] = u
    return out


def shapes_of(model: torch.nn.Module) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def start(config: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                     Dict[str, torch.Tensor]]:
    """(parameters, buffers) that the system and the reference both start
    from: the family's reference model's parameters made from the seed, and
    the buffers of its state dict as a fresh one holds them (none where it
    has none)."""
    family = families.of(config)
    meta = family.build(config, "meta")
    params = shapes_of(meta)
    names = [n for n in meta.state_dict() if n not in params]
    buffers = {}
    if names:
        fresh = family.build(config, "cpu").state_dict()
        buffers = {n: fresh[n].to(device) for n in names}
    return make(params, seed, device), buffers
