"""Optimizer factory and LR schedules of the port.

Counterpart of ``hdenseformer_tpu/train/state.py``, whose optax chains are
torch's own optimizers:

- "adam" is ``torch.optim.Adam``, whose ``weight_decay`` is coupled L2 (the
  decay added to the gradient before the moments: optax's
  ``add_decayed_weights`` before ``scale_by_adam``);
- "adamw" is ``torch.optim.AdamW`` (decoupled, as optax's chain);
- "sgd" is Nesterov SGD (optax's ``trace(nesterov=True)``).

Weight decay is excluded for 1-D parameters (biases, norm scales), the
``decay_mask`` of the JAX package, by two parameter groups. Schedules step
per epoch with torch semantics; ``poly_lr`` is ported, the other four raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

# JAX's other schedulers, and where ROADMAP.md ports them
_NOT_YET = dict.fromkeys(
    ("MultiStepLR", "CosineAnnealingLR", "CosineAnnealingWarmRestarts", "ReduceLROnPlateau"),
    "queue 1 item 1 (the training slice: the other schedulers)",
)


def decay_mask(p: torch.Tensor) -> bool:
    """True (decay) for >1-D kernels; False for biases and norm scales."""
    return p.ndim > 1


def get_optimizer(
    name: str,
    lr: float,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
    *,
    params: Iterable[torch.nn.Parameter],
) -> torch.optim.Optimizer:
    """The optimizer ``name`` (case-insensitive) over ``params``: decayed
    (``decay_mask``) and not decayed parameters in two groups."""
    params = [p for p in params if p.requires_grad]
    groups = [
        dict(params=[p for p in params if decay_mask(p)], weight_decay=weight_decay),
        dict(params=[p for p in params if not decay_mask(p)], weight_decay=0.0),
    ]
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum, nesterov=True)
    raise ValueError(f"unknown optimizer {name!r}")


class PolyLR:
    """lr * (1 - e/E)^0.9 per epoch; past the last epoch the last rate stays.
    ``step(metric)`` returns the next epoch's rate (``metric`` is unused)."""

    def __init__(self, base_lr, max_epochs, ck_epoch=0, exponent=0.9):
        self.base_lr = base_lr
        self.last_epoch = -1
        self.max_epochs = max_epochs
        self.ck_epoch = ck_epoch
        self.exponent = exponent
        self._last = base_lr

    def step(self, metric: Optional[float] = None) -> float:
        self.last_epoch += 1
        epoch = self.last_epoch
        if epoch > self.max_epochs:
            return self._last
        self._last = self.base_lr * (
            1 - (epoch - self.ck_epoch) / (self.max_epochs - self.ck_epoch)
        ) ** self.exponent
        return self._last


def get_lr_scheduler(
    name: Optional[str],
    base_lr: float,
    n_epoch: int = 100,
) -> Optional[PolyLR]:
    """The scheduler ``name``, or None for None."""
    if name is None:
        return None
    if name == "poly_lr":
        return PolyLR(base_lr, max_epochs=n_epoch)
    if name in _NOT_YET:
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md {_NOT_YET[name]}")
    raise ValueError(f"unknown lr scheduler {name!r}")
