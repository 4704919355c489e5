"""Optimizer factory and LR schedules of the port.

Counterpart of ``hdenseformer_tpu/train/state.py``, whose optax chains are
torch's own optimizers:

- "adam" is ``torch.optim.Adam``, whose ``weight_decay`` is coupled L2 (the
  decay added to the gradient before the moments: optax's
  ``add_decayed_weights`` before ``scale_by_adam``);
- "adamw" is ``torch.optim.AdamW`` (decoupled, as optax's chain);
- "sgd" is Nesterov SGD (optax's ``trace(nesterov=True)``).

Weight decay is excluded for 1-D parameters (biases, norm scales), the
``decay_mask`` of the JAX package, by two parameter groups. The learning
rate is a host float in every parameter group (``set_learning_rate``): where
JAX injects it as a hyperparameter so that the compiled update is reused,
torch's optimizer reads the group's value at each step, and setting it
waits for nothing on the card. A step captured in a CUDA graph needs the
optimizer ``make_capturable``: its step counters and learning rate then
live on the card, and ``set_learning_rate`` writes the rate there, so the
per-epoch schedule still reaches a replayed step. ``plain_state_dict`` is
the inverse for checkpoints: a saved capturable state loads into a plain
optimizer, on the CPU too.

Schedules step per epoch with torch semantics, a copy of JAX's: poly
(1 - e/E)^0.9, MultiStepLR, CosineAnnealingLR, CosineAnnealingWarmRestarts
(T_0 5, T_mult 2) and ReduceLROnPlateau (mode 'min', patience 5, factor
0.1). ``step(metric)`` returns the next epoch's rate.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


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


def make_capturable(optimizer: torch.optim.Optimizer, device) -> torch.optim.Optimizer:
    """Make ``optimizer`` capturable in a CUDA graph, in place: Adam's and
    AdamW's ``capturable`` flag with their step counters on ``device``, and
    every group's rate a tensor there. SGD has no counter and no such flag:
    its default update reads a tensor rate on the host (a sync, which a
    capture refuses), so its groups take torch's fused update, which reads
    the rate on the card. The update is the same arithmetic, with the bias
    corrections computed on the card."""
    device = torch.device(device)
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = True
        elif isinstance(optimizer, torch.optim.SGD):
            group["foreach"], group["fused"] = False, True
        if not torch.is_tensor(group["lr"]):
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=device)
    for state in optimizer.state.values():
        if torch.is_tensor(state.get("step")) and state["step"].device != device:
            state["step"] = state["step"].to(device, torch.float32)
    return optimizer


def plain_state_dict(state_dict: dict) -> dict:
    """The inverse of ``make_capturable`` for a saved optimizer state: the
    ``optimizer.state_dict()`` of a capturable optimizer as a plain one's,
    which loads into an optimizer that was never made capturable, on the
    CPU too. Each group's ``capturable`` flag goes back to False (SGD's
    update to torch's default: ``foreach`` and ``fused`` None) and its rate
    to a host float; the step counters to host float32 tensors, as a plain
    Adam keeps them. A plain state dict comes back equal."""
    groups = []
    for group in state_dict["param_groups"]:
        group = dict(group)
        if "capturable" in group:
            group["capturable"] = False
        elif group.get("fused"):  # SGD, made capturable
            group["foreach"], group["fused"] = None, None
        if torch.is_tensor(group["lr"]):
            group["lr"] = float(group["lr"])
        groups.append(group)
    state = {}
    for key, st in state_dict["state"].items():
        st = dict(st)
        if torch.is_tensor(st.get("step")):
            st["step"] = st["step"].detach().to("cpu", torch.float32)
        state[key] = st
    return dict(state_dict, state=state, param_groups=groups)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's rate: a host float, or in place where
    the rate is a tensor on the card (``make_capturable``); neither waits for
    the card."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class LRScheduler:
    """Stateful per-epoch scheduler. ``step(metric)`` returns the new LR."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.last_epoch = -1

    def step(self, metric: Optional[float] = None) -> float:
        self.last_epoch += 1
        return self._lr(self.last_epoch, metric)

    def _lr(self, epoch: int, metric):
        raise NotImplementedError


class PolyLR(LRScheduler):
    """lr * (1 - e/E)^0.9 per epoch; past the last epoch the last rate stays."""

    def __init__(self, base_lr, max_epochs, ck_epoch=0, exponent=0.9):
        super().__init__(base_lr)
        self.max_epochs = max_epochs
        self.ck_epoch = ck_epoch
        self.exponent = exponent
        self._last = base_lr

    def _lr(self, epoch, metric):
        if epoch > self.max_epochs:
            return self._last
        self._last = self.base_lr * (
            1 - (epoch - self.ck_epoch) / (self.max_epochs - self.ck_epoch)
        ) ** self.exponent
        return self._last


class MultiStepLR(LRScheduler):
    def __init__(self, base_lr, milestones, gamma=0.1):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def _lr(self, epoch, metric):
        n = sum(1 for m in self.milestones if m <= epoch)
        return self.base_lr * (self.gamma ** n)


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr, T_max, eta_min=0.0):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min

    def _lr(self, epoch, metric):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * epoch / self.T_max)) / 2
        )


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, base_lr, T_0=5, T_mult=2, eta_min=0.0):
        super().__init__(base_lr)
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min

    def _lr(self, epoch, metric):
        T_i, t = self.T_0, epoch
        while t >= T_i:
            t -= T_i
            T_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / T_i)) / 2


class ReduceLROnPlateau(LRScheduler):
    """mode 'min' (or 'max'), patience 5, factor 0.1; a None metric keeps the rate."""

    def __init__(self, base_lr, patience=5, factor=0.1, mode="min"):
        super().__init__(base_lr)
        self.patience = patience
        self.factor = factor
        self.mode = mode
        self.best = None
        self.bad = 0
        self.lr = base_lr

    def _lr(self, epoch, metric):
        if metric is None:
            return self.lr
        better = self.best is None or (
            metric < self.best if self.mode == "min" else metric > self.best
        )
        if better:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr *= self.factor
                self.bad = 0
        return self.lr


def get_lr_scheduler(
    name: Optional[str],
    base_lr: float,
    n_epoch: int = 100,
    milestones=(50, 80),
    gamma: float = 0.1,
    T_max: int = 5,
) -> Optional[LRScheduler]:
    """The scheduler ``name``, or None for None."""
    if name is None:
        return None
    if name == "poly_lr":
        return PolyLR(base_lr, max_epochs=n_epoch)
    if name == "MultiStepLR":
        return MultiStepLR(base_lr, milestones, gamma)
    if name == "CosineAnnealingLR":
        return CosineAnnealingLR(base_lr, T_max)
    if name == "CosineAnnealingWarmRestarts":
        return CosineAnnealingWarmRestarts(base_lr, 5, 2)
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(base_lr)
    raise ValueError(f"unknown lr scheduler {name!r}")
