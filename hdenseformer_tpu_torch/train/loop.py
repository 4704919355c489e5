"""The train and eval steps of the port.

Counterpart of ``hdenseformer_tpu/train/loop.py``'s ``_train_step_fn`` and
``make_eval_step``. One train step: the model in training mode, the forward
(dropout drawn from the caller's ``torch.Generator``), the loss with the
batch's optional pad-and-mask ``weight``, ``backward``, the optimizer's
step, and dice and the confusion matrix on the fp32 logits of head 0. The
metrics stay tensors on the device: the step never waits for the card.

Where JAX derives each step's dropout key as ``fold_in(key, step)``, the
port's generator advances by itself from step to step. Precision is the
model's: bf16 compute with fp32 parameters when it is built with
``dtype=torch.bfloat16``, fp32 heads and loss. Every activation is stored
for the backward (no rematerialisation, bench.py's ``REMAT = False``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from hdenseformer_tpu_torch.metrics.batch import compute_dice
from hdenseformer_tpu_torch.metrics.running import confusion_matrix_device


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _metrics(criterion, outs, batch, num_classes: int) -> Dict[str, torch.Tensor]:
    sw = batch.get("weight")
    loss = criterion(outs, batch["label"], sample_weight=sw)
    with torch.no_grad():
        logits = (outs[0] if isinstance(outs, (list, tuple)) else outs).detach().float()
        dice = compute_dice(logits, batch["label"], sample_weight=sw)
        cm = confusion_matrix_device(batch["label"].argmax(-1), logits.argmax(-1), num_classes,
                                     sample_weight=sw)
    return {"loss": loss, "dice": dice, "cm": cm}


def make_train_step(criterion: Callable, num_classes: int):
    """``train_step(state, batch, generator) -> (state, {"loss", "dice", "cm"})``.

    ``batch`` holds ``"image"`` (N, *spatial, C_in), the one-hot ``"label"``
    (N, *spatial, num_classes) and optionally ``"weight"`` (N,) of 1/0, all
    on the model's device. ``generator`` (on that device) feeds the model's
    dropout; None where it has none (p = 0). The state is updated in place
    and returned.
    """

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        outs = model(batch["image"], generator=generator)
        out = _metrics(criterion, outs, batch, num_classes)
        out["loss"].backward()
        state.optimizer.step()
        state.step += 1
        out["loss"] = out["loss"].detach()
        return state, out

    return train_step


def make_eval_step(criterion: Callable, num_classes: int):
    """``eval_step(state, batch) -> {"loss", "dice", "cm"}``: no gradients,
    the model in eval mode (no dropout)."""

    def eval_step(state: TrainState, batch: Dict):
        model = state.model
        model.eval()
        with torch.no_grad():
            return _metrics(criterion, model(batch["image"]), batch, num_classes)

    return eval_step
