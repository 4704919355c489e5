"""In-step batch dice, on the device.

Counterpart of ``hdenseformer_tpu/metrics/batch.py``: hard argmax dice per
class, mean over the non-background classes; a class absent from both
argmax maps keeps dice 1.0; ``sample_weight`` (N,) of 1/0 leaves padded
samples out. Everything stays a tensor on the logits' device: no host sync.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch


def _sum_in_order(v: torch.Tensor) -> torch.Tensor:
    """Sum of a short vector, left to right in its own dtype (as XLA sums
    one), so that the mean over samples or classes rounds as the JAX
    package's does. (``cumsum`` accumulates fp32 in double on the CPU.)"""
    return functools.reduce(torch.add, v.unbind(0))


def binary_dice(predict: torch.Tensor, target: torch.Tensor, smooth: float = 1e-5,
                sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard dice over flattened per-sample masks, mean over the batch."""
    p = predict.reshape(predict.shape[0], -1).float()
    t = target.reshape(target.shape[0], -1).float()
    inter = (p * t).sum(1)
    union = (p + t).sum(1)
    dice = (2.0 * inter + smooth) / (union + smooth)
    if sample_weight is None:
        return _sum_in_order(dice) / dice.shape[0]
    w = sample_weight.float()
    return _sum_in_order(dice * w) / torch.clamp_min(_sum_in_order(w), 1.0)


def compute_dice(logits: torch.Tensor, target: torch.Tensor, ignore_index: int = 0,
                 sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over non-background classes of hard argmax dice.

    logits and target: (N, *spatial, C) channels-last; target one-hot.
    """
    num_classes = logits.shape[-1]
    pred_lab = logits.argmax(-1)
    targ_lab = target.argmax(-1)
    wmask = None
    if sample_weight is not None:
        wmask = (sample_weight > 0).reshape((-1,) + (1,) * (pred_lab.dim() - 1))
    dices = []
    for i in range(num_classes):
        p, t = pred_lab == i, targ_lab == i
        if wmask is not None:
            p, t = p & wmask, t & wmask
        present = p.any() | t.any()
        d = binary_dice(p, t, sample_weight=sample_weight)
        dices.append(torch.where(present, d, torch.ones_like(d)))
    keep = torch.arange(num_classes, device=logits.device) != ignore_index
    kept = torch.where(keep, torch.stack(dices), torch.zeros((), device=logits.device))
    return _sum_in_order(kept) / torch.clamp_min(keep.sum(), 1)
