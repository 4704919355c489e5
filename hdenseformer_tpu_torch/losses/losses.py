"""Segmentation losses of the port, channels-last, fp32.

Counterpart of ``hdenseformer_tpu/losses/losses.py``, whose conventions it
keeps: ``logits`` and ``target`` are ``(N, *spatial, C)``, ``target`` one-hot;
the loss math runs in fp32 whatever the model's compute dtype; every loss
takes ``sample_weight``, a (N,) vector of 1 (real sample) or 0 (padding),
and the weighted result equals the loss of the real samples alone.

Ported so far: ``focal_loss`` (the bench criterion, with JAX's clip of the
probabilities to [1e-7, 1 - 1e-7] and log clamp at -100),
``cross_entropy_loss`` (the trainer's default) and
``deep_supervision_loss`` (a nearest-resized one-hot target per head,
weights 1/2^i). ``get_loss`` keeps JAX's names; the other four raise
``NotImplementedError`` (ROADMAP.md queue 1 item 1).
"""
from __future__ import annotations

from functools import partial
from math import prod
from typing import Callable, Optional, Sequence

import torch

from hdenseformer_tpu_torch.ops.resize import resize_nearest

_LOG_CLAMP = -100.0  # torch F.binary_cross_entropy clamps log() at -100
_PROB_CLIP = 1e-7  # focal_loss keeps probabilities in [1e-7, 1 - 1e-7]


def _per_sample(sample_weight: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) weights as fp32 (N, 1, ..., 1) against a rank-``ndim`` tensor."""
    return sample_weight.float().reshape((-1,) + (1,) * (ndim - 1))


def _elementwise_reduce(loss: torch.Tensor, reduction: str,
                        sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """mean/sum over all elements, under an optional per-sample mask."""
    if sample_weight is None:
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        return loss
    sw = _per_sample(sample_weight, loss.dim())
    if reduction == "mean":
        per_sample = float(prod(loss.shape[1:]))
        return (loss * sw).sum() / torch.clamp_min(sw.sum() * per_sample, 1e-8)
    if reduction == "sum":
        return (loss * sw).sum()
    return loss * sw


def focal_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    alpha: float = 1.0,
    gamma: float = 2.0,
    reduction: str = "sum",
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Focal loss on softmax probabilities: per channel binary CE against the
    one-hot target, modulated by (1 - p_t)^gamma and weighted by alpha_t
    (with alpha = 1, alpha_t is the target)."""
    probs = torch.softmax(logits.float(), dim=-1)
    target = target.float()
    # the clip bounds d/dp of -log(1 - p) where the model saturates
    probs = probs.clamp(_PROB_CLIP, 1.0 - _PROB_CLIP)
    log_p = torch.log(probs).clamp_min(_LOG_CLAMP)
    log_1p = torch.log(1.0 - probs).clamp_min(_LOG_CLAMP)
    ce = -(target * log_p + (1.0 - target) * log_1p)
    p_t = probs * target + (1.0 - probs) * (1.0 - target)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * target + (1.0 - alpha) * (1.0 - target)
        loss = alpha_t * loss
    return _elementwise_reduce(loss, reduction, sample_weight)


def cross_entropy_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[Sequence[float]] = None,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax CE against argmax(one-hot target), mean over voxels; with
    class ``weight``, divided by the summed weights of the chosen labels."""
    labels = target.argmax(-1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    wsel = None
    if weight is not None:
        wsel = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)[labels]
    if sample_weight is not None:
        sw = _per_sample(sample_weight, nll.dim())
        wsel = sw.expand_as(nll) if wsel is None else wsel * sw
        return (nll * wsel).sum() / torch.clamp_min(wsel.sum(), 1e-8)
    if wsel is not None:
        return (nll * wsel).sum() / wsel.sum()
    return nll.mean()


def deep_supervision_loss(
    loss_fn: Callable[..., torch.Tensor],
    outputs: Sequence[torch.Tensor],
    target: torch.Tensor,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """sum_i loss(out_i, nearest-resize(target)) / 2^i."""
    total = torch.zeros((), dtype=torch.float32, device=target.device)
    for i, out in enumerate(outputs):
        tgt = resize_nearest(target, out.shape[1:-1])
        total = total + loss_fn(out, tgt, sample_weight=sample_weight) * (1.0 / (2.0 ** i))
    return total


LOSS_REGISTRY = {
    "Cross_Entropy": lambda class_weight=None, **kw: partial(
        cross_entropy_loss, weight=class_weight
    ),
    "FocalLoss": lambda class_weight=None, **kw: partial(focal_loss, reduction="sum"),
}
# the rest of JAX's registry, and where ROADMAP.md ports it
_NOT_YET = dict.fromkeys(
    ("TopKLoss", "DiceLoss", "CEPlusDice", "FLPlusDice"),
    "queue 1 item 1 (the training slice: the other losses)",
)


def get_loss(
    loss_fun: str,
    class_weight: Optional[Sequence[float]] = None,
    topk: int = 10,
    use_ds: bool = False,
) -> Callable:
    """``loss(outputs, target, sample_weight=None)`` for JAX's ``loss_fun``
    names; with ``use_ds`` the outputs are the deep-supervision heads."""
    if loss_fun in _NOT_YET:
        raise NotImplementedError(f"{loss_fun} is not ported yet: ROADMAP.md {_NOT_YET[loss_fun]}")
    if loss_fun not in LOSS_REGISTRY:
        options = sorted((*LOSS_REGISTRY, *_NOT_YET))
        raise ValueError(f"unknown loss {loss_fun!r}; options: {options}")
    base = LOSS_REGISTRY[loss_fun](class_weight=class_weight, topk=topk)
    if not use_ds:
        def loss(outputs, target, sample_weight=None):
            if isinstance(outputs, (list, tuple)):
                outputs = outputs[0]
            return base(outputs, target, sample_weight=sample_weight)
        return loss

    def ds_loss(outputs, target, sample_weight=None):
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        return deep_supervision_loss(base, outputs, target, sample_weight=sample_weight)

    return ds_loss
