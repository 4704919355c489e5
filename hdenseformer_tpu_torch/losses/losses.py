"""Segmentation losses of the port, channels-last, fp32.

Counterpart of ``hdenseformer_tpu/losses/losses.py``, whose conventions it
keeps: ``logits`` and ``target`` are ``(N, *spatial, C)``, ``target`` one-hot;
the loss math runs in fp32 whatever the model's compute dtype; every loss
takes ``sample_weight``, a (N,) vector of 1 (real sample) or 0 (padding),
and the weighted result equals the loss of the real samples alone. Under a
data-parallel mesh (``parallel/mesh.py``, ``with mesh:``) every reduction
over the batch is global: each rank returns the loss of the global batch,
as JAX's sharded loss is one value (a missing ``sample_weight`` is then
all ones).

Every loss of JAX's registry: ``focal_loss`` (JAX's clip of the
probabilities to [1e-7, 1 - 1e-7] and log clamp at -100), ``fl_loss`` (the
eps-clipped variant), ``cross_entropy_loss``, ``topk_loss`` (the mean CE of
the hardest k % of voxels; under ``sample_weight`` the masked top-k of the
real voxels), ``binary_dice_loss`` and ``dice_loss`` (softmax dice per
class), ``ce_plus_dice``, ``fl_plus_dice``, and ``deep_supervision_loss``
(a nearest-resized one-hot target per head, weights 1/2^i). ``get_loss``
takes every name of JAX's ``LOSS_REGISTRY``.
"""
from __future__ import annotations

from functools import lru_cache, partial
from math import prod
from typing import Callable, Optional, Sequence

import torch

from hdenseformer_tpu_torch.ops.resize import resize_nearest
from hdenseformer_tpu_torch.parallel.mesh import active_mesh, global_cat, global_sum

_LOG_CLAMP = -100.0  # torch F.binary_cross_entropy clamps log() at -100
_PROB_CLIP = 1e-7  # focal_loss keeps probabilities in [1e-7, 1 - 1e-7]


def _per_sample(sample_weight: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) weights as fp32 (N, 1, ..., 1) against a rank-``ndim`` tensor."""
    return sample_weight.float().reshape((-1,) + (1,) * (ndim - 1))


def _mesh_weight(sample_weight: Optional[torch.Tensor], like: torch.Tensor
                 ) -> Optional[torch.Tensor]:
    """``sample_weight``, or all ones under a mesh, where the reductions
    take the weighted (global) path."""
    if sample_weight is None and active_mesh() is not None:
        return torch.ones(like.shape[0], dtype=torch.float32, device=like.device)
    return sample_weight


def _elementwise_reduce(loss: torch.Tensor, reduction: str,
                        sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """mean/sum over all elements, under an optional per-sample mask."""
    sample_weight = _mesh_weight(sample_weight, loss)
    if sample_weight is None:
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        return loss
    sw = _per_sample(sample_weight, loss.dim())
    if reduction == "mean":
        per_sample = float(prod(loss.shape[1:]))
        return global_sum((loss * sw).sum()) / torch.clamp_min(
            global_sum(sw.sum()) * per_sample, 1e-8)
    if reduction == "sum":
        return global_sum((loss * sw).sum())
    return loss * sw


def _masked_topk_mean(flat: torch.Tensor, flat_w: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the top-k % real entries of ``flat`` under the 1/0 mask ``flat_w``.

    As JAX's: masked entries sort last (-1e30), the top list is over the
    padded length, and a data-dependent prefix ``floor(n_real * k / 100)``
    (at least 1) selects the real top set, counted in integers. No host sync. Under a mesh
    the top list is over the ranks' entries together.
    """
    flat, flat_w = global_cat(flat), global_cat(flat_w)
    kk_pad = max(int(flat.shape[0] * k / 100), 1)
    top = torch.topk(torch.where(flat_w > 0, flat, -1e30), kk_pad).values
    n_real = (flat_w > 0).sum()
    kk_real = torch.clamp(n_real * k // 100, 1, kk_pad)
    sel = torch.arange(kk_pad, device=flat.device) < kk_real
    return torch.where(sel, top, 0.0).sum() / kk_real.float()


def _per_sample_reduce(loss_vec: torch.Tensor, reduction: str, k: int,
                       sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Reduce a per-sample loss vector under an optional sample mask."""
    if reduction not in ("mean", "sum", "topk", "none"):
        raise ValueError(f"Unexpected reduction {reduction}")
    sample_weight = _mesh_weight(sample_weight, loss_vec)
    if sample_weight is None:
        if reduction == "mean":
            return loss_vec.mean()
        if reduction == "sum":
            return loss_vec.sum()
        if reduction == "topk":
            kk = max(int(loss_vec.shape[0] * k / 100), 1)
            return torch.topk(loss_vec, kk).values.mean()
        return loss_vec
    w = sample_weight.float()
    if reduction == "mean":
        return global_sum((loss_vec * w).sum()) / torch.clamp_min(global_sum(w.sum()), 1.0)
    if reduction == "sum":
        return global_sum((loss_vec * w).sum())
    if reduction == "topk":
        return _masked_topk_mean(loss_vec, w, k)
    return loss_vec * w


def binary_dice_loss(
    predict: torch.Tensor,
    target: torch.Tensor,
    smooth: float = 1e-5,
    p: int = 1,
    reduction: str = "mean",
    k: int = 50,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Soft dice loss on probabilities, per sample over the flattened rest.
    ``p`` is the denominator's power; ``reduction`` in {'mean', 'sum',
    'topk', 'none'}."""
    predict = predict.float().reshape(predict.shape[0], -1)
    target = target.float().reshape(target.shape[0], -1)
    inter = (predict * target).sum(1)
    union = (predict ** p + target ** p).sum(1)
    loss = 1.0 - (2.0 * inter + smooth) / (union + smooth)
    return _per_sample_reduce(loss, reduction, k, sample_weight)


def dice_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[Sequence[float]] = None,
    ignore_index: Optional[int] = None,
    smooth: float = 1e-5,
    p: int = 1,
    reduction: str = "mean",
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-class softmax dice: per (sample, class) soft dice over the
    spatial axes, reduced over samples per class, class-weighted, summed
    over the classes kept and divided by C - 1 with ``ignore_index`` (else C)."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    tg = target.float()
    axes = tuple(range(1, logits.dim() - 1))
    inter = (probs * tg).sum(axes)  # (N, C)
    union = (probs ** p + tg ** p).sum(axes)
    loss_nc = 1.0 - (2.0 * inter + smooth) / (union + smooth)
    per_class = torch.stack([_per_sample_reduce(loss_nc[:, c], reduction, 50, sample_weight)
                             for c in range(num_classes)])
    # a compare, not an indexed store (whose host scalar a CUDA graph cannot
    # capture): 0 at the ignored class, 1 elsewhere
    classes = torch.arange(num_classes, device=logits.device)
    ignored = -1 if ignore_index is None else ignore_index % num_classes
    class_mask = (classes != ignored).float()
    if weight is not None:
        per_class = per_class * _weights_on(weight, logits.device)
    denom = num_classes - 1 if ignore_index is not None else num_classes
    return (per_class * class_mask).sum() / denom


def topk_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[Sequence[float]] = None,
    k: int = 10,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE over the hardest k % of voxels (JAX's semantics: the mean, not
    the reference's unreduced vector)."""
    labels = target.argmax(-1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    if weight is not None:
        nll = nll * _weights_on(weight, logits.device)[labels]
    flat = nll.reshape(-1)
    sample_weight = _mesh_weight(sample_weight, nll)
    if sample_weight is not None:
        flat_w = _per_sample(sample_weight, nll.dim()).expand_as(nll).reshape(-1)
        return _masked_topk_mean(flat, flat_w, k)
    kk = max(int(flat.shape[0] * k / 100), 1)
    return torch.topk(flat, kk).values.mean()


def fl_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    alpha: float = 1.0,
    gamma: float = 2.0,
    reduction: str = "sum",
    eps: float = 1e-5,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The focal variant with probabilities clipped to [eps, 1 - eps] and
    plain logs."""
    probs = torch.softmax(logits.float(), dim=-1).clamp(eps, 1.0 - eps)
    target = target.float()
    ce = -target * torch.log(probs) - (1.0 - target) * torch.log(1.0 - probs)
    p_t = probs * target + (1.0 - probs) * (1.0 - target)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * target + (1.0 - alpha) * (1.0 - target)) * loss
    return _elementwise_reduce(loss, reduction, sample_weight)


def ce_plus_dice(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[Sequence[float]] = None,
    ignore_index: Optional[int] = None,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CE + softmax dice."""
    return cross_entropy_loss(logits, target, weight=weight, sample_weight=sample_weight) + \
        dice_loss(logits, target, weight=weight, ignore_index=ignore_index,
                  sample_weight=sample_weight)


def fl_plus_dice(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[Sequence[float]] = None,
    ignore_index: Optional[int] = None,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FocalLoss (mean) + softmax dice."""
    return focal_loss(logits, target, reduction="mean", sample_weight=sample_weight) + \
        dice_loss(logits, target, weight=weight, ignore_index=ignore_index,
                  sample_weight=sample_weight)


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
        wsel = _weights_on(weight, logits.device)[labels]
    sample_weight = _mesh_weight(sample_weight, nll)
    if sample_weight is not None:
        sw = _per_sample(sample_weight, nll.dim())
        wsel = sw.expand_as(nll) if wsel is None else wsel * sw
        return global_sum((nll * wsel).sum()) / torch.clamp_min(global_sum(wsel.sum()), 1e-8)
    if wsel is not None:
        return (nll * wsel).sum() / wsel.sum()
    return nll.mean()


@lru_cache(maxsize=None)
def _class_weights(weight: tuple, device: torch.device) -> torch.Tensor:
    """A class-weight vector on ``device``, made at its first use: a step
    captured as a CUDA graph reads it (a copy from the host cannot be
    captured)."""
    with torch.inference_mode(False):
        return torch.tensor(weight, dtype=torch.float32, device=device)


def _weights_on(weight: Sequence[float], device: torch.device) -> torch.Tensor:
    return _class_weights(tuple(float(w) for w in weight), device)


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
    "TopKLoss": lambda class_weight=None, topk=10, **kw: partial(
        topk_loss, weight=class_weight, k=topk
    ),
    "FocalLoss": lambda class_weight=None, **kw: partial(focal_loss, reduction="sum"),
    "DiceLoss": lambda class_weight=None, **kw: partial(
        dice_loss, weight=class_weight, ignore_index=0, p=1
    ),
    "CEPlusDice": lambda class_weight=None, **kw: partial(
        ce_plus_dice, weight=class_weight, ignore_index=0
    ),
    "FLPlusDice": lambda class_weight=None, **kw: partial(
        fl_plus_dice, weight=class_weight, ignore_index=0
    ),
}


def get_loss(
    loss_fun: str,
    class_weight: Optional[Sequence[float]] = None,
    topk: int = 10,
    use_ds: bool = False,
) -> Callable:
    """``loss(outputs, target, sample_weight=None)`` for JAX's ``loss_fun``
    names; with ``use_ds`` the outputs are the deep-supervision heads."""
    if loss_fun not in LOSS_REGISTRY:
        raise ValueError(f"unknown loss {loss_fun!r}; options: {sorted(LOSS_REGISTRY)}")
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
