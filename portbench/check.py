"""The numbers that decide ``correct``, each against a limit of the cell
(``portbench/workloads/<cell>.json``).

Training, over the first three steps of the object the window trains, and
over the leaves whose reference gradient is at least a thousandth of the
median leaf's (a bias that a norm without an affine follows, as each
UpConv's, has a gradient of rounding alone: in bf16 its norm reads about a
fifth of the median leaf's, and Adam moves it by rounding's sign):

- ``grad_gap``: the first gradient as the optimizer took it (Adam's first
  moment after one step, over 1 - beta1), by the worst leaf: the gap
  between the system's norm and the reference's, over the larger of the
  reference's norm and the median leaf's; ``grad_gap_median`` the same by
  the median leaf;
- ``update_gap``, ``update_gap_median``: the weights' change after three
  steps, by the worst and by the median leaf in the same measure;
- ``augment_gap`` (host augmentation): the largest absolute difference
  between the batches the loader fed the step and those the reference
  augments itself from the same samples and generators.

``loss_gap`` (the largest relative gap of a step's loss) and the gradient
gap over every leaf are reported beside them and decide nothing.

Serving, over a sample of the finished volumes: ``label_gap``, the widest
gap by which the reference's mean probability of a served label lies
below the reference's best class at that voxel. A served volume of the
wrong shape, or a label outside the classes, reads 1.
"""
from __future__ import annotations

from typing import Dict

import torch

MOVED_FLOOR = 1e-3  # of the median leaf's gradient norm
TRAIN_READINGS = ("grad_gap", "grad_gap_median", "update_gap", "update_gap_median", "loss_gap")


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves
              ) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    p = {n: float(prog[n].double().norm()) for n in leaves}
    r = {n: float(ref[n].double().norm()) for n in leaves}
    median = float(torch.tensor(list(r.values())).median())
    return {n: abs(p[n] - r[n]) / max(r[n], median, 1e-30) for n in leaves}


def _worst_and_median(prog, ref, leaves) -> tuple:
    gaps = torch.tensor(list(leaf_gaps(prog, ref, leaves).values()), dtype=torch.float64)
    return float(gaps.max()), float(gaps.median())


def moved_leaves(ref_grads: Dict[str, torch.Tensor]) -> list:
    """The leaves whose reference gradient is at least ``MOVED_FLOOR`` of
    the median leaf's."""
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return [n for n in norms if norms[n] >= MOVED_FLOOR * median]


def train_readings(prog: dict, ref: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold "losses" (the first three steps'),
    "first_grads" and "params" (after three steps); ``start`` the weights
    both began from."""
    moved = moved_leaves(ref["first_grads"])
    delta_p = {n: prog["params"][n] - start[n] for n in moved}
    delta_r = {n: ref["params"][n] - start[n] for n in moved}
    grad = _worst_and_median(prog["first_grads"], ref["first_grads"], moved)
    update = _worst_and_median(delta_p, delta_r, moved)
    return {"grad_gap": grad[0], "grad_gap_median": grad[1],
            "update_gap": update[0], "update_gap_median": update[1],
            "loss_gap": loss_gap(prog, ref)}


def loss_gap(prog: dict, ref: dict) -> float:
    """The largest relative gap of a step's loss to the reference's."""
    if len(prog["losses"]) != len(ref["losses"]):
        return 1.0
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))


def augment_gap(got: list, want: list) -> float:
    """``got``: the batches fed to the step ("image", "label" one-hot);
    ``want``: the reference's ("image", "onehot"). Batches of another
    count or shape read 1, the widest gap of a one-hot label."""
    if len(got) != len(want):
        return 1.0
    gap = 0.0
    for g, w in zip(got, want):
        for a, b in ((g["image"], w["image"]), (g["label"], w["onehot"])):
            if tuple(a.shape) != tuple(b.shape):
                return 1.0
            gap = max(gap, float((a.to(b.device).float() - b.float()).abs().max()))
    return gap


def label_gap(labels, probs: torch.Tensor) -> float:
    """``labels`` (*spatial) served, ``probs`` (*spatial, classes) the
    reference's mean probabilities."""
    labels = torch.as_tensor(labels)
    if tuple(labels.shape) != tuple(probs.shape[:-1]):
        return 1.0
    labels = labels.to(probs.device).long()
    if labels.min() < 0 or labels.max() >= probs.shape[-1]:
        return 1.0
    served = probs.gather(-1, labels[..., None])[..., 0]
    return float((probs.amax(-1) - served).max())
