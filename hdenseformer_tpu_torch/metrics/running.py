"""Confusion matrix on the device; running dice, mIoU and averages on the host.

Counterpart of ``hdenseformer_tpu/metrics/running.py``. The train step
returns one small C x C integer matrix a batch (``confusion_matrix_device``,
no host sync); ``RunningDice`` and ``RunningConfusionMatrix`` add those up
on the host over an epoch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from hdenseformer_tpu_torch.parallel.mesh import global_sum


def confusion_matrix_device(ground_truth: torch.Tensor, prediction: torch.Tensor,
                            num_classes: int,
                            sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C x C int64 confusion matrix (rows truth, columns prediction).

    ``sample_weight`` (N,) of 1/0 leaves padded samples' voxels out; the
    inputs are then (N, *spatial). Each voxel adds one to its cell, truth *
    C + prediction, by an integer scatter-add: exact in any order. Under a
    data-parallel mesh the ranks' matrices are summed: the global batch's.
    """
    cells = num_classes * num_classes
    idx = ground_truth.long() * num_classes + prediction.long()
    if sample_weight is not None:
        keep = (sample_weight > 0).reshape((-1,) + (1,) * (idx.dim() - 1))
        idx = torch.where(keep, idx, cells)  # an extra cell that is not returned
    idx = idx.reshape(-1)
    counts = torch.zeros(cells + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return global_sum(counts[:cells].reshape(num_classes, num_classes))


class _RunningBase:
    """A running confusion matrix, accumulated on the host."""

    def __init__(self, labels: Sequence[int], ignore_label: int = 0):
        self.labels = list(labels)
        self.ignore_label = ignore_label
        self.overall_confusion_matrix: Optional[np.ndarray] = None

    def update_matrix(self, ground_truth, prediction) -> None:
        """Accumulate the matrix of one (truth, prediction) pair of label maps,
        skipped where the truth is all ``ignore_label``."""
        gt = np.asarray(ground_truth).astype(np.int64).ravel()
        if (gt == self.ignore_label).all():
            return
        c = len(self.labels)
        pr = np.asarray(prediction).astype(np.int64).ravel()
        self.update_from_matrix(np.bincount(gt * c + pr, minlength=c * c).reshape(c, c))

    def update_from_matrix(self, cm) -> None:
        """Accumulate a C x C matrix (e.g. the train step's ``cm``)."""
        if isinstance(cm, torch.Tensor):
            cm = cm.cpu().numpy()
        cm = np.asarray(cm).astype(np.int64)
        if self.overall_confusion_matrix is None:
            self.overall_confusion_matrix = cm
        else:
            self.overall_confusion_matrix += cm

    def init_op(self) -> None:
        self.overall_confusion_matrix = None


class RunningDice(_RunningBase):
    """Cumulative dice from a running confusion matrix."""

    def compute_dice(self, smooth: float = 1e-5):
        if self.overall_confusion_matrix is None:
            return 0.0, []
        cm = self.overall_confusion_matrix
        inter = np.diag(cm)
        union = cm.sum(axis=1) + cm.sum(axis=0)
        dice = (2 * inter + smooth) / (union.astype(np.float32) + smooth)
        return float(np.mean(dice[1:])), [round(float(c), 4) for c in dice]


class RunningConfusionMatrix(_RunningBase):
    """Cumulative mIoU from a running confusion matrix."""

    def compute_mIoU(self, smooth: float = 1e-5):
        if self.overall_confusion_matrix is None:
            return 0.0, []
        cm = self.overall_confusion_matrix
        inter = np.diag(cm)
        union = cm.sum(axis=1) + cm.sum(axis=0) - inter
        iou = (inter + smooth) / (union.astype(np.float32) + smooth)
        return float(np.mean(iou)), [round(float(c), 4) for c in iou]


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
