"""Offline evaluation metrics: Dice, Jaccard, volume similarity, HD95, ASD.

A copy of ``hdenseformer_tpu/metrics/eval3d.py`` (numpy and scipy; the port
imports nothing of the JAX package):

- overlap measures from the 2 x 2 contingency of two binary masks;
- surfaces = a mask minus its face-connected erosion;
- surface distances by scipy's exact Euclidean distance transform,
  anisotropic spacing allowed;
- HD = the max of both directed surface distances, HD95 = the 95th
  percentile of both directions pooled, ASD = their mean.

Where either mask is empty the distance metrics are NaN.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary voxels of a binary mask (face connectivity)."""
    if not mask.any():
        return np.zeros_like(mask, dtype=bool)
    struct = ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = ndimage.binary_erosion(mask, structure=struct, border_value=0)
    return mask & ~eroded


def _surface_distances(
    a: np.ndarray, b: np.ndarray, spacing: Optional[Sequence[float]] = None
) -> np.ndarray:
    """Distances from every surface voxel of ``a`` to the nearest surface voxel of ``b``."""
    surf_a = _surface(a)
    surf_b = _surface(b)
    dt = ndimage.distance_transform_edt(~surf_b, sampling=spacing)
    return dt[surf_a]


def cal_score(
    predict: np.ndarray,
    target: np.ndarray,
    spacing: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """Overlap and Hausdorff metrics of two binary masks."""
    predict = np.asarray(predict).astype(bool)
    target = np.asarray(target).astype(bool)
    tp = float(np.count_nonzero(predict & target))
    p = float(np.count_nonzero(predict))
    t = float(np.count_nonzero(target))
    union = p + t - tp
    result = {
        "Jaccard": tp / union if union > 0 else 0.0,
        "Dice": 2 * tp / (p + t) if (p + t) > 0 else 0.0,
        "VolumeSimilarity": 2 * (p - t) / (p + t) if (p + t) > 0 else 0.0,
        "FalseNegativeError": (t - tp) / t if t > 0 else 0.0,
        "FalsePositiveError": (p - tp) / p if p > 0 else 0.0,
        "HausdorffDistance": np.nan,
        "HausdorffDistance95": np.nan,
    }
    if not predict.any() or not target.any():
        return result

    seg2ref = _surface_distances(predict, target, spacing)
    ref2seg = _surface_distances(target, predict, spacing)
    all_d = np.concatenate([seg2ref, ref2seg])
    result["HausdorffDistance"] = float(all_d.max()) if all_d.size else 0.0
    result["HausdorffDistance95"] = float(np.percentile(all_d, 95)) if all_d.size else 0.0
    return result


def _multi(metric_key: str):
    def fn(y_true, y_pred, num_classes) -> Tuple[list, float]:
        vals = [
            cal_score(np.asarray(y_pred) == i + 1, np.asarray(y_true) == i + 1)[metric_key]
            for i in range(num_classes)
        ]
        vals = [round(float(v), 4) for v in vals]
        return vals, round(float(np.mean(vals)), 4)

    return fn


multi_dice = _multi("Dice")
multi_hd = _multi("HausdorffDistance95")
multi_vs = _multi("VolumeSimilarity")
multi_jc = _multi("Jaccard")


def cal_asd(
    predict: np.ndarray,
    target: np.ndarray,
    spacing: Optional[Sequence[float]] = None,
) -> float:
    """Average symmetric surface distance."""
    predict = np.asarray(predict).astype(bool)
    target = np.asarray(target).astype(bool)
    if not predict.any() or not target.any():
        return float("nan")
    seg2ref = _surface_distances(predict, target, spacing)
    ref2seg = _surface_distances(target, predict, spacing)
    return float(np.concatenate([seg2ref, ref2seg]).mean())


def multi_asd(y_true, y_pred, num_classes) -> Tuple[list, float]:
    vals = [cal_asd(np.asarray(y_pred) == i + 1, np.asarray(y_true) == i + 1)
            for i in range(num_classes)]
    vals = [round(float(v), 4) for v in vals]
    return vals, round(float(np.mean(vals)), 4)
