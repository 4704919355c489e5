"""Host-side preprocessing used by serving.

A copy of ``PETandCTNormalize`` from ``hdenseformer_tpu/data/transforms.py``
(the port imports nothing of the JAX package).
"""
from __future__ import annotations

import numpy as np


class PETandCTNormalize:
    """ch0: CT clip +-w then /w; ch1: PET z-score (ref data_loader.py:53-68)."""

    def __init__(self, mean: float = 0.0, w: float = 1024.0):
        self.mean = mean
        self.w = w

    def __call__(self, sample, rng=None):
        image = sample["image"].astype(np.float32)
        image[0] = (np.clip(image[0], self.mean - self.w, self.mean + self.w) - self.mean) / self.w
        m = np.mean(image[1])
        s = np.std(image[1])
        image[1] = (image[1] - m) / (s + 1e-3)
        sample["image"] = image
        return sample
