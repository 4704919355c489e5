"""Deterministic host-side preprocessing transforms (numpy and scipy).

A copy of ``hdenseformer_tpu/data/transforms.py`` (the port imports nothing
of the JAX package), so that the same (seed, epoch, index) gives the same
sample bit for bit:

- every stochastic transform takes an explicit ``numpy.random.Generator``;
- the final tensorization emits channels-last arrays: image ``(*spatial,
  C)``, one-hot label ``(*spatial, num_class)`` with background as the
  complement in channel 0.

Inside the pipeline ``image`` is ``(C, *spatial)`` or ``(*spatial)`` and
``label`` is ``(*spatial)`` with integer class values. ``resize_half_pixel``
stands in for skimage's resize: linear interpolation at half-pixel centres
with optional gaussian anti-aliasing (sigma = (scale - 1) / 2).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def resize_half_pixel(
    image: np.ndarray,
    out_shape: Sequence[int],
    order: int = 1,
    anti_aliasing: bool = False,
) -> np.ndarray:
    """skimage-style resize: half-pixel sampling, optional gaussian AA."""
    out_shape = tuple(int(s) for s in out_shape)
    if image.shape == out_shape:
        return image.astype(np.float32, copy=True)
    img = image.astype(np.float32)
    factors = np.array(
        [i / o for i, o in zip(image.shape, out_shape)], dtype=np.float64
    )
    if anti_aliasing:
        sigma = np.maximum(0.0, (factors - 1.0) / 2.0)
        if np.any(sigma > 0):
            img = ndimage.gaussian_filter(img, sigma, mode="mirror")
    coords = np.meshgrid(
        *[
            (np.arange(o, dtype=np.float64) + 0.5) * f - 0.5
            for o, f in zip(out_shape, factors)
        ],
        indexing="ij",
    )
    return ndimage.map_coordinates(
        img, np.asarray(coords), order=order, mode="nearest"
    ).astype(np.float32)


def resize_label_per_class(
    label: np.ndarray, out_shape: Sequence[int], num_class: int
) -> np.ndarray:
    """Per-class soft resize with a 0.5 threshold."""
    out = np.zeros(tuple(out_shape), dtype=np.float32)
    for z in range(1, num_class):
        roi = resize_half_pixel((label == z).astype(np.float32), out_shape, order=1)
        out[roi >= 0.5] = z
    return out


class TruncAndNormalize:
    """CT window truncation to [0, 1]."""

    def __init__(self, scale: Optional[Tuple[float, float]] = None):
        self.scale = scale
        if self.scale is not None and len(self.scale) != 2:
            raise ValueError(f"scale must be (low, high), got {self.scale}")

    def __call__(self, sample, rng=None):
        image = sample["image"].astype(np.float32)
        image = image - self.scale[0]
        gray_range = self.scale[1] - self.scale[0]
        image = np.clip(image, 0, gray_range) / gray_range
        sample["image"] = image
        return sample


class MRNormalize:
    """Per-channel max-division, negatives clipped."""

    def __call__(self, sample, rng=None):
        image = sample["image"].astype(np.float32)
        if image.ndim > sample["label"].ndim:
            for i in range(image.shape[0]):
                m = np.max(image[i])
                if m != 0:
                    image[i] = image[i] / m
        else:
            m = np.max(image)
            if m != 0:
                image = image / m
        image[image < 0] = 0
        sample["image"] = image
        return sample


class PETandCTNormalize:
    """ch0: CT clip +-w then /w; ch1: PET z-score."""

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


class CropResize:
    """Crop the border, then resize to a fixed dim."""

    def __init__(self, dim=None, num_class: int = 2, crop: int = 0, channel: int = 1):
        self.dim = tuple(dim) if dim is not None else None
        self.num_class = num_class
        self.crop = crop
        self.channel = channel

    def __call__(self, sample, rng=None):
        image = sample["image"]
        label = sample["label"]
        mm = 1 if self.channel > 1 else 0
        c = self.crop
        if c != 0:
            if mm:
                image = image[..., c:-c, c:-c]
                label = label[..., c:-c, c:-c]
            elif image.ndim == 2:
                image = image[c:-c, c:-c]
                label = label[c:-c, c:-c]
            else:
                image = image[:, c:-c, c:-c]
                label = label[:, c:-c, c:-c]
        if self.dim is not None and label.shape != self.dim:
            if mm:
                out = np.empty((self.channel,) + self.dim, dtype=np.float32)
                for i in range(image.shape[0]):
                    out[i] = resize_half_pixel(image[i], self.dim, anti_aliasing=True)
                image = out
            else:
                image = resize_half_pixel(image, self.dim, anti_aliasing=True)
            label = resize_label_per_class(label, self.dim, self.num_class)
        sample["image"] = image
        sample["label"] = label
        return sample


class ToOneHot:
    """Tensorize to channels-last arrays.

    image -> (*spatial, C) float32; label -> (*spatial, num_class) one-hot
    with channel 0 the complement of the foreground union.
    """

    def __init__(self, num_class: int = 2, input_channel: int = 3):
        self.num_class = num_class
        self.channel = input_channel

    def __call__(self, sample, rng=None):
        image = np.asarray(sample["image"], dtype=np.float32)
        label = np.asarray(sample["label"])
        if self.channel > 1:
            image = image[: self.channel]
        else:
            if image.ndim == label.ndim:
                image = image[None]
        onehot = np.zeros(label.shape + (self.num_class,), dtype=np.float32)
        for z in range(1, self.num_class):
            onehot[..., z] = (label == z).astype(np.float32)
        onehot[..., 0] = (np.amax(onehot[..., 1:], axis=-1) == 0).astype(np.float32)
        sample["image"] = np.ascontiguousarray(np.moveaxis(image, 0, -1))
        sample["label"] = onehot
        return sample


def remap_roi_labels(label: np.ndarray, roi_number, num_class: int) -> np.ndarray:
    """ROI extraction: one ROI value as class 1, or a list of them as 1..K."""
    if roi_number is None:
        return label
    if isinstance(roi_number, list):
        if num_class != len(roi_number) + 1:
            raise ValueError(f"num_class {num_class} for {len(roi_number)} ROIs")
        out = np.zeros_like(label, dtype=np.float32)
        for i, roi in enumerate(roi_number):
            out[label == roi] = i + 1
        return out
    if num_class != 2:
        raise ValueError(f"one ROI makes 2 classes, not {num_class}")
    return (label == roi_number).astype(np.float32)


class RawChannelsLast:
    """Minimal tensorization for an on-device augmentation path: image to
    channels-last float32, label kept as an integer volume."""

    def __call__(self, sample, rng=None):
        image = np.asarray(sample["image"], dtype=np.float32)
        label = np.asarray(sample["label"], dtype=np.float32)
        if image.ndim == label.ndim:
            image = image[None]
        sample["image"] = np.ascontiguousarray(np.moveaxis(image, 0, -1))
        sample["label"] = label
        return sample


class Compose:
    """Sequential transform composition threading the RNG through."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample, rng=None):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample
