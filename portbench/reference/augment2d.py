"""The 2-D train augmentation of the PI-CAI22 preset (``transform_2d`` 1, 6,
7, 10), on the host, one sample at a time, from that sample's numpy
generator:

1. each channel divided by its maximum (where that is not 0), negatives 0;
6. a rotation about the image centre ((W - 1) / 2, (H - 1) / 2) by an angle
   chosen uniformly from (-15, -10, -5, 0, 5, 10, 15) degrees
   (``rng.integers(0, 7)``), bilinear for the image and nearest for the
   label, 0 outside: OpenCV's ``warpAffine``, as the source's code rotates,
   where ``cv2`` imports, else ``scipy.ndimage.map_coordinates`` (mode
   "constant") at the same coordinates;
7. with r = ``rng.uniform(0, 1)``: r < 0.3 flips W, else r < 0.6 flips H;
10. the image channels-last, the label one-hot with class 0 where no other
   class is set.

The loader gives sample ``index`` of epoch ``epoch`` the generator
``default_rng(SeedSequence([seed, epoch, index]))`` and, shuffling, takes
the epoch's order from ``default_rng(SeedSequence([seed, epoch]))``.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

try:
    import cv2
except ImportError:
    cv2 = None

DEGREES = (-15, -10, -5, 0, 5, 10, 15)
SUPPORTED = (1, 6, 7, 10)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    return order


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, index]))


def _rotate(img: np.ndarray, deg: float, order: int) -> np.ndarray:
    h, w = img.shape
    if cv2 is not None:
        m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), deg, 1.0)
        return cv2.warpAffine(img.astype(np.float32), m, (w, h),
                              flags=cv2.INTER_LINEAR if order == 1 else cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    ys = c * (yy - cy) - s * (xx - cx) + cy
    xs = s * (yy - cy) + c * (xx - cx) + cx
    return ndimage.map_coordinates(img.astype(np.float32), [ys, xs], order=order,
                                   mode="constant", cval=0.0)


def augment(image: np.ndarray, label: np.ndarray, rng: np.random.Generator,
            transforms, num_classes: int, flip_axes=(-1, -2)):
    """(C, H, W) image and (H, W) label -> (H, W, C) and (H, W, num_classes).
    ``flip_axes``: the axes of step 7's first and second branch (W, then H;
    the control swaps them as a planted fault)."""
    if tuple(transforms) != SUPPORTED:
        raise NotImplementedError(f"the reference augments transform_2d {SUPPORTED} only")
    image = image.astype(np.float32)
    for i in range(image.shape[0]):
        m = np.max(image[i])
        if m != 0:
            image[i] = image[i] / m
    image[image < 0] = 0
    deg = DEGREES[int(rng.integers(0, len(DEGREES)))]
    image = np.stack([_rotate(ch, deg, 1) for ch in image])
    label = _rotate(label.astype(np.float32), deg, 0)
    r = rng.uniform(0, 1)
    if r < 0.6:
        axis = flip_axes[0 if r < 0.3 else 1]
        image, label = np.flip(image, axis), np.flip(label, axis)
    onehot = np.zeros(label.shape + (num_classes,), np.float32)
    for z in range(1, num_classes):
        onehot[..., z] = label == z
    onehot[..., 0] = onehot[..., 1:].max(axis=-1) == 0
    return np.ascontiguousarray(np.moveaxis(image, 0, -1)), onehot
