"""The 3-D train augmentation of the Hecktor21 preset on the host
(``transform_3d`` 1, 2, 4, 5, 6), one sample at a time, from that sample's
numpy generator, as the source's default trainer draws it on its loader's
threads:

1. a random crop to the patch: along each axis longer than the patch an
   origin ``rng.integers(0, extent - patch, endpoint=True)``, none where
   the axis is the patch;
2. PET/CT normalisation: CT (channel 0) clipped to +-1024 HU and divided by
   1024; PET (channel 1) less its mean, over its population standard
   deviation plus 1e-3, in float32;
4. translation and rotation ("tr"): t_H and t_W ``rng.uniform(-5, 5)``
   voxels, then an angle ``rng.uniform(-5, 5)`` degrees about the D axis
   (no zoom is drawn). Output voxel p reads the input at ``R (p - size/2)
   + size/2 + t``, with R's H row (cos, -sin) and W row (sin, cos) over (H,
   W): trilinear (``scipy.ndimage.map_coordinates``, order 1), 0 outside.
   Each foreground class's mask is warped alike and the class set where it
   reaches 0.5, a later class over an earlier one;
5. the "hv" flip: ``rng.uniform(0, 1) > 0.5`` flips H, else W;
6. the image channels-last, the label one-hot with class 0 where no other
   class is set.

The loader's order and each sample's generator are ``augment2d``'s
``epoch_order`` and ``sample_rng``.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

SUPPORTED = (1, 2, 4, 5, 6)


def _crop(image: np.ndarray, label: np.ndarray, patch, rng: np.random.Generator):
    for axis, p in enumerate(patch):
        extent = label.shape[axis]
        if extent > p:
            o = int(rng.integers(0, extent - p, endpoint=True))
            image = np.take(image, np.arange(o, o + p), axis=axis + 1)
            label = np.take(label, np.arange(o, o + p), axis=axis)
    return image, label


def _normalize(image: np.ndarray) -> np.ndarray:
    ct = np.clip(image[0], -1024.0, 1024.0) / 1024.0
    pet = image[1]
    pet = (pet - pet.mean()) / (pet.std() + 1e-3)
    return np.stack([ct, pet] + list(image[2:])).astype(np.float32)


def _coordinates(shape, shift_h: float, shift_w: float, angle_deg: float) -> np.ndarray:
    """(3, D, H, W) float64 input coordinates of each output voxel."""
    d, h, w = shape
    a = angle_deg / 180.0 * np.pi
    c, s = np.cos(a), np.sin(a)
    gd, gh, gw = np.meshgrid(np.arange(d, dtype=np.float64) - d / 2.0,
                             np.arange(h, dtype=np.float64) - h / 2.0,
                             np.arange(w, dtype=np.float64) - w / 2.0, indexing="ij")
    return np.stack([gd + d / 2.0,
                     c * gh - s * gw + (h / 2.0 + shift_h),
                     s * gh + c * gw + (w / 2.0 + shift_w)])


def _warp(vol: np.ndarray, coords: np.ndarray) -> np.ndarray:
    return ndimage.map_coordinates(vol.astype(np.float32), coords, order=1, mode="constant",
                                   cval=0.0)


def augment(image: np.ndarray, label: np.ndarray, rng: np.random.Generator, transforms,
            num_classes: int, patch, flip_axes=(1, 2)):
    """(C, D, H, W) raw image and (D, H, W) class label -> (D, H, W, C) and
    (D, H, W, num_classes). ``flip_axes``: the label axes of step 5's first
    and second branch (H, then W)."""
    if tuple(transforms) != SUPPORTED:
        raise NotImplementedError(f"the reference augments transform_3d {SUPPORTED} only")
    image, label = _crop(image, label, patch, rng)
    image = _normalize(image)
    shift_h, shift_w = rng.uniform(-5, 5), rng.uniform(-5, 5)
    coords = _coordinates(label.shape, shift_h, shift_w, rng.uniform(-5, 5))
    image = np.stack([_warp(ch, coords) for ch in image])
    warped = np.zeros(label.shape, np.float32)
    for z in range(1, num_classes):
        warped[_warp(label == z, coords) >= 0.5] = z
    axis = flip_axes[0 if rng.uniform(0, 1) > 0.5 else 1]
    image, label = np.flip(image, axis + 1), np.flip(warped, axis)
    onehot = np.zeros(label.shape + (num_classes,), np.float32)
    for z in range(1, num_classes):
        onehot[..., z] = label == z
    onehot[..., 0] = onehot[..., 1:].max(axis=-1) == 0
    return np.ascontiguousarray(np.moveaxis(image, 0, -1)), onehot
