"""3-D augmentations on the host: crop, affine (translate-rotate-zoom), flip.

A copy of ``hdenseformer_tpu/data/augment3d.py`` (the port imports nothing
of the JAX package), with explicit ``numpy.random.Generator``s:

- ``RandomCrop3D``: an independent random crop per dim to the patch size;
- ``RandomTranslationRotationZoom3D``: a centred affine warp (rotation about
  x, per-axis zoom, in-plane translation) evaluated with
  ``scipy.ndimage.map_coordinates(order=1)`` and constant 0 padding, each
  foreground class warped and thresholded at 0.5;
- ``RandomFlip3D``: 'hv' flips H or W with p = 0.5 each branch.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def _rot_x(angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


class RandomCrop3D:
    def __init__(self, shape):
        self.shape = tuple(shape)
        if len(self.shape) != 3:
            raise ValueError(f"RandomCrop3D takes a 3-D shape, got {self.shape}")

    def __call__(self, sample, rng: np.random.Generator):
        image = sample["image"]
        label = sample["label"]
        mm = 1 if image.ndim > 3 else 0
        for i in range(3):
            extent = image.shape[i + mm]
            if extent > self.shape[i]:
                b = int(rng.integers(0, extent - self.shape[i], endpoint=True))
                sl = slice(b, b + self.shape[i])
                idx_img = (slice(None),) * (i + mm) + (sl,)
                idx_lab = (slice(None),) * i + (sl,)
                image = image[idx_img]
                label = label[idx_lab]
        sample["image"] = image
        sample["label"] = label
        return sample


class RandomTranslationRotationZoom3D:
    def __init__(self, mode: str = "trz", num_class: int = 2):
        self.mode = mode
        self.num_class = num_class

    def __call__(self, sample, rng: np.random.Generator):
        image = sample["image"]
        label = sample["label"]
        size = np.asarray(label.shape, dtype=np.float64)

        if "t" in self.mode:
            translation = np.array([0.0, rng.uniform(-5, 5), rng.uniform(-5, 5)])
        else:
            translation = np.zeros(3)
        if "r" in self.mode:
            rotation = _rot_x(rng.uniform(-5, 5) / 180.0 * np.pi)
        else:
            rotation = np.eye(3)
        if "z" in self.mode:
            zoom = np.array([1.0, rng.uniform(0.9, 1.1), rng.uniform(0.9, 1.1)])
        else:
            zoom = np.ones(3)

        # output voxel (centred) -> input coordinate: M @ x_c + centre + t
        M = rotation @ np.diag(zoom)
        grid = np.mgrid[: label.shape[0], : label.shape[1], : label.shape[2]].astype(
            np.float64
        )
        centered = grid - (size / 2.0)[:, None, None, None]
        warped = np.einsum("ij,j...->i...", M, centered)
        warped += (size / 2.0 + translation)[:, None, None, None]

        def warp(vol):
            return ndimage.map_coordinates(
                vol.astype(np.float32), warped, order=1, mode="constant", cval=0.0
            )

        if image.ndim > 3:
            image = np.stack([warp(image[i]) for i in range(image.shape[0])])
        else:
            image = warp(image)
        new_label = np.zeros(label.shape, dtype=np.float32)
        for z in range(1, self.num_class):
            soft = warp((label == z).astype(np.float32))
            new_label[soft >= 0.5] = z
        sample["image"] = image
        sample["label"] = new_label
        return sample


class RandomFlip3D:
    def __init__(self, mode: str = "hv"):
        self.mode = mode

    def __call__(self, sample, rng: np.random.Generator):
        image = sample["image"]
        label = sample["label"]
        mm = 1 if image.ndim > 3 else 0

        if "h" in self.mode and "v" in self.mode:
            if rng.uniform(0, 1) > 0.5:
                image = np.flip(image, axis=1 + mm)
                label = np.flip(label, axis=1)
            else:
                image = np.flip(image, axis=-1)
                label = np.flip(label, axis=-1)
        elif "h" in self.mode:
            image = np.flip(image, axis=1 + mm)
            label = np.flip(label, axis=1)
        elif "v" in self.mode:
            image = np.flip(image, axis=-1)
            label = np.flip(label, axis=-1)
        sample["image"] = np.ascontiguousarray(image)
        sample["label"] = np.ascontiguousarray(label)
        return sample
