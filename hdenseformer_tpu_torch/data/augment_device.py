"""Augmentation of a batch on its device, inside the train step.

Counterpart of ``hdenseformer_tpu/data/augment_jax.py``: plain functions on
channels-last tensors, image (B, *spatial, C) and label (B, *spatial) (a
float or integer volume of class indices). Each random function is split
in two:

- a *draw* (``draw_*``) from an explicit ``torch.Generator``, on the
  generator's device, with the per-sample values drawn as batch tensors;
- a deterministic *apply* that takes the drawn values.

``random_*`` is the draw followed by the apply. The split lets a test
replay JAX's draws exactly. Nothing here waits for the card: the crop
origins stay on the device and the crop is a gather.

- ``pet_ct_normalize``: channel 0 (CT) clipped to mean ± w and scaled by w,
  channel 1 (PET) to zero mean and unit population std (+ 1e-3) per sample;
- ``to_onehot``: one-hot of the class volume, background written as
  ``1 − max(foreground)``;
- ``random_crop``: a crop to ``patch`` per sample, the origin drawn from
  [0, extent − patch] inclusive (0 where the extent equals the patch);
- ``random_flip``: one of two flips per sample, spatial axis −2 (H) where
  a coin U > 0.5, else axis −1 (W);
- ``random_affine_3d``: translation (H and W, U(−5, 5) voxels), rotation
  about the D axis (U(−5, 5) degrees) and zoom (H and W, U(0.9, 1.1)),
  centred on ``size / 2``; the image warped trilinearly with zeros outside
  (``map_coordinates_linear``: JAX's ``map_coordinates(order=1, cval=0)``,
  each out-of-range corner zeroed on its own), each class z ≥ 1
  warped as a soft mask and set where it reaches 0.5, a later class over an
  earlier one. The mode test is on the Python string: ``"tr"`` never zooms;
- ``random_gamma``, ``random_noise``: the 2-D pipeline's intensity
  transforms;
- ``augment_batch_3d``: crop → normalise → affine ("tr") → flip → one-hot.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch


def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def _per_sample(values: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) values viewed to broadcast over a rank-``ndim`` batch."""
    return values.reshape((values.shape[0],) + (1,) * (ndim - 1))


def pet_ct_normalize(image: torch.Tensor, mean: float = 0.0, w: float = 1024.0) -> torch.Tensor:
    """Channel-0 CT clip and scale, channel-1 PET z-score per sample; the
    other channels as they are."""
    ct = (image[..., 0].clamp(mean - w, mean + w) - mean) / w
    pet = image[..., 1]
    dims = tuple(range(1, pet.ndim))
    mu = pet.mean(dim=dims, keepdim=True)
    # the population std, as jnp.std: sqrt(mean((x - mean)^2))
    sd = (pet - mu).square().mean(dim=dims, keepdim=True).sqrt()
    pet = (pet - mu) / (sd + 1e-3)
    return torch.cat([ct[..., None], pet[..., None], image[..., 2:]], dim=-1)


def to_onehot(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, *spatial, num_classes) float32; classes out of range are all 0
    before the background is written."""
    classes = torch.arange(num_classes, device=label.device)
    onehot = (label.long()[..., None] == classes).float()
    onehot[..., 0] = 1.0 - onehot[..., 1:].amax(dim=-1)
    return onehot


# --- crop ---------------------------------------------------------------------------


def draw_crop(generator: torch.Generator, shape: Sequence[int], patch: Sequence[int]
              ) -> torch.Tensor:
    """(B, len(patch)) int64 crop origins for a batch of ``shape``
    (B, *spatial[, C])."""
    b, dev = shape[0], generator.device
    cols = []
    for extent, p in zip(shape[1:1 + len(patch)], patch):
        hi = extent - p
        if hi < 0:
            raise ValueError(f"a batch of shape {tuple(shape)} is smaller than the patch "
                             f"{tuple(patch)}")
        if hi > 0:
            cols.append(torch.randint(0, hi + 1, (b,), generator=generator, device=dev))
        else:
            cols.append(torch.zeros((b,), dtype=torch.int64, device=dev))
    return torch.stack(cols, dim=1)


def crop(image: torch.Tensor, label: torch.Tensor, origins: torch.Tensor,
         patch: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop sample i to ``patch`` at ``origins[i]``: a gather on the device."""
    nsp, b, dev = len(patch), image.shape[0], image.device
    origins = origins.to(dev)
    index = [torch.arange(b, device=dev).reshape((b,) + (1,) * nsp)]
    for axis, p in enumerate(patch):
        view = [b] + [1] * nsp
        view[1 + axis] = p
        index.append((origins[:, axis, None] + torch.arange(p, device=dev)).reshape(view))
    return image[tuple(index)], label[tuple(index)]


def random_crop(generator, image, label, patch):
    return crop(image, label, draw_crop(generator, image.shape, patch), patch)


# --- flip ---------------------------------------------------------------------------


def draw_flip(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(B,) bool: True flips spatial axis −2 (H), False axis −1 (W)."""
    return torch.rand((batch,), generator=generator, device=generator.device) > 0.5


def flip(image: torch.Tensor, label: torch.Tensor, coins: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    nsp = label.ndim - 1
    h_ax, w_ax = nsp - 1, nsp  # in (B, *spatial[, C])
    coins = coins.to(image.device)
    image = torch.where(_per_sample(coins, image.ndim), image.flip(h_ax), image.flip(w_ax))
    label = torch.where(_per_sample(coins, label.ndim), label.flip(h_ax), label.flip(w_ax))
    return image, label


def random_flip(generator, image, label):
    return flip(image, label, draw_flip(generator, image.shape[0]))


# --- affine -------------------------------------------------------------------------


@dataclass
class AffineDraw:
    """Per-sample affine parameters: ``translation`` (B, 3) voxels (D, H,
    W; D is 0), ``angle`` (B,) radians about the D axis, ``zoom`` (B, 3)
    (D is 1)."""

    translation: torch.Tensor
    angle: torch.Tensor
    zoom: torch.Tensor


def draw_affine(generator: torch.Generator, batch: int, mode: str = "tr") -> AffineDraw:
    """The ranges of ``RandomTranslationRotationZoom3D``; a letter missing
    from ``mode`` ("t", "r", "z") leaves its part the identity."""
    dev = generator.device
    zero, one = torch.zeros((batch, 1), device=dev), torch.ones((batch, 1), device=dev)
    translation = torch.cat([zero, _uniform(generator, (batch, 2), -5.0, 5.0)], dim=1)
    degrees = _uniform(generator, (batch,), -5.0, 5.0)
    zoom = torch.cat([one, _uniform(generator, (batch, 2), 0.9, 1.1)], dim=1)
    return AffineDraw(
        translation=translation if "t" in mode else torch.zeros((batch, 3), device=dev),
        angle=degrees / 180.0 * math.pi if "r" in mode else torch.zeros((batch,), device=dev),
        zoom=zoom if "z" in mode else torch.ones((batch, 3), device=dev),
    )


def map_coordinates_linear(vol: torch.Tensor, coords: Sequence[torch.Tensor]) -> torch.Tensor:
    """Trilinear sampling of ``vol`` (B, *spatial, K) at ``coords`` (one
    float32 tensor per spatial axis, broadcasting to (B, *out)), zero
    outside: JAX's ``map_coordinates(order=1, cval=0)`` in its arithmetic.

    Each axis gives two taps (floor(c) with weight 1 − (c − floor(c)), and
    floor(c) + 1 with c − floor(c)); the 2^n corners are summed in JAX's
    order, each its weights' product times the value, a corner outside the
    volume counting 0. (``F.grid_sample`` zeroes corners the same way, but
    its normalised grid rounds the coordinates once more, which moves the
    result further from JAX's.)
    """
    b, spatial, k = vol.shape[0], vol.shape[1:-1], vol.shape[-1]
    flat = vol.reshape(-1, k)
    batch = torch.arange(b, device=vol.device).reshape((b,) + (1,) * len(spatial))
    taps = []
    for coord, n in zip(coords, spatial):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        taps.append([(index, 1 - upper_w, n), (index + 1, upper_w, n)])
    out = None
    for corner in itertools.product(*taps):
        offset, valid, weight = batch, None, None
        for index, w, n in corner:
            inside = (index >= 0) & (index < n)
            valid = inside if valid is None else valid & inside
            offset = offset * n + index.clamp(0, n - 1)
            weight = w if weight is None else weight * w
        term = weight[..., None] * torch.where(valid[..., None], flat[offset], 0.0)
        out = term if out is None else out + term
    return out


def affine_3d(image: torch.Tensor, label: torch.Tensor, draw: AffineDraw,
              num_classes: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp image (B, D, H, W, C) and label (B, D, H, W) by ``draw``.

    Output voxel p reads input coordinate ``M (p − size/2) + size/2 + t``
    with ``M = R_x(angle) @ diag(zoom)``. The image channels and the
    soft masks of classes 1.. are sampled together.
    """
    b, d, h, w, c = image.shape
    dev = image.device
    t, zoom = draw.translation.to(dev), draw.zoom.to(dev)
    ca, sa = torch.cos(draw.angle.to(dev)), torch.sin(draw.angle.to(dev))

    def centred(n, axis):
        view = [1, 1, 1, 1]
        view[1 + axis] = n
        return (torch.arange(n, dtype=torch.float32, device=dev) - n / 2.0).reshape(view)

    def col(v):  # (B,) -> (B, 1, 1, 1)
        return v.reshape(b, 1, 1, 1)

    gd, gh, gw = centred(d, 0), centred(h, 1), centred(w, 2)
    # size / 2 + t per axis (Python floats: no host-to-device copy)
    shift = [t[:, axis] + n / 2.0 for axis, n in enumerate((d, h, w))]
    coords = (col(zoom[:, 0]) * gd + col(shift[0]),
              col(ca * zoom[:, 1]) * gh + col(-sa * zoom[:, 2]) * gw + col(shift[1]),
              col(sa * zoom[:, 1]) * gh + col(ca * zoom[:, 2]) * gw + col(shift[2]))
    masks = [(label == z).float()[..., None] for z in range(1, num_classes)]
    out = map_coordinates_linear(torch.cat([image.float()] + masks, dim=-1), coords)
    new_label = torch.zeros((b, d, h, w), dtype=torch.float32, device=dev)
    for z in range(1, num_classes):
        new_label = torch.where(out[..., c + z - 1] >= 0.5, float(z), new_label)
    return out[..., :c].contiguous(), new_label


def random_affine_3d(generator, image, label, num_classes: int = 2, mode: str = "tr"):
    return affine_3d(image, label, draw_affine(generator, image.shape[0], mode), num_classes)


# --- intensity (the 2-D pipeline's) -------------------------------------------------


def draw_gamma(generator: torch.Generator, batch: int, lo: float = 0.8, hi: float = 1.2
               ) -> torch.Tensor:
    return _uniform(generator, (batch,), lo, hi)


def gamma(image: torch.Tensor, gammas: torch.Tensor) -> torch.Tensor:
    """max(image, 0) ** gamma, one gamma a sample."""
    return torch.pow(image.clamp_min(0.0), _per_sample(gammas.to(image.device), image.ndim))


def random_gamma(generator, image, lo: float = 0.8, hi: float = 1.2):
    return gamma(image, draw_gamma(generator, image.shape[0], lo, hi))


def draw_noise(generator: torch.Generator, shape: Sequence[int], p: float = 0.1,
               sigma: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) bool: the samples that get noise (U > 1 − p); N(0, sigma²) noise
    of ``shape``."""
    dev = generator.device
    apply = torch.rand((shape[0],), generator=generator, device=dev) > (1.0 - p)
    noise = torch.randn(tuple(shape), generator=generator, device=dev) * sigma
    return apply, noise


def add_noise(image: torch.Tensor, apply: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """clip(image + noise, 0, 1) in the samples of ``apply``."""
    noisy = (image + noise.to(image.device)).clamp(0.0, 1.0)
    return torch.where(_per_sample(apply.to(image.device), image.ndim), noisy, image)


def random_noise(generator, image, p: float = 0.1, sigma: float = 0.1):
    return add_noise(image, *draw_noise(generator, image.shape, p, sigma))


# --- the composed 3-D pipeline ------------------------------------------------------


@dataclass
class BatchDraw3D:
    """Everything ``augment_batch_3d`` draws for one batch."""

    patch: Tuple[int, ...]
    origins: torch.Tensor
    affine: AffineDraw
    flips: torch.Tensor

    def to(self, device) -> "BatchDraw3D":
        """The same draw on ``device``, to apply it there."""
        a = self.affine
        return BatchDraw3D(self.patch, self.origins.to(device),
                           AffineDraw(a.translation.to(device), a.angle.to(device),
                                      a.zoom.to(device)),
                           self.flips.to(device))


def draw_batch_3d(generator: torch.Generator, shape: Sequence[int], patch: Sequence[int],
                  affine_mode: str = "tr") -> BatchDraw3D:
    b = shape[0]
    return BatchDraw3D(patch=tuple(patch), origins=draw_crop(generator, shape, patch),
                       affine=draw_affine(generator, b, affine_mode),
                       flips=draw_flip(generator, b))


def apply_batch_3d(image: torch.Tensor, label: torch.Tensor, draw: BatchDraw3D,
                   num_classes: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """crop → PET/CT normalise → affine → flip → one-hot; returns the image
    (B, *patch, C) and the one-hot label (B, *patch, num_classes)."""
    image, label = crop(image, label, draw.origins, draw.patch)
    image = pet_ct_normalize(image.float())
    image, label = affine_3d(image, label, draw.affine, num_classes)
    image, label = flip(image, label, draw.flips)
    return image, to_onehot(label, num_classes)


def augment_batch_3d(generator: torch.Generator, image: torch.Tensor, label: torch.Tensor,
                     patch: Sequence[int], num_classes: int = 2, affine_mode: str = "tr"):
    """The device-side 3-D train pipeline of ``transform_3d=[1, 2, 4, 5, 6]``."""
    draw = draw_batch_3d(generator, image.shape, patch, affine_mode)
    return apply_batch_3d(image, label, draw, num_classes)
