"""The 3-D train augmentation of the Hecktor21 preset (``transform_3d`` 1, 2,
4, 5, 6: random crop, PET/CT normalise, translation and rotation, flip,
one-hot), as drawn on the device from one generator a step.

The draws, in order: each cropped axis's origin (an integer in [0, extent
- patch], none where the extent is the patch), then for the batch the
translation of H and W (U(-5, 5) voxels), the rotation about D (U(-5, 5)
degrees), the zoom of H and W (U(0.9, 1.1); drawn, unused in mode "tr"),
then one coin a sample (U > 0.5 flips H, else W). The warp samples the
image and the foreground masks trilinearly at ``M (p - size/2) + size/2 +
t``, corners outside the volume counting 0, and a class is set where its
mask reaches 0.5.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def augment(gen: torch.Generator, image: torch.Tensor, label: torch.Tensor,
            patch: Sequence[int], num_classes: int):
    """image (B, D, H, W, C) raw, label (B, D, H, W) classes -> the image and
    the one-hot label (B, *patch, num_classes)."""
    b, dev = image.shape[0], image.device
    origins = []
    for extent, p in zip(image.shape[1:4], patch):
        if extent > p:
            origins.append(torch.randint(0, extent - p + 1, (b,), generator=gen, device=dev))
        else:
            origins.append(torch.zeros((b,), dtype=torch.int64, device=dev))
    shift_hw = _uniform(gen, (b, 2), -5.0, 5.0)
    angle = _uniform(gen, (b,), -5.0, 5.0) / 180.0 * math.pi
    _uniform(gen, (b, 2), 0.9, 1.1)  # the zoom, drawn and not applied in mode "tr"
    flip_h = torch.rand((b,), generator=gen, device=dev) > 0.5

    # crop
    idx = [torch.arange(b, device=dev).view(b, 1, 1, 1)]
    for axis, p in enumerate(patch):
        view = [b, 1, 1, 1]
        view[1 + axis] = p
        idx.append((origins[axis][:, None] + torch.arange(p, device=dev)).view(view))
    image, label = image[tuple(idx)].float(), label[tuple(idx)]

    # PET/CT normalise: CT clipped to +-1024 and scaled, PET z-scored per sample
    ct = image[..., 0].clamp(-1024.0, 1024.0) / 1024.0
    pet = image[..., 1]
    mu = pet.mean(dim=(1, 2, 3), keepdim=True)
    sd = (pet - mu).square().mean(dim=(1, 2, 3), keepdim=True).sqrt()
    image = torch.stack([ct, (pet - mu) / (sd + 1e-3)], dim=-1)

    # translation and rotation about D, centred on size / 2
    _, d, h, w, c = image.shape
    ca, sa = torch.cos(angle).view(b, 1, 1, 1), torch.sin(angle).view(b, 1, 1, 1)

    def centred(n, axis):
        view = [1, 1, 1, 1]
        view[1 + axis] = n
        return (torch.arange(n, dtype=torch.float32, device=dev) - n / 2.0).view(view)

    gd, gh, gw = centred(d, 0), centred(h, 1), centred(w, 2)
    th = shift_hw[:, 0].view(b, 1, 1, 1) + h / 2.0
    tw = shift_hw[:, 1].view(b, 1, 1, 1) + w / 2.0
    coords = (gd + d / 2.0 + torch.zeros((b, 1, 1, 1), device=dev),
              ca * gh - sa * gw + th, sa * gh + ca * gw + tw)
    masks = [(label == z).float()[..., None] for z in range(1, num_classes)]
    warped = _trilinear(torch.cat([image] + masks, dim=-1), coords)
    new_label = torch.zeros((b, d, h, w), device=dev)
    for z in range(1, num_classes):
        new_label = torch.where(warped[..., c + z - 1] >= 0.5, float(z), new_label)
    image = warped[..., :c]

    # flip H or W
    fh = flip_h.view(b, 1, 1, 1)
    image = torch.where(fh[..., None], image.flip(2), image.flip(3))
    new_label = torch.where(fh, new_label.flip(2), new_label.flip(3))

    onehot = (new_label.long()[..., None] == torch.arange(num_classes, device=dev)).float()
    onehot[..., 0] = 1.0 - onehot[..., 1:].amax(dim=-1)
    return image, onehot


def _trilinear(vol: torch.Tensor, coords) -> torch.Tensor:
    """vol (B, D, H, W, K) sampled at float coordinates (one tensor an axis,
    broadcasting to (B, D, H, W)), zero outside, corners summed in
    (D, H, W) lower-then-upper order."""
    b, spatial, k = vol.shape[0], vol.shape[1:4], vol.shape[-1]
    flat = vol.reshape(-1, k)
    batch = torch.arange(b, device=vol.device).view(b, 1, 1, 1)
    taps = []
    for coord, n in zip(coords, spatial):
        lo = torch.floor(coord)
        frac = coord - lo
        i = lo.to(torch.int64)
        taps.append([(i, 1 - frac, n), (i + 1, frac, n)])
    out = None
    for corner in itertools.product(*taps):
        offset, valid, weight = batch, None, None
        for i, wgt, n in corner:
            inside = (i >= 0) & (i < n)
            valid = inside if valid is None else valid & inside
            offset = offset * n + i.clamp(0, n - 1)
            weight = wgt if weight is None else weight * wgt
        term = weight[..., None] * torch.where(valid[..., None], flat[offset], 0.0)
        out = term if out is None else out + term
    return out
