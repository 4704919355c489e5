"""Offline data conversion: per-case NIfTI volumes -> per-case HDF5.

The conversions of ``hdenseformer_tpu/data/convert.py`` that the CLI's
``convert`` mode runs, copied (the port imports nothing of the JAX package):

- ``nii2npy_hecktor``: per patient dir, the [ct, pet] stack as int16 and the
  gtvt label as uint8;
- ``nii2npy_brats``: per case dir, the [flair, t1ce, t1, t2] stack as int16
  and the label as uint8 with 4 -> 3.

The JAX module's resampling and resizing helpers (``resample_image``,
``resize_data``, ``split_and_resize_data``) have no caller in its CLI and
are not ported.
"""
from __future__ import annotations

import os

import numpy as np

from hdenseformer_tpu_torch.data.io import read_nifti, save_as_hdf5


def _find(entry: os.DirEntry, name: str) -> str:
    for ext in (".nii.gz", ".nii"):
        p = os.path.join(entry.path, f"{name}{ext}")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{name} not found in {entry.path}")


def _write_case(out: str, images: np.ndarray, labels: np.ndarray, img_key: str,
                lab_key: str) -> None:
    if os.path.exists(out):
        os.remove(out)
    save_as_hdf5(images, out, img_key)
    save_as_hdf5(labels, out, lab_key)


def nii2npy_hecktor(
    input_dir: str,
    save_dir: str,
    img_key: str = "ct",
    lab_key: str = "seg",
) -> list:
    """Per-patient [ct, pet] stack + gtvt label -> <patient>.hdf5.

    Expects <patient>/<patient>_ct, _pt and _gtvt, each .nii.gz or .nii.
    """
    os.makedirs(save_dir, exist_ok=True)
    written = []
    for entry in sorted(os.scandir(input_dir), key=lambda e: e.name):
        if not entry.is_dir():
            continue
        pid = entry.name
        ct, _ = read_nifti(_find(entry, f"{pid}_ct"))
        pt, _ = read_nifti(_find(entry, f"{pid}_pt"))
        seg, _ = read_nifti(_find(entry, f"{pid}_gtvt"))
        out = os.path.join(save_dir, f"{pid}.hdf5")
        _write_case(out, np.stack([ct, pt]).astype(np.int16), seg.astype(np.uint8),
                    img_key, lab_key)
        written.append(out)
    return written


def nii2npy_brats(
    input_dir: str,
    save_dir: str,
    img_key: str = "image",
    lab_key: str = "label",
) -> list:
    """Per-case [flair, t1ce, t1, t2] stack, label 4 -> 3 -> <case>.hdf5."""
    os.makedirs(save_dir, exist_ok=True)
    written = []
    for entry in sorted(os.scandir(input_dir), key=lambda e: e.name):
        if not entry.is_dir():
            continue
        cid = entry.name
        mods = [read_nifti(_find(entry, f"{cid}_{m}"))[0] for m in ("flair", "t1ce", "t1", "t2")]
        seg, _ = read_nifti(_find(entry, f"{cid}_seg"))
        labels = seg.astype(np.uint8)
        labels[labels == 4] = 3
        out = os.path.join(save_dir, f"{cid}.hdf5")
        _write_case(out, np.stack(mods).astype(np.int16), labels, img_key, lab_key)
        written.append(out)
    return written
