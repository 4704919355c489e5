"""Offline data conversion: NIfTI -> per-case HDF5, resampling, resizing.

A copy of ``hdenseformer_tpu/data/convert.py`` (the port imports nothing
of the JAX package; numpy and scipy, no SimpleITK):

- ``nii2npy_hecktor``: per patient dir, the [ct, pet] stack as int16 and the
  gtvt label as uint8 (the CLI's ``convert`` mode);
- ``nii2npy_brats``: per case dir, the [flair, t1ce, t1, t2] stack as int16
  and the label as uint8 with 4 -> 3;
- ``get_paths_to_patient_files``, ``get_train_val_paths``: per-patient
  (ct, pet[, mask]) NIfTI paths and their split by a JSON id file;
- ``resample_image``: resampling to a new spacing or size with the
  reference's choice of interpolators (linear, nearest, cubic B-spline,
  gaussian, label-gaussian, and radius-3 windowed sincs);
- ``resize_data``, ``split_and_resize_data``: every case resized to one
  grid (anti-aliased image, per-class label), the latter after a seeded
  train/test split.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from hdenseformer_tpu_torch.data.io import hdf5_reader, read_nifti, save_as_hdf5
from hdenseformer_tpu_torch.data.transforms import resize_half_pixel, resize_label_per_class


def get_paths_to_patient_files(path_to_imgs: str, append_mask: bool = True) -> list:
    """Per-patient (ct, pet[, mask]) NIfTI path tuples: one sub-directory per
    patient ``<id>`` holding ``<id>_ct.nii.gz``, ``<id>_pt.nii.gz`` and
    (with ``append_mask``) ``<id>_ct_gtvt.nii.gz``."""
    patients = sorted(p for p in os.listdir(path_to_imgs)
                      if os.path.isdir(os.path.join(path_to_imgs, p)))
    paths = []
    for p in patients:
        d = os.path.join(path_to_imgs, p)
        entry = (os.path.join(d, p + "_ct.nii.gz"), os.path.join(d, p + "_pt.nii.gz"))
        if append_mask:
            entry = entry + (os.path.join(d, p + "_ct_gtvt.nii.gz"),)
        paths.append(entry)
    return paths


def get_train_val_paths(all_paths: list, path_to_train_val_split: str) -> Tuple[list, list]:
    """Split patient path tuples by a JSON file {"train": [ids], "val": [ids]}:
    an entry belongs to a set when ``<id>_ct.nii.gz`` of one of its ids is
    in the entry's CT path."""
    with open(path_to_train_val_split) as f:
        split = json.load(f)

    def member(entry, ids):
        return any(pid + "_ct.nii.gz" in str(entry[0]) for pid in ids)

    return ([e for e in all_paths if member(e, split["train"])],
            [e for e in all_paths if member(e, split["val"])])


def _map_coordinates_resize(array: np.ndarray, new_size, order: int) -> np.ndarray:
    """Half-pixel spline resize through scipy's map_coordinates."""
    from scipy.ndimage import map_coordinates

    coords = np.meshgrid(*[(np.arange(ns) + 0.5) * sh / ns - 0.5
                           for ns, sh in zip(new_size, array.shape)], indexing="ij")
    return map_coordinates(array.astype(np.float32), coords, order=order, mode="nearest")


_SINC_WINDOWS = {
    # window(x / m) for |x| <= m, radius m = 3 (ITK's windowed-sinc family)
    "hamming_sinc": lambda u: 0.54 + 0.46 * np.cos(np.pi * u),
    "cosine_sinc": lambda u: np.cos(np.pi * u / 2.0),
    "welch_sinc": lambda u: 1.0 - u * u,
    "lanczos_sinc": lambda u: np.sinc(u),
    "blackman_sinc": lambda u: 0.42 + 0.5 * np.cos(np.pi * u) + 0.08 * np.cos(2.0 * np.pi * u),
}


def _kernel_resize(array: np.ndarray, new_size, kernel, radius: float) -> np.ndarray:
    """Separable kernel resample on the corner-aligned grid (input position
    ``i_out * old / new``), the weights normalised per output sample."""
    out = array.astype(np.float32)
    for ax, (ns, sh) in enumerate(zip(new_size, array.shape)):
        pos = np.arange(ns) * (sh / ns)
        lo = np.ceil(pos - radius).astype(int)
        j = lo[:, None] + np.arange(int(2 * radius) + 1)[None, :]  # (ns, taps) input indices
        x = pos[:, None] - j
        w = kernel(x) * (np.abs(x) <= radius)
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
        gathered = np.moveaxis(out, ax, 0)[np.clip(j, 0, sh - 1)]  # (ns, taps, ...)
        out = np.moveaxis(np.einsum("nt,nt...->n...", w.astype(np.float32), gathered), 0, ax)
    return out


def resample_image(
    array: np.ndarray,
    spacing: Sequence[float],
    new_spacing: Optional[Sequence[float]] = None,
    new_size: Optional[Sequence[int]] = None,
    is_label: bool = False,
    interpolator: str = "linear",
    gaussian_sigma: float = 0.8,
) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Resample a (z, y, x) array to a new spacing or an explicit size;
    returns it and its spacing.

    Exactly one of ``new_spacing`` and ``new_size``. ``interpolator``:
    "linear" (default), "nearest", "bspline" (cubic spline), "gaussian"
    (separable, sigma in voxels), "label_gaussian" (per-class gaussian,
    then argmax), or a radius-3 windowed sinc ("hamming_sinc",
    "cosine_sinc", "welch_sinc", "lanczos_sinc", "blackman_sinc").
    ``is_label`` resamples nearest.
    """
    if (new_spacing is None) == (new_size is None):
        raise ValueError("specify exactly one of new_spacing / new_size")
    spacing = np.asarray(spacing, np.float64)
    if new_size is None:
        new_size = np.round(array.shape * spacing / np.asarray(new_spacing, np.float64))
    new_size = tuple(int(s) for s in new_size)
    out_spacing = tuple(float(sp * sh / ns) for sp, sh, ns in zip(spacing, array.shape, new_size))

    def gaussian(x):
        return np.exp(-0.5 * (x / gaussian_sigma) ** 2)

    radius = max(3.0 * gaussian_sigma, 1.0)
    if is_label or interpolator == "nearest":
        idx = [np.minimum(np.floor(np.arange(ns) * sh / ns).astype(int), sh - 1)
               for ns, sh in zip(new_size, array.shape)]
        out = array[np.ix_(*idx)]
    elif interpolator == "linear":
        out = resize_half_pixel(array.astype(np.float32), new_size, order=1)
    elif interpolator == "bspline":
        out = _map_coordinates_resize(array, new_size, order=3)
    elif interpolator == "gaussian":
        out = _kernel_resize(array, new_size, kernel=gaussian, radius=radius)
    elif interpolator == "label_gaussian":
        labels = np.unique(array)
        smoothed = np.stack([
            _kernel_resize((array == lab).astype(np.float32), new_size, kernel=gaussian,
                           radius=radius)
            for lab in labels])
        out = labels[np.argmax(smoothed, axis=0)].astype(array.dtype)
    elif interpolator in _SINC_WINDOWS:
        window = _SINC_WINDOWS[interpolator]
        out = _kernel_resize(array, new_size, radius=3.0,
                             kernel=lambda x: np.sinc(x) * window(np.clip(x / 3.0, -1.0, 1.0)))
    else:
        raise ValueError(f"unknown interpolator {interpolator!r}; options: linear/nearest/"
                         f"bspline/gaussian/label_gaussian/" + "/".join(_SINC_WINDOWS))
    return out, out_spacing


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


def _resize_case(src: str, out: str, target_size, num_class: int, img_key: str,
                 lab_key: str) -> None:
    """One case resized to ``target_size``: each image channel with
    anti-aliasing (float32), the label per class (uint8)."""
    image, label = hdf5_reader(src, img_key), hdf5_reader(src, lab_key)
    if image.ndim == 4:
        image = np.stack([resize_half_pixel(ch, target_size, anti_aliasing=True)
                          for ch in image])
    else:
        image = resize_half_pixel(image, target_size, anti_aliasing=True)
    label = resize_label_per_class(label, target_size, num_class)
    _write_case(out, image.astype(np.float32), label.astype(np.uint8), img_key, lab_key)


def resize_data(
    input_dir: str,
    save_dir: str,
    target_size: Sequence[int] = (144, 144, 144),
    num_class: int = 2,
    img_key: str = "ct",
    lab_key: str = "seg",
) -> list:
    """Every ``.hdf5`` case of ``input_dir`` resized to ``target_size`` into
    ``save_dir``; returns the paths written."""
    os.makedirs(save_dir, exist_ok=True)
    written = []
    for name in sorted(n for n in os.listdir(input_dir) if n.endswith(".hdf5")):
        out = os.path.join(save_dir, name)
        _resize_case(os.path.join(input_dir, name), out, target_size, num_class, img_key,
                     lab_key)
        written.append(out)
    return written


def split_and_resize_data(
    input_dir: str,
    save_dir: str,
    target_size: Sequence[int] = (144, 144, 144),
    retain: int = 44,
    num_class: int = 2,
    img_key: str = "ct",
    lab_key: str = "seg",
    seed: int = 0,
) -> Tuple[list, list]:
    """Shuffle the cases with ``seed``, keep ``retain`` of them as the test
    set, and resize every case into ``save_dir/train`` or ``save_dir/test``;
    returns (train paths, test paths)."""
    cases = sorted(n for n in os.listdir(input_dir) if n.endswith(".hdf5"))
    np.random.default_rng(seed).shuffle(cases)
    out = ([], [])
    for subset, names, sink in (("train", cases[retain:], out[0]),
                                ("test", cases[:retain], out[1])):
        os.makedirs(os.path.join(save_dir, subset), exist_ok=True)
        for name in names:
            path = os.path.join(save_dir, subset, name)
            _resize_case(os.path.join(input_dir, name), path, target_size, num_class,
                         img_key, lab_key)
            sink.append(path)
    return out
