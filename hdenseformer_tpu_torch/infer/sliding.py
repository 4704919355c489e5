"""Batched sliding-window whole-volume inference on the device.

Counterpart of ``hdenseformer_tpu/infer/sliding.py``:

- the same nnUNet-style window grid (``cal_steps``), gaussian importance map
  (``get_gaussian``, off by default) and lattice padding
  (``_lattice_pad_targets``), copied exactly;
- the volume lives on the device; windows are sliced from it,
  ``window_batch`` at a time, and the tail of the origin list is padded with
  zero-weight windows so every model call has the same batch;
- each window's full-resolution logits are softmaxed in fp32 and
  accumulated with no visit-count accumulator: the count (and the gaussian
  weight) is the same for every class at a voxel, so it cannot change the
  argmax;
- the argmax is taken on the device and shipped to the host as uint8.

JAX scans the windows inside one executable. On a card the port captures
the model's forward and the fp32 softmax of one window batch as a CUDA
graph per (model, window-batch shape) on a static input buffer
(``utils.graphs``), kept with the model, and every batch of every volume
replays it; the slicing of the windows and the accumulation stay Python
around it (eight slices and eight adds a batch of 8). ``capture=False``, the
CPU and a ``mesh`` run the eager forward. With a data-parallel ``mesh``
(``parallel/mesh.py``: one process a card) the origin list is padded to
``n_batches * world * window_batch`` and each rank runs its contiguous
share; the ranks' fp32 accumulators are summed by ``all_reduce`` and every
rank takes the same argmax, as JAX's ``psum`` over its shard-mapped windows.
"""
from __future__ import annotations

import glob
import itertools
import os
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hdenseformer_tpu_torch.data.io import hdf5_reader, write_nifti
from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize
from hdenseformer_tpu_torch.utils.graphs import CapturedCall, GraphCache, batch_key

# each model's captured window forwards; a graph holds no reference to its
# model, so both go when the model does
_WINDOW_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, GraphCache]" = (
    weakref.WeakKeyDictionary())


def cal_steps(
    image_size: Sequence[int],
    patch_size: Sequence[int],
    step_size: Sequence[int],
) -> list:
    """Evenly-spaced window origins per dim (ref trainer.py:595-618)."""
    steps = []
    for dim in range(len(image_size)):
        if image_size[dim] <= patch_size[dim]:
            steps_here = [0]
        else:
            max_step_value = image_size[dim] - patch_size[dim]
            num_steps = int(np.ceil(max_step_value / step_size[dim])) + 1
            actual_step_size = max_step_value / (num_steps - 1)
            steps_here = [int(np.round(actual_step_size * i)) for i in range(num_steps)]
        steps.append(steps_here)
    return steps


def get_gaussian(patch_size: Sequence[int], sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Gaussian importance map (ref trainer.py:620-638)."""
    from scipy.ndimage import gaussian_filter

    tmp = np.zeros(tuple(patch_size))
    center = [i // 2 for i in patch_size]
    sigmas = [i * sigma_scale for i in patch_size]
    tmp[tuple(center)] = 1
    g = gaussian_filter(tmp, sigmas, 0, mode="constant", cval=0)
    g = (g / np.max(g)).astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g


def _origins_array(steps: list) -> np.ndarray:
    grids = np.meshgrid(*steps, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def _lattice_pad_targets(
    orig_spatial: Sequence[int],
    patch_size: Sequence[int],
    step_size: Sequence[int],
) -> list:
    """Per-dim padded size ``patch + step * k`` with
    ``k = ceil((S - patch)/step)`` — the smallest size on the
    (patch, step) lattice that holds the volume. ``cal_steps`` produces
    exactly ``k + 1`` origins per dim for EVERY size in the half-open
    cell ``(patch + step*(k-1), patch + step*k]``, so all such volumes
    share one padded shape AND one window count -> one executable."""
    tgt = []
    for s, p, st in zip(orig_spatial, patch_size, step_size):
        k = 0 if s <= p else -(-(s - p) // st)
        tgt.append(p + st * k)
    return tgt


def _window_probs(model: torch.nn.Module, windows: torch.Tensor) -> torch.Tensor:
    """The fp32 softmax of head 0's logits of a window batch."""
    outs = model(windows)
    logits = outs[0] if isinstance(outs, (list, tuple)) else outs
    return torch.softmax(logits.float(), dim=-1)


def _captured_probs(model: torch.nn.Module, windows: torch.Tensor) -> torch.Tensor:
    """``_window_probs`` replayed from the model's graph of this window-batch
    shape (captured at its first call). A graph reads the parameters and
    buffers at the addresses they had at its capture: where they were
    rebound since (``.to(dtype)``, ``load_state_dict(assign=True)``), the
    model's graphs are dropped and captured anew."""
    tensors = tuple((t.data_ptr(), t.dtype)
                    for t in itertools.chain(model.parameters(), model.buffers()))
    graphs = _WINDOW_GRAPHS.get(model)
    if graphs is None or any(key[2] != tensors for key in graphs.calls):
        graphs = _WINDOW_GRAPHS[model] = GraphCache()
    batch = {"windows": windows}
    ref = weakref.ref(model)  # the body runs at warm-up and capture only
    key = ("windows", model.training, tensors) + batch_key(batch)
    call = graphs.get(key, lambda pool: CapturedCall(
        lambda static: {"probs": _window_probs(ref(), static["windows"])}, batch, pool=pool))
    return call.replay(batch)["probs"]


@torch.inference_mode()
def accumulate_windows(
    model: torch.nn.Module,
    image: torch.Tensor,
    origins: np.ndarray,
    weights: np.ndarray,
    patch_size: Sequence[int],
    num_classes: int,
    importance: Optional[torch.Tensor] = None,
    window_batch: int = 1,
    capture: bool = True,
) -> torch.Tensor:
    """Weighted per-window probability accumulator, (D, H, W, num_classes) fp32.

    ``image`` is the (D, H, W, C) volume on the device; ``origins`` (Nw, 3)
    and ``weights`` (Nw,) are host arrays with Nw a multiple of
    ``window_batch``. A zero-weight window runs through the model with its
    batch and adds nothing. On a card with ``capture`` each window batch is
    one replay of the model's captured forward.
    """
    if len(origins) % window_batch:
        raise ValueError(f"{len(origins)} origins are not a multiple of {window_batch}")
    acc = torch.zeros(tuple(image.shape[:-1]) + (num_classes,), dtype=torch.float32,
                      device=image.device)
    imp = None if importance is None else importance[..., None]
    forward = _captured_probs if capture and image.device.type == "cuda" else _window_probs
    for start in range(0, len(origins), window_batch):
        boxes = [
            tuple(slice(int(o), int(o) + p) for o, p in zip(origin, patch_size))
            for origin in origins[start:start + window_batch]
        ]
        probs = forward(model, torch.stack([image[box] for box in boxes]))
        for i, (box, w) in enumerate(zip(boxes, weights[start:start + window_batch])):
            if w == 0:
                continue
            contrib = probs[i] * float(w)
            if imp is not None:
                contrib = contrib * imp
            acc[box].add_(contrib)
    return acc


def predict_volume(
    model: torch.nn.Module,
    image: np.ndarray,
    patch_size: Sequence[int],
    step_size: Sequence[int],
    num_classes: int,
    use_gaussian: bool = False,
    window_batch: int = 1,
    pad_to_lattice: bool = True,
    mesh=None,
    capture: bool = True,
) -> np.ndarray:
    """Sliding-window class probabilities -> argmax labels (D, H, W), int32.

    ``image`` is the preprocessed (C, D, H, W) host volume. The device of the
    model's parameters holds the volume, the accumulator and the argmax; the
    labels cross to the host as uint8 and are returned as int32, as the JAX
    function returns them. With ``pad_to_lattice`` the
    volume is zero-padded up to the (patch, step) lattice; the window grid is
    computed on the original size, so windows never read the pad and the
    labels are those of the unpadded run. With ``mesh`` (every rank calls
    with the same volume) each rank runs its share of the windows and all
    return the labels of the whole volume. ``capture`` (on a card, without
    ``mesh``) replays the model's captured window forward
    (``accumulate_windows``).
    """
    device = next(model.parameters()).device
    patch_size = tuple(patch_size)
    image_cl = np.moveaxis(np.asarray(image, np.float32), 0, -1)  # (D, H, W, C)
    orig_spatial = image_cl.shape[:-1]
    if pad_to_lattice:
        tgt = _lattice_pad_targets(orig_spatial, patch_size, step_size)
    else:
        tgt = [max(p, s) for p, s in zip(patch_size, orig_spatial)]
    volume = torch.zeros(tuple(tgt) + image_cl.shape[-1:], dtype=torch.float32, device=device)
    crop = tuple(slice(0, s) for s in orig_spatial)
    volume[crop] = torch.from_numpy(np.ascontiguousarray(image_cl)).to(device)

    origins = _origins_array(cal_steps(orig_spatial, patch_size, step_size))
    weights = np.ones((origins.shape[0],), np.float32)
    importance = (
        torch.from_numpy(get_gaussian(patch_size)).to(device) if use_gaussian else None
    )
    n_dev = 1 if mesh is None else mesh.world_size
    # clamp wb to a rank's window count: a larger batch only adds zero-weight windows
    wb = max(1, min(window_batch, -(-len(origins) // n_dev)))
    n_batches = -(-len(origins) // (n_dev * wb))
    n_pad = n_batches * n_dev * wb - len(origins)
    if n_pad:
        origins = np.concatenate([origins, np.zeros((n_pad, len(patch_size)), np.int32)])
        weights = np.concatenate([weights, np.zeros((n_pad,), np.float32)])
    if n_dev > 1:  # this rank's contiguous share, as JAX's P(axis) sharding
        share = slice(mesh.rank * n_batches * wb, (mesh.rank + 1) * n_batches * wb)
        origins, weights = origins[share], weights[share]

    acc = accumulate_windows(model, volume, origins, weights, patch_size, num_classes,
                             importance, wb, capture=capture and mesh is None)
    if n_dev > 1:
        with torch.inference_mode():  # acc is an inference tensor
            dist.all_reduce(acc)
    labels = acc.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    return labels[crop].astype(np.int32)


def inference_slidingwindow(
    model: torch.nn.Module,
    test_path,
    save_path: str,
    num_classes: int,
    patch_size: Sequence[int],
    step_size: Sequence[int],
    img_key: str = "ct",
    lab_key: str = "label",
    use_gaussian: bool = False,
    mesh=None,
    window_batch: int = 8,
    save_nii: bool = False,
    reader: Callable[[str, str], np.ndarray] = hdf5_reader,
    capture: bool = True,
) -> list:
    """Sliding-window inference over every ``*.hdf5`` case of the directory
    ``test_path`` (or over a list of case paths).

    As the JAX function: each case's ``img_key`` volume is normalized by
    ``PETandCTNormalize`` (with its ``lab_key`` volume, or zeros where the
    case has none, as the label beside it) and its labels saved as
    ``<case>.npy`` under ``save_path``; ``save_nii`` also writes
    ``<case>.nii.gz`` (int16). Returns the paths written. ``reader(path,
    key)`` reads a volume of a case (``SegDataset``'s convention). With a
    data-parallel ``mesh`` every rank runs its share of each case's windows
    (``predict_volume``) and only rank 0 writes; the paths are returned on
    every rank. ``capture`` is ``predict_volume``'s.
    """
    lead = mesh is None or mesh.rank == 0
    if lead:
        os.makedirs(save_path, exist_ok=True)
    norm = PETandCTNormalize()
    outputs = []
    if isinstance(test_path, str):
        cases = sorted(glob.glob(os.path.join(test_path, "*.hdf5")))
    else:
        cases = sorted(test_path)
    for path in cases:
        image = reader(path, img_key)
        try:
            label = reader(path, lab_key)
        except KeyError:
            label = np.zeros(image.shape[1:], np.float32)
        image = norm({"image": image, "label": label})["image"]
        pred = predict_volume(model, image, patch_size, step_size, num_classes,
                              use_gaussian=use_gaussian, window_batch=window_batch, mesh=mesh,
                              capture=capture)
        case = os.path.basename(path).split(".")[0]
        out = os.path.join(save_path, case + ".npy")
        outputs.append(out)
        if lead:
            np.save(out, pred)
        if save_nii:
            nii_path = os.path.join(save_path, case + ".nii.gz")
            outputs.append(nii_path)
            if lead:
                write_nifti(nii_path, pred.astype(np.int16))
    if mesh is not None:
        mesh.barrier()  # every file is written before any rank returns
    return outputs
