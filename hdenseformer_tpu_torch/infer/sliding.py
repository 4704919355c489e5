"""Batched sliding-window whole-volume inference on the device.

Counterpart of ``hdenseformer_tpu/infer/sliding.py``:

- the same nnUNet-style window grid (``cal_steps``), gaussian importance map
  (``get_gaussian``, off by default) and lattice padding
  (``_lattice_pad_targets``), copied exactly;
- the volume lives on the device; windows are gathered from it by origins
  that are device data, ``window_batch`` at a time, and the tail of the
  origin list is padded with zero-weight windows so every model call has
  the same batch;
- each window's full-resolution logits are softmaxed in fp32 and
  accumulated with no visit-count accumulator: the count (and the gaussian
  weight) is the same for every class at a voxel, so it cannot change the
  argmax;
- the argmax is taken on the device and shipped to the host as uint8.

JAX compiles the whole call into one executable per lattice cell, the
origins traced data. The port's call is one body (``_call_body``): the
accumulator zeroed, for each window batch the gather by device offsets
(origin plus ``arange(patch)`` a dim), the forward, the weighted fp32
probabilities added window by window at the same offsets, then the argmax
and the uint8 cast; under a mesh the accumulator's ``all_reduce`` sits
before the argmax, as JAX's ``psum`` in its ``shard_map``. No step reads a
value on the host. With ``capture`` (the default) the body runs as a
``utils.graphs.CapturedCall`` kept with the model (``model_graphs``), one
per (padded shape, channels, window count, window batch, gaussian, patch,
classes): on a card one CUDA graph replayed by every volume of the cell,
the volume, its extent, origins and weights copied into its static
buffers; on the CPU the same body on the same static buffers, without a
graph.
``capture=False`` runs the body on fresh tensors. The crop and the copy to
the host stay outside, as JAX crops on the host.

The host stages the (C, *spatial) volume as it lies, channels-first: one
copy from the array straight to the start of the storage of the call's
(C, *padded) buffer on the device (``_stage``). The body starts on the card:
it gathers the staged volume channels-last by the volume's extent (device
data) and zeroes what lies outside it, where a larger volume of the same
cell may have left its values, so that every window reads the lattice pad
as zeros.

With a data-parallel ``mesh`` (``parallel/mesh.py``: one process a card)
the origin list is padded to ``n_batches * world * window_batch`` and each
rank runs its contiguous share; the ranks' fp32 accumulators are summed by
``all_reduce`` and every rank takes the same argmax. On a card the mesh's
call is captured with its ``all_reduce`` under NCCL; under gloo the caller
passes ``capture=False`` (``parallel.mesh.check_capturable``).

``predict_volume``'s spans (``utils.profiling``): ``serve.call``, keyed by
the volume's lattice cell, around ``serve.plan`` (origins, window padding,
the graph's lookup), ``serve.stage`` (the channels-first volume's copy to
the device), ``graph.replay``, ``serve.fetch`` (the labels' copy to the
host: the host waits there for the card) and ``serve.crop``; counters
``serve.volumes``, ``serve.windows`` (real), ``serve.windows_run`` (with the
zero-weight pads), ``serve.staged_bytes`` (what crosses to the device) and
``serve.pad_volumes`` (volumes smaller than their cell, whose pad the card
zeroed).
"""
from __future__ import annotations

import glob
import os
import weakref
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hdenseformer_tpu_torch.data.io import hdf5_reader, write_nifti
from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize
from hdenseformer_tpu_torch.parallel.mesh import check_capturable
from hdenseformer_tpu_torch.utils.graphs import CapturedCall, batch_key, model_graphs
from hdenseformer_tpu_torch.utils.profiling import count, span


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


def _window_index(origins: torch.Tensor, patch_size: Sequence[int]) -> tuple:
    """One index tensor a spatial dim of the voxels of ``origins``' (n, nsp)
    windows, each window's origin (on the device) plus ``arange(patch)``,
    shaped to broadcast to (n, *patch)."""
    n, nsp = origins.shape[0], len(patch_size)
    index = []
    for d, p in enumerate(patch_size):
        shape = [n] + [1] * nsp
        shape[1 + d] = p
        index.append((origins[:, d, None] + torch.arange(p, device=origins.device))
                     .view(shape))
    return tuple(index)


def _channels_last(staged: torch.Tensor, extent: torch.Tensor) -> torch.Tensor:
    """The volume staged in ``staged``'s (C, *padded) storage, as (*padded,
    C): its (C, *extent) values lie contiguous at the start of the storage
    (``extent`` (nsp,) is device data, ``_stage``), and a voxel outside the
    extent reads zero, whatever a larger volume of the same cell left there."""
    channels, spatial = staged.shape[0], staged.shape[1:]
    nsp = len(spatial)
    index, inside, stride = 0, None, 1
    for d in reversed(range(nsp)):
        shape = [1] * (nsp + 1)
        shape[d] = spatial[d]
        at = torch.arange(spatial[d], device=staged.device).view(shape)
        index = index + at * stride
        below = at < extent[d]
        inside = below if inside is None else inside & below
        stride = stride * extent[d]
    channel = torch.arange(channels, device=staged.device).view([1] * nsp + [channels])
    return torch.where(inside, staged.view(-1)[index + channel * stride], 0.0)


def _call_body(model: torch.nn.Module, static: Dict[str, torch.Tensor],
               patch_size: Sequence[int], num_classes: int, wb: int, mesh,
               output: str) -> Dict[str, torch.Tensor]:
    """The whole sliding-window call on ``static``: "volume" (*spatial, C),
    or "staged" (C, *spatial) with "extent" (nsp,) int64 (``_channels_last``),
    "origins" (Nw, nsp) int64, "weights" (Nw,) and optionally "importance"
    (*patch). ``output`` "acc" returns the accumulator, "labels" its argmax
    as uint8 (after the mesh's ``all_reduce`` where ``mesh`` reduces)."""
    volume = (_channels_last(static["staged"], static["extent"]) if "staged" in static
              else static["volume"])
    origins, weights = static["origins"], static["weights"]
    importance = static.get("importance")
    acc = torch.zeros(tuple(volume.shape[:-1]) + (num_classes,), dtype=torch.float32,
                      device=volume.device)
    ones = (1,) * (len(patch_size) + 1)
    for start in range(0, origins.shape[0], wb):
        index = _window_index(origins[start:start + wb], patch_size)
        probs = _window_probs(model, volume[index])
        contrib = probs * weights[start:start + wb].view((-1,) + ones)
        if importance is not None:
            contrib = contrib * importance[..., None]
        for i in range(contrib.shape[0]):  # windows of a batch may overlap: one at a time
            box = tuple(t[i] for t in index)
            acc[box] += contrib[i]
    if output == "acc":
        return {"acc": acc}
    if mesh is not None and mesh.reduces:
        dist.all_reduce(acc)
    return {"labels": acc.argmax(dim=-1).to(torch.uint8)}


def _captured(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              patch_size: Sequence[int], num_classes: int, wb: int, mesh,
              output: str) -> CapturedCall:
    """The model's ``_call_body`` call of ``batch``'s shapes (a lattice
    cell), made at its first use; ``batch``'s tensors give only the shapes
    and dtypes (meta tensors will do)."""
    device = next(model.parameters()).device
    check_capturable(mesh)
    # every rank of a mesh serves the same volume: one key, captured on the same call
    key = ("sliding", output, tuple(patch_size), num_classes, wb, model.training,
           mesh is not None and mesh.reduces) + batch_key(batch)
    ref = weakref.ref(model)  # the body runs at warm-up and capture only

    def make(pool) -> CapturedCall:
        example = {n: torch.zeros(v.shape, dtype=v.dtype, device=device)
                   for n, v in batch.items()}
        return CapturedCall(lambda static: _call_body(ref(), static, patch_size, num_classes,
                                                      wb, mesh, output), example, pool=pool)

    return model_graphs(model).get(key, make)


def _window_batch(origins: np.ndarray, weights: np.ndarray,
                  importance: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    batch = {"origins": torch.from_numpy(np.asarray(origins, np.int64)),
             "weights": torch.from_numpy(np.asarray(weights, np.float32))}
    if importance is not None:
        batch["importance"] = importance
    return batch


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
    batch and adds nothing. ``predict_volume``'s body without the argmax;
    with ``capture`` on a card one replay of its graph.
    """
    if len(origins) % window_batch:
        raise ValueError(f"{len(origins)} origins are not a multiple of {window_batch}")
    batch = dict(volume=image, **_window_batch(origins, weights, importance))
    if capture:
        call = _captured(model, batch, patch_size, num_classes, window_batch, None, "acc")
        return call.replay(batch)["acc"]
    return _call_body(model, {n: v.to(image.device) for n, v in batch.items()}, patch_size,
                      num_classes, window_batch, None, "acc")["acc"]


def _stage(staged: torch.Tensor, image: np.ndarray) -> int:
    """The (C, *spatial) ``image`` as it lies, channels-first, copied to the
    start of the (C, *padded) ``staged`` buffer's storage (from the array
    straight to the device on a card); the bytes copied."""
    flat = torch.from_numpy(np.ascontiguousarray(image)).view(-1)
    staged.view(-1)[:flat.numel()].copy_(flat, non_blocking=True)
    return flat.nbytes


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
    return the labels of the whole volume. ``capture`` replays the model's
    graph of the volume's lattice cell on a card (module docstring); under
    a gloo mesh on a card it raises: pass ``capture=False``.
    """
    device = next(model.parameters()).device
    patch_size = tuple(patch_size)
    image = np.asarray(image, np.float32)
    orig_spatial = image.shape[1:]
    if pad_to_lattice:
        tgt = _lattice_pad_targets(orig_spatial, patch_size, step_size)
    else:
        tgt = [max(p, s) for p, s in zip(patch_size, orig_spatial)]
    crop = tuple(slice(0, s) for s in orig_spatial)

    with span("serve.call", tuple(tgt)):
        with span("serve.plan"):
            origins = _origins_array(cal_steps(orig_spatial, patch_size, step_size))
            n_windows = len(origins)
            weights = np.ones((origins.shape[0],), np.float32)
            importance = torch.from_numpy(get_gaussian(patch_size)) if use_gaussian else None
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

            batch = _window_batch(origins, weights, importance)
            batch["extent"] = torch.tensor(orig_spatial, dtype=torch.int64)
            shape = image.shape[:1] + tuple(tgt)  # the staged volume's buffer
            if capture:
                with torch.inference_mode():
                    example = dict(batch, staged=torch.empty(shape, device="meta"))
                    call = _captured(model, example, patch_size, num_classes, wb, mesh,
                                     "labels")
        with torch.inference_mode():
            if capture:
                with span("serve.stage"):
                    staged = _stage(call.static["staged"], image)
                labels = call.replay(batch)["labels"]
            else:
                with span("serve.stage"):
                    batch = {n: v.to(device) for n, v in batch.items()}
                    batch["staged"] = torch.empty(shape, dtype=torch.float32, device=device)
                    staged = _stage(batch["staged"], image)
                labels = _call_body(model, batch, patch_size, num_classes, wb, mesh,
                                    "labels")["labels"]
        count("serve.volumes")
        count("serve.windows", n_windows)
        count("serve.windows_run", len(origins))
        count("serve.staged_bytes", staged)
        if tuple(orig_spatial) != tuple(tgt):
            count("serve.pad_volumes")
        with span("serve.fetch"):
            labels = labels.cpu()
        with span("serve.crop"):
            return labels.numpy()[crop].astype(np.int32)


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
