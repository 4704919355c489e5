"""Per-slice prediction of volumes with a 2-D net.

Counterpart of ``hdenseformer_tpu/infer/slices.py`` (the reference's eval.py
predict path): a 2-D segmentation net runs slice by slice over a
multi-modality case ``(C, D, H, W)`` and the per-slice argmax masks are
stacked back into a ``(D, H, W)`` label volume.

- Each slice is preprocessed on the host as the 2-D validation pipeline
  does: ``MRNormalize``, then ``CropResize`` to the net's input shape.
- Slices run in chunks of ``slice_batch`` through the model on its device,
  in eval mode and without gradients. The short last chunk is padded with
  zeros to ``slice_batch`` and its first rows kept, as JAX pads it to keep
  one compiled shape; in eval mode a slice's output does not depend on the
  others in its chunk.
- JAX jits the chunk's forward, fp32 cast and argmax into one program.
  With ``capture`` (the default) the port runs them as a
  ``utils.graphs.CapturedCall`` kept with the model (``model_graphs``), one
  per chunk shape: on a card one CUDA graph replayed by every chunk of
  every case, the chunk copied in from pinned memory; on the CPU the same
  body on the same static buffer. ``capture=False`` runs the body eagerly.
- Each chunk's argmax stays on the device until the case is stacked; the
  labels are mapped back to the case's in-plane shape by nearest index
  (``floor(i * in / out)``, JAX's index map) there, and copied to the host
  once a case as uint8.
"""
from __future__ import annotations

import glob
import os
import weakref
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from hdenseformer_tpu_torch.data.io import hdf5_reader
from hdenseformer_tpu_torch.data.transforms import CropResize, MRNormalize
from hdenseformer_tpu_torch.utils.graphs import CapturedCall, batch_key, model_graphs


def preprocess_slices(image: np.ndarray, input_shape: Tuple[int, int], num_classes: int = 2,
                      channels: int = 3) -> np.ndarray:
    """The ``(D, H', W', C)`` stack of a raw ``(C, D, H, W)`` case's slices,
    each normalised and resized to ``input_shape`` as in validation."""
    c, d, h, w = image.shape
    norm = MRNormalize()
    crop = CropResize(dim=input_shape, num_class=num_classes, crop=0, channel=channels)
    slices = []
    for z in range(d):
        sample = {"image": image[:, z].astype(np.float32).copy(),
                  "label": np.zeros((h, w), np.float32)}
        sample = crop(norm(sample))
        slices.append(np.moveaxis(sample["image"], 0, -1))
    return np.stack(slices)


def _nearest_index(out_len: int, in_len: int, device) -> torch.Tensor:
    idx = np.minimum(np.floor(np.arange(out_len) * in_len / out_len).astype(np.int64),
                     in_len - 1)
    return torch.from_numpy(idx).to(device)


def _chunk_body(model: torch.nn.Module, static: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A chunk's forward, the fp32 cast of head 0's logits and the argmax."""
    outs = model(static["chunk"])
    logits = outs[0] if isinstance(outs, (list, tuple)) else outs
    return {"labels": logits.float().argmax(-1)}


def _chunk_call(model: torch.nn.Module, batch: Dict[str, torch.Tensor]) -> CapturedCall:
    """The model's captured chunk of ``batch``'s shape, made at its first use."""
    device = next(model.parameters()).device
    ref = weakref.ref(model)  # the body runs at warm-up and capture only

    def make(pool) -> CapturedCall:
        example = {n: torch.zeros(v.shape, dtype=v.dtype, device=device)
                   for n, v in batch.items()}
        return CapturedCall(lambda static: _chunk_body(ref(), static), example, pool=pool)

    return model_graphs(model).get(("slices", model.training) + batch_key(batch), make)


def predict_case_2d(
    model: torch.nn.Module,
    image: np.ndarray,
    input_shape: Tuple[int, int],
    num_classes: int = 2,
    channels: int = 3,
    slice_batch: int = 24,
    capture: bool = True,
) -> np.ndarray:
    """Per-slice 2-D prediction of a raw ``(C, D, H, W)`` case, stacked to a
    ``(D, H, W)`` uint8 label volume. ``capture`` replays the model's graph
    of a chunk on a card (module docstring)."""
    _, d, h, w = image.shape
    stack = preprocess_slices(image, input_shape, num_classes, channels)
    device = next(model.parameters()).device
    model.eval()
    pad = -d % slice_batch
    if pad:  # the short last chunk padded with zeros, as JAX's
        stack = np.concatenate([stack, np.zeros((pad,) + stack.shape[1:], stack.dtype)])
    chunks = torch.from_numpy(np.ascontiguousarray(stack))
    if device.type == "cuda":
        chunks = chunks.pin_memory()
    preds = []
    with torch.inference_mode():
        for s in range(0, chunks.shape[0], slice_batch):
            batch = {"chunk": chunks[s:s + slice_batch]}
            if capture:
                out = _chunk_call(model, batch).replay(batch)
            else:
                out = _chunk_body(model, {"chunk": batch["chunk"].to(device, non_blocking=True)})
            preds.append(out["labels"])
    pred = torch.cat(preds)[:d]
    if tuple(pred.shape[1:]) != (h, w):
        pred = pred[:, _nearest_index(h, pred.shape[1], pred.device)[:, None],
                    _nearest_index(w, pred.shape[2], pred.device)[None, :]]
    return pred.to(torch.uint8).cpu().numpy()


def eval_dir_2d(
    model: torch.nn.Module,
    test_path: str,
    save_path: str,
    input_shape: Sequence[int],
    num_classes: int = 2,
    channels: int = 3,
    img_key: str = "ct",
    capture: bool = True,
) -> list:
    """Per-case 2-D prediction of every ``*.hdf5`` case of ``test_path``; saves
    ``<case>.npy`` label volumes under ``save_path`` and returns their paths.
    The labels are not read here: ``-m eval`` reads them. ``capture`` is
    ``predict_case_2d``'s."""
    os.makedirs(save_path, exist_ok=True)
    written = []
    for path in sorted(glob.glob(os.path.join(test_path, "*.hdf5"))):
        pred = predict_case_2d(model, hdf5_reader(path, img_key), tuple(input_shape),
                               num_classes, channels, capture=capture)
        out = os.path.join(save_path, os.path.basename(path).split(".")[0] + ".npy")
        np.save(out, pred)
        written.append(out)
    return written
