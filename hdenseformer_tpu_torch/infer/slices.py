"""Per-slice prediction of volumes with a 2-D net.

Counterpart of ``hdenseformer_tpu/infer/slices.py`` (the reference's eval.py
predict path): a 2-D segmentation net runs slice by slice over a
multi-modality case ``(C, D, H, W)`` and the per-slice argmax masks are
stacked back into a ``(D, H, W)`` label volume.

- Each slice is preprocessed on the host as the 2-D validation pipeline
  does: ``MRNormalize``, then ``CropResize`` to the net's input shape.
- Slices run in chunks of ``slice_batch`` through the model on its device,
  in eval mode and without gradients. The last chunk runs short: in eval
  mode a slice's output does not depend on the others in its chunk (JAX
  pads it to keep one compiled shape).
- Each chunk's argmax stays on the device until the case is stacked; the
  labels are mapped back to the case's in-plane shape by nearest index
  (``floor(i * in / out)``, JAX's index map) there, and copied to the host
  once a case as uint8.
"""
from __future__ import annotations

import glob
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from hdenseformer_tpu_torch.data.io import hdf5_reader
from hdenseformer_tpu_torch.data.transforms import CropResize, MRNormalize


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


def predict_case_2d(
    model: torch.nn.Module,
    image: np.ndarray,
    input_shape: Tuple[int, int],
    num_classes: int = 2,
    channels: int = 3,
    slice_batch: int = 24,
) -> np.ndarray:
    """Per-slice 2-D prediction of a raw ``(C, D, H, W)`` case, stacked to a
    ``(D, H, W)`` uint8 label volume."""
    _, _, h, w = image.shape
    stack = preprocess_slices(image, input_shape, num_classes, channels)
    device = next(model.parameters()).device
    model.eval()
    preds = []
    with torch.inference_mode():
        for s in range(0, stack.shape[0], slice_batch):
            chunk = torch.from_numpy(np.ascontiguousarray(stack[s:s + slice_batch]))
            if device.type == "cuda":
                chunk = chunk.pin_memory()
            outs = model(chunk.to(device, non_blocking=True))
            logits = outs[0] if isinstance(outs, (list, tuple)) else outs
            preds.append(logits.float().argmax(-1))
    pred = torch.cat(preds)
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
) -> list:
    """Per-case 2-D prediction of every ``*.hdf5`` case of ``test_path``; saves
    ``<case>.npy`` label volumes under ``save_path`` and returns their paths.
    The labels are not read here: ``-m eval`` reads them."""
    os.makedirs(save_path, exist_ok=True)
    written = []
    for path in sorted(glob.glob(os.path.join(test_path, "*.hdf5"))):
        pred = predict_case_2d(model, hdf5_reader(path, img_key), tuple(input_shape),
                               num_classes, channels)
        out = os.path.join(save_path, os.path.basename(path).split(".")[0] + ".npy")
        np.save(out, pred)
        written.append(out)
    return written
