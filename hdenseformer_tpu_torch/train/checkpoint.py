"""Checkpoints: metric-encoded filenames, best-k retention, lossless resume.

Counterpart of ``hdenseformer_tpu/train/checkpoint.py``, whose naming,
selection and retention it keeps letter for letter (``metric_filename``,
``get_weight_path``, ``get_weight_list``, ``remove_weight_path``,
``dfs_remove_weight``):

- a checkpoint is saved when val_dice improves on the best so far;
- its filename encodes the epoch and the six epoch metrics;
- ``get_weight_path`` picks the max-epoch file by parsing the prefix;
- ``dfs_remove_weight`` keeps the newest ``retain`` files per leaf dir.

The format is the port's own: ``torch.save`` of ``{"epoch", "step",
"model", "optimizer"}`` (the model's and the optimizer's state dicts),
written to ``path + ".tmp"`` and renamed into place. With ``async_save``
every tensor is copied to host memory before the writing
thread starts (``optimizer.step()`` updates the live tensors in place, so a
thread that serialised them would write a mix of two steps), and
``wait_for_async_saves`` raises the first error of a background write (the
JAX module's thread drops it). Reading the JAX package's flax-msgpack
checkpoints is not ported (ROADMAP.md queue 1 item 2).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import torch


def _to_host(obj: Any) -> Any:
    """A snapshot of ``obj``: every tensor copied to host memory, every
    container rebuilt."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class _AsyncWrite(threading.Thread):
    def __init__(self, write):
        super().__init__(daemon=True)
        self._write = write
        self.error: Optional[Exception] = None

    def run(self) -> None:
        try:
            self._write()
        except Exception as e:  # raised by wait_for_async_saves
            self.error = e


_ASYNC_SAVES: list = []
_ASYNC_LOCK = threading.Lock()


def save_checkpoint(
    path: str,
    model_state: Dict[str, torch.Tensor],
    optimizer_state: Optional[Dict] = None,
    epoch: int = 0,
    step: int = 0,
    async_save: bool = False,
) -> None:
    """Write a training snapshot: the model's state dict, the optimizer's
    (for a lossless resume), the epoch and the optimizer step.

    ``async_save=True`` copies every tensor to the host here (waiting for the
    card) and writes the file on a background thread; call
    ``wait_for_async_saves()`` before reading it back.
    """
    payload = {"epoch": int(epoch), "step": int(step), "model": _to_host(model_state)}
    if optimizer_state is not None:
        payload["optimizer"] = _to_host(optimizer_state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write():
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    if async_save:
        t = _AsyncWrite(write)
        with _ASYNC_LOCK:
            _ASYNC_SAVES.append(t)
        t.start()
    else:
        write()


def wait_for_async_saves() -> None:
    """Join every outstanding background write; raise the first one's error."""
    errors = []
    while True:
        with _ASYNC_LOCK:
            if not _ASYNC_SAVES:
                break
            t = _ASYNC_SAVES.pop(0)
        t.join()
        if t.error is not None:
            errors.append(t.error)
    if errors:
        raise errors[0]


def load_checkpoint(path: str) -> Dict:
    """The snapshot ``save_checkpoint`` wrote, on the host (tensors and plain
    values only: no pickled code is run)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def metric_filename(
    epoch: int,
    train_loss: float,
    train_dice: float,
    train_run_dice: float,
    val_loss: float,
    val_dice: float,
    val_run_dice: float,
) -> str:
    """The reference's filename format, .ckpt extension."""
    return (
        f"epoch={epoch}-train_loss={train_loss:.5f}-train_dice:={train_dice:.5f}"
        f"-train_run_dice={train_run_dice:.5f}-val_loss={val_loss:.5f}"
        f"-val_dice={val_dice:.5f}-val_run_dice={val_run_dice:.5f}.ckpt"
    )


def _epoch_of(filename: str) -> int:
    return int(filename.split("-")[0].split("=")[-1])


def get_weight_path(ckpt_path: str) -> Optional[str]:
    """Max-epoch checkpoint in a directory."""
    if not os.path.isdir(ckpt_path):
        return None
    files = os.listdir(ckpt_path)
    if not files:
        return None
    files.sort(key=_epoch_of)
    return os.path.join(ckpt_path, files[-1])


def get_weight_list(ckpt_path: str):
    """Newest checkpoint per fold subdir."""
    out = []
    for fold in os.scandir(ckpt_path):
        if fold.is_dir():
            files = sorted(os.listdir(fold.path), key=_epoch_of)
            if files:
                out.append(os.path.join(fold.path, files[-1]))
    out.sort(key=lambda x: x.split(os.sep)[-2])
    return out


def remove_weight_path(ckpt_path: str, retain: int = 3) -> None:
    if not os.path.isdir(ckpt_path):
        return
    files = os.listdir(ckpt_path)
    if len(files) >= retain:
        files.sort(key=_epoch_of)
        for f in files[:-retain]:
            os.remove(os.path.join(ckpt_path, f))


def dfs_remove_weight(ckpt_path: str, retain: int = 3) -> None:
    """Recursively retain the newest ``retain`` checkpoints per leaf dir."""
    for sub in os.scandir(ckpt_path):
        if sub.is_dir():
            dfs_remove_weight(sub.path, retain)
        else:
            remove_weight_path(ckpt_path, retain)
            break
