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
JAX module's thread drops it).

``load_checkpoint`` also reads the JAX package's checkpoints: flax's
``to_bytes`` of ``{"epoch", "step", "params", "opt_state"[,
"model_state"]}``, decoded with ``msgpack`` alone (no flax). The two
formats are told apart by their first bytes (``checkpoint_format``): a
``torch.save`` file is a zip, flax's a msgpack map. ``load_jax_state``
carries such a tree into a port model and its optimizer.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Mapping, Optional

import msgpack
import numpy as np
import torch

from hdenseformer_tpu_torch.weights import from_jax_params


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


def checkpoint_format(path: str) -> str:
    """"torch" for a ``torch.save`` file (a zip), "flax" for the JAX
    package's (a msgpack map); anything else raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "flax"
    raise ValueError(f"{path}: neither a torch.save zip nor a flax msgpack map "
                     f"(first bytes {head!r})")


def load_checkpoint(path: str) -> Dict:
    """The snapshot at ``path``, on the host: the port's ``torch.save`` dict
    (tensors and plain values only: no pickled code is run), or the JAX
    package's tree decoded by ``read_flax_checkpoint``."""
    if checkpoint_format(path) == "flax":
        with open(path, "rb") as f:
            return read_flax_checkpoint(f.read())
    return torch.load(path, map_location="cpu", weights_only=True)


# --- the JAX package's checkpoints --------------------------------------------------

# flax.serialization's msgpack extension types
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _array(data: bytes) -> torch.Tensor:
    """flax's ndarray encoding, msgpack of (shape, dtype name, C-order
    bytes), as a writable tensor (bfloat16 included, which numpy lacks)."""
    shape, name, buf = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(name.decode())).copy())
    return flat.reshape(tuple(shape))


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array(data)
    if code == _EXT_NPSCALAR:
        return _array(data).item()
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    return msgpack.ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    """Arrays flax wrote in chunks (above its ``MAX_CHUNK_SIZE``) joined."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_checkpoint(data: bytes) -> Dict:
    """Decode ``flax.serialization.to_bytes`` output: nested dicts (flax
    writes lists, tuples and named tuples as dicts keyed "0", "1", ... or by
    field) with tensor leaves, numpy scalars as Python numbers."""
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))


def _optax_moments(opt_state: Mapping, optimizer: torch.optim.Optimizer) -> Dict:
    """The moments of JAX's ``get_optimizer`` chain under optax's
    ``inject_hyperparams`` state ``{count, hyperparams, inner_state}``:
    "adam" (coupled L2 first) keeps ``{count, mu, nu}`` at inner_state "1",
    "adamw" at "0", "sgd" its ``{trace}`` at "1"."""
    inner = opt_state["inner_state"]
    if isinstance(optimizer, torch.optim.AdamW):
        return inner["0"]
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.SGD)):
        return inner["1"]
    raise ValueError(f"no JAX optimizer state maps onto {type(optimizer).__name__}")


def load_jax_state(ckpt: Mapping, model: torch.nn.Module,
                   optimizer: Optional[torch.optim.Optimizer] = None) -> bool:
    """Load a JAX checkpoint tree (``read_flax_checkpoint``) into ``model``
    (strict) and, given ``optimizer`` and where the checkpoint has
    ``opt_state``, its moments into the optimizer. Returns whether the
    optimizer state was loaded.

    The moments go through ``from_jax_params`` as the weights do (kernels
    transposed, ``attns`` split per modality): optax's ``mu``, ``nu`` and
    ``count`` become Adam's ``exp_avg``, ``exp_avg_sq`` and ``step``, and
    SGD's ``trace`` its ``momentum_buffer``, set per parameter, so the
    port's two parameter groups do not matter. The injected learning rate
    is not read. A checkpoint with ``model_state`` (BatchNorm statistics,
    which only the unported DAUNet family has) raises.
    """
    if ckpt.get("model_state"):
        raise NotImplementedError(
            "a JAX checkpoint with model_state (BatchNorm running statistics) is not "
            "ported yet: ROADMAP.md queue 1 item 3")
    model.load_state_dict(from_jax_params(ckpt["params"]), strict=True)
    if optimizer is None or ckpt.get("opt_state") is None:
        return False
    moments = _optax_moments(ckpt["opt_state"], optimizer)
    named = dict(model.named_parameters())
    sgd = isinstance(optimizer, torch.optim.SGD)
    if not isinstance(moments, Mapping) or not ({"trace"} if sgd else {"mu", "nu"}) <= set(
            moments):
        raise ValueError(f"the checkpoint's optimizer state is not {type(optimizer).__name__}'s")
    if sgd:
        slots = {"momentum_buffer": from_jax_params(moments["trace"])}
    else:
        slots = {"exp_avg": from_jax_params(moments["mu"]),
                 "exp_avg_sq": from_jax_params(moments["nu"])}
    for key, values in slots.items():
        if sorted(values) != sorted(named):
            raise KeyError(f"the checkpoint's {key} does not name the model's parameters: "
                           f"{sorted(set(values) ^ set(named))[:5]}")
    names = {id(p): n for n, p in named.items()}
    optimizer.state.clear()
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = {k: v[names[id(p)]].to(device=p.device, dtype=p.dtype)
                     for k, v in slots.items()}
            if "exp_avg" in state:
                state["step"] = torch.tensor(float(moments["count"]), dtype=torch.float32)
            optimizer.state[p] = state
    return True


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
