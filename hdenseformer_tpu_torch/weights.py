"""Bridge from the JAX package's parameters to the port's ``state_dict``.

``from_jax_params`` takes ``variables["params"]`` of a flax model of the JAX
package, as nested dicts of numpy arrays (convert with
``jax.tree_util.tree_map(np.asarray, ...)``) or of tensors (a checkpoint
read by ``train.checkpoint.load_checkpoint``), and returns the state dict
of the matching port module. The rules:

- names: ``kernel`` and ``scale`` become ``weight``; others stay;
- Dense kernels ``(in, out)`` become ``Linear`` weights ``(out, in)``;
- Conv kernels ``(k, k, k, in, out)`` become ``(out, in, k, k, k)``;
- ConvTranspose kernels (modules named ``upconv_*``) are the spatially
  flipped equivalent-conv kernel ``(k, k, k, in, out)``; they are flipped
  back and become torch's ``(in, out, k, k, k)``;
- the leaves under ``attns`` carry a leading modality axis (JAX runs the
  modality paths as one ``nn.vmap``); modality ``m`` becomes ``attns.{m}``.

``prefix`` is the dotted path of ``params`` inside the model when
converting a single layer's subtree, e.g. ``"upconv_1"``; the returned keys
are relative to it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _leaves(tree: Mapping, path: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), value


def _convert(full_path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    name = full_path[-1]
    if name == "scale":
        return "weight", arr
    if name != "kernel":
        return name, arr
    if arr.ndim == 2:
        return "weight", arr.T
    if arr.ndim == 5:
        if any(p.startswith("upconv") for p in full_path):
            return "weight", np.flip(arr, axis=(0, 1, 2)).transpose(3, 4, 0, 1, 2)
        return "weight", arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {arr.ndim} at {'.'.join(full_path)}")


def from_jax_params(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """The port's state dict for the JAX parameter tree ``params``."""
    root = tuple(prefix.split(".")) if prefix else ()
    out = {}
    for path, leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):  # a decoded checkpoint's leaf, bf16 included
            leaf = leaf.float().numpy()
        arr = np.asarray(leaf, dtype=np.float32)
        if path[0] == "attns":
            banks = [(("attns", str(m)) + path[1:], arr[m]) for m in range(arr.shape[0])]
        else:
            banks = [(path, arr)]
        for p, a in banks:
            name, a = _convert(root + p, a)
            out[".".join(p[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_jax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy the JAX parameter tree ``params`` into ``model`` (strict)."""
    model.load_state_dict(from_jax_params(params), strict=True)
    return model
