"""Bridge from the JAX package's variables to the port's ``state_dict``.

``from_jax_params`` takes ``variables["params"]`` of a flax model of the JAX
package, as nested dicts of numpy arrays (convert with
``jax.tree_util.tree_map(np.asarray, ...)``) or of tensors (a checkpoint
read by ``train.checkpoint.load_checkpoint``), and returns the state dict
of the matching port module. The rules:

- names: ``kernel`` and ``scale`` become ``weight``; others stay;
- the norms' inner level goes: JAX's ``BatchNorm`` and ``transbts.GroupNorm``
  hold their variables one module deeper (``bn1/BatchNorm_0/scale``,
  ``bn1/GroupNorm_0/bias``) than the port's (``bn1.weight``, ``bn1.bias``);
- Dense kernels ``(in, out)`` become ``Linear`` weights ``(out, in)``;
- Conv kernels ``(k, k, k, in, out)`` become ``(out, in, k, k, k)``;
- ConvTranspose kernels are the spatially flipped equivalent-conv kernel
  ``(k, k, k, in, out)``; they are flipped back and become torch's
  ``(in, out, k, k, k)``. Given the port ``model``, a kernel is a
  ConvTranspose's where the model's module at its path is a
  ``models.layers.ConvTranspose``; without one, where a module of its path
  is named ``upconv*`` (HDenseFormer's and Hecktor20Top1's names). Without
  a model, a kernel at one of the zoo's transposed-conv names (UNETR's
  ``encoder{2,3,4}_up{j}`` and ``decoder{2..5}_up``, TransBTS's
  ``DeUp{2,3,4}_conv2``) raises: the name rule cannot place it, and where
  its in and out channels are equal a plain conv's layout would load
  silently wrong;
- the leaves under ``attns`` carry a leading modality axis (JAX runs the
  modality paths as one ``nn.vmap``); modality ``m`` becomes ``attns.{m}``.

``prefix`` is the dotted path of ``params`` inside the model when
converting a single layer's subtree, e.g. ``"upconv_1"``; the returned keys
are relative to it.

``from_jax_batch_stats`` maps ``variables["batch_stats"]`` (the BatchNorm
running statistics, ``{..., "BatchNorm_0": {"mean", "var"}}``) onto the
buffers ``mean`` and ``var`` of the port's ``models.layers.BatchNorm``.
"""
from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np
import torch

from hdenseformer_tpu_torch.models.layers import ConvTranspose

NORM_LEVELS = ("BatchNorm_0", "GroupNorm_0")  # JAX's inner norm modules, dropped
ZOO_TRANSPOSED = re.compile(r"encoder\d_up\d|decoder\d_up|DeUp\d_conv2")


def _leaves(tree: Mapping, path: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), value


def _port_path(path: tuple) -> tuple:
    return tuple(p for p in path if p not in NORM_LEVELS)


def _is_transposed(module_path: tuple, model: Optional[torch.nn.Module]) -> bool:
    if model is not None:
        return isinstance(model.get_submodule(".".join(module_path)), ConvTranspose)
    if any(p.startswith("upconv") for p in module_path):
        return True
    if any(ZOO_TRANSPOSED.fullmatch(p) for p in module_path):
        raise ValueError(f"{'.'.join(module_path)} is a transposed conv of the zoo, which "
                         "the upconv* name rule cannot place: pass model=")
    return False


def _convert(full_path: tuple, arr: np.ndarray, model: Optional[torch.nn.Module]
             ) -> tuple[str, np.ndarray]:
    name = full_path[-1]
    if name == "scale":
        return "weight", arr
    if name != "kernel":
        return name, arr
    if arr.ndim == 2:
        return "weight", arr.T
    if arr.ndim == 5:
        if _is_transposed(full_path[:-1], model):
            return "weight", np.flip(arr, axis=(0, 1, 2)).transpose(3, 4, 0, 1, 2)
        return "weight", arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {arr.ndim} at {'.'.join(full_path)}")


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):  # a decoded checkpoint's leaf, bf16 included
        leaf = leaf.float().numpy()
    return np.array(leaf, dtype=np.float32)  # a writable copy


def from_jax_params(params: Mapping, prefix: str = "",
                    model: Optional[torch.nn.Module] = None) -> dict[str, torch.Tensor]:
    """The port's state dict for the JAX parameter tree ``params`` (of the
    port module ``model``, where given: module docstring)."""
    root = tuple(prefix.split(".")) if prefix else ()
    out = {}
    for path, leaf in _leaves(params):
        arr = _array(leaf)
        path = _port_path(path)
        if path[0] == "attns":
            banks = [(("attns", str(m)) + path[1:], arr[m]) for m in range(arr.shape[0])]
        else:
            banks = [(path, arr)]
        for p, a in banks:
            name, a = _convert(root + p, a, model)
            out[".".join(p[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def from_jax_batch_stats(batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """The BatchNorm buffers for the JAX ``batch_stats`` tree."""
    return {".".join(_port_path(path)): torch.from_numpy(_array(leaf))
            for path, leaf in _leaves(batch_stats)}


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> torch.nn.Module:
    """Copy the JAX parameter tree ``params`` and, for a BatchNorm model, its
    ``batch_stats`` into ``model`` (strict: a BatchNorm model loaded without
    its statistics raises)."""
    state = from_jax_params(params, model=model)
    if batch_stats:
        state.update(from_jax_batch_stats(batch_stats))
    model.load_state_dict(state, strict=True)
    return model
