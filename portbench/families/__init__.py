"""Model families, one module each, found by the name that a configuration
gives under ``family`` (``hdenseformer`` where it gives none).

A family module gives the drivers, ``flops`` and the check what belongs to
its architecture:

- ``build(config, device)``: the plain reference model (fp32, TF32 off
  under ``reference.exact``; ``set_precision(name)``; ``forward(x,
  generator=None)`` on channels-last input returns the heads' logits, the
  full-resolution head first), its parameters uninitialised. On the meta
  device it gives the names and shapes of the weights and the FLOPs.
- ``system_kwargs(config)``: what ``get_net`` and ``SemanticSeg`` take for
  this family beside the arguments every family shares.
- ``loss(outs, onehot, weight)``: the reference loss of a train step.
- ``train_step_bound_s(config, batch, clock_hz)`` and
  ``forward_bound_s(config, batch, clock_hz)``: the least time of a train
  step's and of a serving window's work for the hand-written kernels.
- ``kernel_patterns()``: substrings of the names of the kernels that those
  bounds cover.

A later family is a new module here and a configuration that names it.
"""
from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "hdenseformer"


def name_of(config: dict) -> str:
    return config.get("family", DEFAULT)


def of(config: dict) -> ModuleType:
    """The family module of a configuration."""
    return importlib.import_module(f"{__name__}.{name_of(config)}")
