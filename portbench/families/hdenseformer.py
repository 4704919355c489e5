"""HDenseFormer_32 and HDenseFormer_2D_32: the reference model of
``portbench.reference.model``, the deep-supervision focal loss of
``portbench.reference.train``, the bounds of ``portbench.roofline`` and the
hand-written kernels listed in ``portbench/kernels.json``."""
from __future__ import annotations

import json
from pathlib import Path
from typing import List

from portbench import roofline
from portbench.reference import model, train

KERNELS = Path(__file__).resolve().parent.parent / "kernels.json"

build = model.build
loss = train.ds_loss
train_step_bound_s = roofline.train_step_bound_s
forward_bound_s = roofline.forward_bound_s


def kernel_patterns() -> List[str]:
    with open(KERNELS) as f:
        return json.load(f)["hand_written"]


def system_kwargs(config: dict) -> dict:
    return {"transformer_depth": config["model"]["transformer_depth"]}
