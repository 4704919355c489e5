"""The model FLOPs that the MFU metrics count: the fine-grid reference
model's, at the configuration's shapes, whatever layout or kernels the
system runs.

``torch.utils.flop_counter.FlopCounterMode`` over the configuration's
family's reference model (``portbench.families``) on the meta device (no
memory, no arithmetic): its convolutions and matrix products, 2 FLOPs a
multiply-add. A train step counts one forward
and its backward; rematerialisation's second forward is the system's choice
and is not counted. A serving window counts one forward at batch 1.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import families


def count(config: dict, batch: int, train: bool) -> float:
    net = families.of(config).build(config, "meta")
    m = config["model"]
    x = torch.empty((batch, *m["image_size"], m["in_channels"]), device="meta")
    net.eval()  # dropout multiplies nothing
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            sum(o.sum() for o in net(x)).backward()
        else:
            with torch.no_grad():
                net(x)
    return float(counter.get_total_flops())
