"""The MFU's FLOPs: the fine-grid reference model's, whatever layout the
system runs (its default packs the 32-channel level, which counts the pad
slots' work too)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hdenseformer_tpu_torch.models import get_net
from portbench import flops, spec


def _system_forward(config: dict, batch: int, s2d) -> float:
    m = config["model"]
    net = get_net(m["name"], m["in_channels"], m["num_classes"], tuple(m["image_size"]),
                  transformer_depth=m["transformer_depth"], use_kernels=False, remat=False,
                  s2d=s2d, device="meta")
    x = torch.empty((batch, *m["image_size"], m["in_channels"]), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(x)
    return float(counter.get_total_flops())


@pytest.mark.parametrize("name,batch,gflop", [("hdf3d-hecktor21", 1, 1413.025855488),
                                              ("hdf2d-picai22", 24, 1296.95219712)])
def test_fine_grid_forward(name, batch, gflop):
    config = spec.load("configs", name)
    count = flops.count(config, batch, train=False)
    assert count / 1e9 == pytest.approx(gflop, rel=1e-9)
    assert count == _system_forward(config, batch, s2d=False)
    packed = dict(config, s2d=None)
    assert flops.count(packed, batch, train=False) == count
    assert _system_forward(packed, batch, s2d=None) > 1.1 * count


def test_train_step_counts_forward_and_backward():
    config = spec.load("configs", "hdf3d-hecktor21")
    step = flops.count(config, 2, train=True)
    forward = flops.count(config, 2, train=False)
    assert 2.5 * forward < step < 3.0 * forward
