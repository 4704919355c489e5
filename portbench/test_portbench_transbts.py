"""TransBTS's family on the CPU at the tests' size (``conftest.small_config``:
32^3, fp32): the family is found by its configuration's name; its FLOPs are
the port model's on the fine grid; ``drivers.train`` reads ``correct`` on
its cell; a step on half of each batch and the reference in fp8 (the
control) break the cell's limits; and the bounds cover the one half-shift
that a step launches."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import hdenseformer_tpu_torch.train.loop as loop
from hdenseformer_tpu_torch.models import get_net
from portbench import control, families, flops, roofline, run, spec
from portbench.families import transbts

SEED = 2 ** 31 + 45
CELL, CONFIG = "transbts-train-devaug", "transbts-hecktor21"


def _port_flops(config: dict, batch: int, train: bool) -> float:
    m = config["model"]
    net = get_net(m["name"], m["in_channels"], m["num_classes"], tuple(m["image_size"]),
                  use_kernels=False, s2d=False, device="meta").eval()
    x = torch.empty((batch, *m["image_size"], m["in_channels"]), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            net(x).sum().backward()
        else:
            with torch.no_grad():
                net(x)
    return float(counter.get_total_flops())


def _run(small):
    cfg, mix = small(CELL)
    return run.run(CELL, SEED, 0.2, False, device="cpu", config=cfg, mix=mix)


def test_the_family_is_found_by_name():
    cfg = spec.load("configs", CONFIG)
    assert cfg["family"] == "transbts" and families.of(cfg) is transbts
    assert transbts.system_kwargs(cfg) == {}
    assert spec.cell(CELL)["config"] == CONFIG


@pytest.mark.parametrize("train", [False, True], ids=["forward", "step"])
@pytest.mark.parametrize("size", ["small", "full"])
def test_flops_are_the_port_models(size, train, small):
    cfg = small(CELL)[0] if size == "small" else spec.load("configs", CONFIG)
    assert flops.count(cfg, 2, train) == _port_flops(cfg, 2, train)


def test_the_full_forward_is_two_teraflops():
    assert flops.count(spec.load("configs", CONFIG), 2, False) / 1e12 == pytest.approx(
        2.01, abs=0.01)


def test_a_sound_run_is_correct(small):
    result = _run(small)
    assert result["correct"], result["checks"]
    for c in result["checks"].values():
        assert c["value"] < c["limit"] / 4


def test_a_step_on_half_the_batch_is_not_correct(small, monkeypatch):
    body = loop._step_body

    def half(criterion, num_classes, augment_fn, state, batch, *generators):
        keep = batch["image"].shape[0] // 2
        return body(criterion, num_classes, augment_fn, state,
                    {k: v[:keep] for k, v in batch.items()}, *generators)

    monkeypatch.setattr(loop, "_step_body", half)
    assert not _run(small)["correct"]


def test_the_control_is_not_correct(small):
    cfg, mix = small(CELL)
    limits = spec.load("workloads", CELL)["limits"]
    readings = control.train_controls(cfg, mix, SEED, torch.device("cpu"))
    assert any(readings["fp8"][k] > limit for k, limit in limits.items()), readings
    assert any(readings["half_batch"][k] > limit for k, limit in limits.items()), readings


def test_the_bounds_cover_one_half_shift():
    cfg = spec.load("configs", CONFIG)
    cells = 72 ** 3 + 73 ** 3  # the packed input, read; its shifted copy, written
    want = 2 * cells * 16 * 2 / roofline.HBM_BYTES_PER_S
    assert transbts.train_step_bound_s(cfg, 2, 1.98e9) == pytest.approx(want, rel=1e-12)
    assert transbts.forward_bound_s(cfg, 1, 1.98e9) == pytest.approx(want / 2, rel=1e-12)
    assert transbts.kernel_patterns() == ["(anonymous namespace)::shift_kernel"]


def test_the_family_loads_neither_jax_nor_the_system():
    from portbench.test_portbench_imports import JAX, _top_level_modules

    names = _top_level_modules("import portbench.families.transbts")
    assert not names & (JAX | {"hdenseformer_tpu_torch"})
