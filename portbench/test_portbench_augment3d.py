"""The host 3-D augmentation's reference (``reference/augment3d.py``)
against the system's pipeline, and ``correct`` of the train driver on the
mix that feeds it (``traffic/train-hostaug-24cases.json``, limits
``workloads/hdf3d-train-hostaug.json``; a cell held back from BENCHMARK.json,
see PERF.md) at the tests' size on the CPU: a sound run is correct; a run
whose feed or step is broken underneath is not, nor is the control.

The reference and the system are held to bit equality (tolerance 0): both
do the same float32 operations, and interpolate with scipy's
``map_coordinates`` at coordinates computed in float64 with the same
products and sums, so any difference is a change of the augmentation."""
import time

import numpy as np
import pytest
import torch

import hdenseformer_tpu_torch.data.augment3d as port_augment3d
import hdenseformer_tpu_torch.data.pipeline as pipeline
import hdenseformer_tpu_torch.train.loop as loop
from hdenseformer_tpu_torch.data.transforms import Compose, PETandCTNormalize, ToOneHot
from portbench import control, faults_hostaug, spec, traffic
from portbench.conftest import small_config
from portbench.drivers import Context, train
from portbench.reference import augment2d, augment3d
from portbench.test_portbench_imports import JAX, _top_level_modules

CELL, CONFIG, TRAFFIC = "hdf3d-train-hostaug", "hdf3d-hecktor21", "train-hostaug-24cases"
SEED = 2 ** 31 + 45


def _port_pipeline(patch, num_classes):
    return Compose([port_augment3d.RandomCrop3D(patch), PETandCTNormalize(),
                    port_augment3d.RandomTranslationRotationZoom3D("tr", num_classes),
                    port_augment3d.RandomFlip3D("hv"), ToOneHot(num_classes, 2)])


def _cases(size, num_classes, n=4):
    cases = traffic.train_cases({"case_size": list(size), "cases": n}, SEED, "cpu")
    if num_classes > 2:  # a second class inside the first, as nested regions lie
        cases = [(image, label + (np.roll(label, 3, axis=1) > 0) * label) for image, label in
                 cases]
    return cases


@pytest.mark.parametrize("size,patch,num_classes", [
    ((16, 16, 16), (16, 16, 16), 2),
    ((20, 24, 28), (16, 16, 16), 2),
    ((32, 32, 32), (32, 32, 32), 3)])
def test_reference_equals_the_system_bitwise(size, patch, num_classes):
    port = _port_pipeline(patch, num_classes)
    for i, (image, label) in enumerate(_cases(size, num_classes)):
        got = port({"image": image, "label": label}, augment2d.sample_rng(SEED, 1, i))
        image_r, onehot_r = augment3d.augment(image, label, augment2d.sample_rng(SEED, 1, i),
                                              augment3d.SUPPORTED, num_classes, patch)
        assert got["image"].dtype == image_r.dtype == np.float32
        np.testing.assert_array_equal(got["image"], image_r)
        np.testing.assert_array_equal(got["label"], onehot_r)
        assert onehot_r[..., 1:].any()


def test_the_reference_and_the_family_load_neither_jax_nor_the_system():
    names = _top_level_modules(
        "import portbench.reference.augment3d, portbench.families.hdenseformer")
    assert not names & (JAX | {"hdenseformer_tpu_torch"})


def test_the_reference_refuses_other_transforms():
    image, label = _cases((16, 16, 16), 2, 1)[0]
    with pytest.raises(NotImplementedError):
        augment3d.augment(image, label, augment2d.sample_rng(0, 0, 0), (1, 2, 3, 6), 2,
                          (16, 16, 16))


def _small():
    """The configuration and the mix at the tests' size, as ``small_mix`` cuts
    a train mix."""
    cfg = small_config(CONFIG)
    mix = dict(spec.load("traffic", TRAFFIC), cases=3 * cfg["train"]["batch_size"],
               case_size=cfg["model"]["image_size"], num_workers=2)
    return cfg, mix


def _run():
    """The train driver's run of the mix, judged against the held cell's
    limits as ``run.run`` judges a cell's."""
    cfg, mix = _small()
    record = train.run(Context(CELL, cfg, mix, SEED, 0.2, False, torch.device("cpu"),
                               time.perf_counter()))
    checks = {k: {"value": record["readings"][k], "limit": limit}
              for k, limit in spec.load("workloads", CELL)["limits"].items()}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}


def test_a_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["checks"]["augment_gap"]["value"] == 0
    for c in result["checks"].values():
        assert c["value"] < c["limit"] / 4 or c["value"] == c["limit"] == 0


def test_the_held_cell_is_the_device_fed_cell_with_a_host_feed():
    assert CELL not in {w["name"] for w in spec.benchmark()["workloads"]}
    mix, devaug = spec.load("traffic", TRAFFIC), spec.load("traffic", "train-devaug-24cases")
    assert mix["device_augment"] is False and mix["transform_3d"] == list(augment3d.SUPPORTED)
    own = ("device_augment", "transform_3d", "trace_seconds", "why")
    assert {k: v for k, v in mix.items() if k not in own} == {
        k: v for k, v in devaug.items() if k not in own}
    limits = spec.load("workloads", CELL)["limits"]
    assert limits == dict(spec.load("workloads", "hdf3d-train-devaug")["limits"],
                          augment_gap=0)


def test_a_rotation_of_the_wrong_sign_is_not_correct(monkeypatch):
    rot_x = port_augment3d._rot_x
    monkeypatch.setattr(port_augment3d, "_rot_x", lambda angle: rot_x(-angle))
    result = _run()
    assert not result["correct"]
    assert result["checks"]["augment_gap"]["value"] > 0.1


def test_a_generator_of_the_next_sample_is_not_correct(monkeypatch):
    load_one = pipeline.BatchLoader._load_one
    monkeypatch.setattr(pipeline.BatchLoader, "_load_one",
                        lambda self, epoch, index: load_one(self, epoch, index + 1)
                        if index + 1 < len(self.dataset) else load_one(self, epoch, 0))
    result = _run()
    assert not result["correct"]
    assert result["checks"]["augment_gap"]["value"] > 0.1


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    body = loop._step_body

    def broken(criterion, num_classes, augment_fn, state, batch, *generators):
        if fault == "half_batch":
            half = batch["image"].shape[0] // 2
            return body(criterion, num_classes, augment_fn, state,
                        {k: v[:half] for k, v in batch.items()}, *generators)
        saved = [p.detach().clone() for p in state.model.parameters()]
        out = body(criterion, num_classes, augment_fn, state, batch, *generators)
        with torch.no_grad():
            for p, before in zip(state.model.parameters(), saved):
                p.copy_(before)
            for moments in state.optimizer.state.values():
                for name, v in moments.items():
                    if name != "step" and torch.is_tensor(v):
                        v.zero_()
        return out

    monkeypatch.setattr(loop, "_step_body", broken)
    assert not _run()["correct"]


def test_the_control_and_the_planted_faults_are_not_correct():
    cfg, mix = _small()
    limits = spec.load("workloads", CELL)["limits"]
    readings = control.train_controls(cfg, mix, SEED, torch.device("cpu"))
    assert any(readings["fp8"].get(k, 0.0) > limit for k, limit in limits.items()), readings
    assert readings["swapped_flip"]["augment_gap"] > limits["augment_gap"]
    faults = faults_hostaug.fault_readings(cfg, mix, SEED, torch.device("cpu"))
    for name in faults_hostaug.FAULTS:
        assert faults[name]["augment_gap"] > 0.1, (name, faults[name])
