"""``correct`` at the tests' size on the CPU: a sound run comes out correct;
a run whose timed path is broken underneath does not, for each fault its
cell can have (a train step that leaves the state unchanged, a train step
on half of its batch, a host augmentation that flips the wrong axis, a
served answer altered where it is produced); and
the control, the reference in fp8 in the system's place, is not correct
either. (One chip: no exchange between chips to leave out.)"""
import numpy as np
import pytest
import torch

import hdenseformer_tpu_torch.data.augment2d as augment2d
import hdenseformer_tpu_torch.infer.sliding as sliding
import hdenseformer_tpu_torch.train.loop as loop
from portbench import control, run, spec

SEED = 2 ** 31 + 21
TRAIN = ("hdf3d-train-devaug", "hdf2d-train")
SERVE = ("hdf3d-serve-preset",)


def _run(cell, small):
    cfg, mix = small(cell)
    return run.run(cell, SEED, 0.2, False, device="cpu", config=cfg, mix=mix)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell, small):
    result = _run(cell, small)
    assert result["correct"], result["checks"]
    for c in result["checks"].values():
        assert c["value"] < c["limit"] / 4 or c["value"] == c["limit"] == 0


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(cell, fault, small, monkeypatch):
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
    assert not _run(cell, small)["correct"]


def test_a_flip_of_the_wrong_axis_is_not_correct(small, monkeypatch):
    def swapped(self, sample, rng):  # transform 7's "hv": H where W is due, W where H is
        assert self.mode == "hv"
        r = rng.uniform(0, 1)
        if r < 0.6:
            axis = -2 if r < 0.3 else -1
            sample = dict(sample, image=np.flip(sample["image"], axis),
                          label=np.flip(sample["label"], axis))
        return dict(sample, image=np.ascontiguousarray(sample["image"]),
                    label=np.ascontiguousarray(sample["label"]))

    monkeypatch.setattr(augment2d.RandomFlip2D, "__call__", swapped)
    result = _run("hdf2d-train", small)
    assert not result["correct"]
    assert result["checks"]["augment_gap"]["value"] > 0.1


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_answer_is_not_correct(cell, small, monkeypatch):
    body = sliding._call_body

    def broken(model, static, patch_size, num_classes, *args):
        out = body(model, static, patch_size, num_classes, *args)
        if "labels" in out:
            corner = tuple(slice(0, p // 4) for p in patch_size)
            out["labels"][corner] = num_classes - 1 - out["labels"][corner]
        return out

    monkeypatch.setattr(sliding, "_call_body", broken)
    assert not _run(cell, small)["correct"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_control_is_not_correct(cell, small):
    cfg, mix = small(cell)
    limits = spec.load("workloads", cell)["limits"]
    controls = control.train_controls if mix["kind"] == "train" else control.serve_controls
    readings = controls(cfg, mix, SEED, torch.device("cpu"))
    assert any(readings["fp8"].get(k, 0.0) > limit for k, limit in limits.items()), readings
    if "augment_gap" in limits:
        assert readings["swapped_flip"]["augment_gap"] > limits["augment_gap"]
