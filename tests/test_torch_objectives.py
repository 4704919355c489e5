"""The port's LR schedules, early stopping and metrics against JAX's.

The five schedules over 12 epochs (ReduceLROnPlateau fed a fixed metric
sequence), EarlyStopping on fixed sequences, RunningConfusionMatrix and the
offline eval3d metrics on random label volumes: all equal.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu.metrics import eval3d as jeval  # noqa: E402
from hdenseformer_tpu.metrics.running import RunningConfusionMatrix as JRCM  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import EarlyStopping as JEarlyStopping  # noqa: E402
from hdenseformer_tpu_torch.metrics import eval3d as teval  # noqa: E402
from hdenseformer_tpu_torch.metrics.running import RunningConfusionMatrix  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import EarlyStopping  # noqa: E402


SCHEDULERS = ["poly_lr", "MultiStepLR", "CosineAnnealingLR", "CosineAnnealingWarmRestarts",
              "ReduceLROnPlateau"]
# a validation loss that falls, then stalls past the plateau's patience once
METRICS = [1.0, 0.8, 0.7, 0.7, 0.71, 0.72, 0.7, 0.75, 0.71, 0.7, 0.7, 0.7]


@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_matches_jax_over_12_epochs(name):
    kw = dict(n_epoch=10, milestones=(3, 7), gamma=0.5, T_max=4)
    ours, ref = tstate.get_lr_scheduler(name, 1e-3, **kw), jstate.get_lr_scheduler(
        name, 1e-3, **kw)
    prev, got, want = None, [], []
    for m in METRICS:
        got.append(ours.step(prev))
        want.append(ref.step(prev))
        prev = m
    assert got == want
    assert len(set(got)) > 1 or name == "ReduceLROnPlateau"
    if name == "ReduceLROnPlateau":
        assert got[-1] == pytest.approx(1e-4)  # reduced once, after 6 epochs without a gain


def test_set_and_read_the_learning_rate():
    p = torch.nn.Parameter(torch.zeros(3, 3))
    b = torch.nn.Parameter(torch.zeros(3))
    opt = tstate.get_optimizer("Adam", 1e-3, weight_decay=1e-4, params=[p, b])
    tstate.set_learning_rate(opt, 2.5e-4)
    assert [g["lr"] for g in opt.param_groups] == [2.5e-4, 2.5e-4]
    assert tstate.current_learning_rate(opt) == 2.5e-4
    with pytest.raises(ValueError, match="unknown"):
        tstate.get_lr_scheduler("nope", 1e-3)


@pytest.mark.parametrize("op_type,values", [
    ("max", [0.1, 0.3, 0.3, 0.29, 0.31, 0.2, 0.2, 0.2]),
    ("min", [1.0, 0.9, 0.95, 0.5, 0.497, 0.6, 0.7]),
])
def test_early_stopping_matches_jax(op_type, values):
    ours = EarlyStopping(patience=3, verbose=False, delta=0.005, op_type=op_type)
    ref = JEarlyStopping(patience=3, verbose=False, delta=0.005, op_type=op_type)
    for v in values:
        ours(v)
        ref(v)
        assert (ours.counter, ours.early_stop, ours.best_value) == (
            ref.counter, ref.early_stop, ref.best_value)
    assert ours.early_stop


def test_running_confusion_matrix_matches_jax():
    rng = np.random.RandomState(8)
    ours, ref = RunningConfusionMatrix(range(3)), JRCM(range(3))
    assert ours.compute_mIoU() == ref.compute_mIoU() == (0.0, [])
    for _ in range(3):
        gt, pr = rng.randint(0, 3, (4, 5, 6)), rng.randint(0, 3, (4, 5, 6))
        ours.update_matrix(gt, pr)
        ref.update_matrix(gt, pr)
    ours.update_matrix(np.zeros((2, 2)), np.ones((2, 2)))  # all ignore_label: skipped
    ref.update_matrix(np.zeros((2, 2)), np.ones((2, 2)))
    assert ours.compute_mIoU() == ref.compute_mIoU()
    np.testing.assert_array_equal(ours.overall_confusion_matrix, ref.overall_confusion_matrix)
    ours.init_op()
    assert ours.overall_confusion_matrix is None


def _label_volume(rng, shape, n_cls):
    vol = np.zeros(shape, np.int64)
    for c in range(1, n_cls):
        lo = [rng.randint(0, s // 2) for s in shape]
        hi = [lo_ + rng.randint(2, s // 2) for lo_, s in zip(lo, shape)]
        vol[tuple(slice(a, b) for a, b in zip(lo, hi))] = c
    noise = rng.rand(*shape) < 0.02
    vol[noise] = rng.randint(0, n_cls, int(noise.sum()))
    return vol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval3d_matches_jax(seed):
    rng = np.random.RandomState(seed)
    gt, pred = _label_volume(rng, (14, 12, 16), 3), _label_volume(rng, (14, 12, 16), 3)
    pred[pred == 2] = 0 if seed == 2 else 2  # seed 2: a class never predicted (NaN HD)
    for fn in ("multi_dice", "multi_hd", "multi_jc", "multi_vs", "multi_asd"):
        got, want = getattr(teval, fn)(gt, pred, 2), getattr(jeval, fn)(gt, pred, 2)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]), err_msg=fn)
        assert got[1] == want[1] or (math.isnan(got[1]) and math.isnan(want[1])), fn
    spacing = (2.0, 1.0, 0.5)
    a, b = teval.cal_score(pred == 1, gt == 1, spacing), jeval.cal_score(pred == 1, gt == 1,
                                                                          spacing)
    assert a == b
    assert teval.cal_asd(pred == 1, gt == 1, spacing) == jeval.cal_asd(pred == 1, gt == 1,
                                                                       spacing)
