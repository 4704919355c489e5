"""The port's checkpoints and metrics log against the JAX package's, on the CPU.

Names, selection and retention are JAX's letter for letter; the file format
is the port's own (``torch.save``), and a background write neither races the
optimizer nor hides its errors.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu.train import checkpoint as jckpt  # noqa: E402
from hdenseformer_tpu.train.logging import MetricsWriter as JMetricsWriter  # noqa: E402
from hdenseformer_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from hdenseformer_tpu_torch.train.logging import MetricsWriter  # noqa: E402

METRICS = [(0, 12.345678, 0.1, 0.11, 9.87654, 0.2, 0.21), (7, 0.5, 0.9, 0.91, 0.25, 0.8, 0.81),
           (12, 1e-7, 1.0, 1.0, 3e5, 0.0, 0.0)]


def test_metric_filename_matches_jax():
    for m in METRICS:
        assert tckpt.metric_filename(*m) == jckpt.metric_filename(*m)


def _tree(root):
    """ckpt/<version>/fold{1,2,3}: 5, 2 and 0 metric-named files."""
    for fold, epochs in (("fold1", (0, 3, 10, 11, 2)), ("fold2", (4, 1)), ("fold3", ())):
        d = root / "v1" / fold
        d.mkdir(parents=True)
        for e in epochs:
            (d / jckpt.metric_filename(e, 1, 0.5, 0.5, 1, 0.5, 0.5)).write_bytes(b"x")
    return root


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


def test_weight_selection_and_retention_match_jax(tmp_path):
    ours, ref = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    for fold in ("fold1", "fold2", "fold3", "missing"):
        a = tckpt.get_weight_path(str(ours / "v1" / fold))
        b = jckpt.get_weight_path(str(ref / "v1" / fold))
        assert (a and os.path.relpath(a, ours)) == (b and os.path.relpath(b, ref))
    assert [os.path.relpath(p, ours) for p in tckpt.get_weight_list(str(ours / "v1"))] == \
        [os.path.relpath(p, ref) for p in jckpt.get_weight_list(str(ref / "v1"))]
    tckpt.dfs_remove_weight(str(ours), retain=3)
    jckpt.dfs_remove_weight(str(ref), retain=3)
    assert _listing(ours) == _listing(ref)
    assert len(os.listdir(ours / "v1" / "fold1")) == 3  # 11, 10 and 3 kept
    tckpt.remove_weight_path(str(ours / "v1" / "fold2"), retain=1)
    assert len(os.listdir(ours / "v1" / "fold2")) == 1


def _trained(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(torch.randn(5, 4)).square().sum().backward()
    opt.step()
    return model, opt


def test_checkpoint_round_trip_restores_model_and_optimizer(tmp_path):
    model, opt = _trained()
    path = str(tmp_path / "sub" / "a.ckpt")
    tckpt.save_checkpoint(path, model.state_dict(), opt.state_dict(), epoch=4, step=9)
    assert os.listdir(tmp_path / "sub") == ["a.ckpt"]  # the .tmp was renamed into place
    ck = tckpt.load_checkpoint(path)
    assert (ck["epoch"], ck["step"]) == (4, 9)
    model2, opt2 = _trained(seed=1)
    model2.load_state_dict(ck["model"])
    opt2.load_state_dict(ck["optimizer"])
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    for k, v in opt.state_dict()["state"].items():
        for name, t in v.items():
            assert torch.equal(t, opt2.state_dict()["state"][k][name])


def test_async_save_writes_the_state_of_its_call(tmp_path, monkeypatch):
    """optimizer.step() updates the tensors in place: the file must hold the
    values at the call, not a later step's. The write is held back until the
    tensors have moved on."""
    import threading

    release, save = threading.Event(), torch.save

    def held_save(obj, f):
        assert release.wait(30)
        save(obj, f)

    monkeypatch.setattr(torch, "save", held_save)
    model, opt = _trained()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    want_avg = opt.state_dict()["state"][0]["exp_avg"].clone()
    path = str(tmp_path / "b.ckpt")
    tckpt.save_checkpoint(path, model.state_dict(), opt.state_dict(), 1, 1, async_save=True)
    for _ in range(3):  # mutate after the call, as the next epoch would
        model(torch.randn(5, 4)).square().sum().backward()
        opt.step()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    release.set()
    tckpt.wait_for_async_saves()
    ck = tckpt.load_checkpoint(path)
    for k, v in want.items():
        assert torch.equal(ck["model"][k], v), k
    assert torch.equal(ck["optimizer"]["state"][0]["exp_avg"], want_avg)
    assert not torch.equal(ck["model"]["0.weight"], model.state_dict()["0.weight"])


def test_failed_async_write_raises_at_wait(tmp_path):
    model, _ = _trained()
    target = tmp_path / "a_directory.ckpt"
    target.mkdir()  # renaming the written file onto a directory fails
    tckpt.save_checkpoint(str(target), model.state_dict(), async_save=True)
    tckpt.save_checkpoint(str(tmp_path / "ok.ckpt"), model.state_dict(), async_save=True)
    with pytest.raises(OSError):
        tckpt.wait_for_async_saves()
    assert os.path.exists(tmp_path / "ok.ckpt")  # the other write completed
    tckpt.wait_for_async_saves()  # nothing left: returns


def test_metrics_writer_writes_jax_records(tmp_path):
    logs = []
    for cls, name in ((MetricsWriter, "t"), (JMetricsWriter, "j")):
        w = cls(str(tmp_path / name))
        w.add_scalars("data/loss", {"train": 1.5, "val": np.float32(2.25)}, 3)
        w.add_scalar("data/lr", 1e-3, 3)
        w.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            logs.append([{k: v for k, v in json.loads(line).items() if k != "t"} for line in f])
    assert logs[0] == logs[1]
    assert logs[0][0] == {"tag": "data/loss/train", "value": 1.5, "step": 3}
