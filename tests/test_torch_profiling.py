"""``utils/profiling.py`` of the port and the CLI's ``--profile``, on the CPU.

``profiler_trace(dir)`` writes a Chrome trace (JSON) of its block, the
program's spans in it and its counters beside it, and
``profiler_trace(None)`` traces nothing; ``Timer`` times its block; the
re-exports of ``utils`` are JAX's names. ``-m train --profile DIR`` traces
the fold's training (JAX's CLI traces the whole ``trainer()`` call) and
trains exactly as without it: the epoch's losses and dice are equal bit
for bit.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from hdenseformer_tpu_torch import cli, utils  # noqa: E402
from hdenseformer_tpu_torch.data.io import save_as_hdf5  # noqa: E402
from hdenseformer_tpu_torch.utils import Timer, profiler_trace  # noqa: E402

CLI = ["-m", "train", "--dataset", "Hecktor21", "--net", "HDenseFormer_16", "--input-shape",
       "16", "16", "16", "--step-size", "8", "8", "8", "--transformer-depth", "4",
       "--no-bf16", "--folds", "2", "--epochs", "1", "--fold", "1", "--version", "pf",
       "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path / "t")) as path:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert os.path.dirname(path) == str(tmp_path / "t") and path.endswith(".json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)


def test_profiler_trace_of_none_traces_nothing(tmp_path):
    with profiler_trace(None) as path:
        torch.ones(3).sum()
    assert path is None and not torch.autograd.profiler._is_profiler_enabled


def test_timer_times_its_block():
    with Timer() as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 5.0


def test_utils_reexports_jax_names():
    for name in ("count_params", "count_flops", "Timer", "set_process_title",
                 "profiler_trace"):
        assert callable(getattr(utils, name)), name


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile")
    rng = np.random.default_rng(0)
    grid = np.indices((24,) * 3) - 12
    for i, pid in enumerate(("pa", "pb", "pc", "pd")):
        ball = np.sqrt((grid ** 2).sum(0)) < 5 + i
        image = np.stack([rng.normal(0, 200, ball.shape) + 300 * ball,
                          rng.gamma(2, 100, ball.shape) + 800 * ball]).astype(np.int16)
        save_as_hdf5(image, str(root / f"{pid}.hdf5"), "ct")
        save_as_hdf5(ball.astype(np.uint8), str(root / f"{pid}.hdf5"), "seg")
    return str(root)


def test_cli_profile_traces_training_and_changes_nothing(cases, tmp_path, monkeypatch):
    runs = {}
    for tag, extra in (("plain", []), ("profiled", ["--profile", str(tmp_path / "trace")])):
        os.makedirs(tmp_path / tag)
        monkeypatch.chdir(tmp_path / tag)
        (runs[tag],) = cli.main(CLI + ["--data-path", cases] + extra)
    written = sorted(os.listdir(tmp_path / "trace"))
    traces = [n for n in written if n.startswith("trace.")]
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert written == ["counters." + traces[0][len("trace."):], traces[0]]
    with open(tmp_path / "trace" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names)  # the model's convolutions ran under it
    program = {e["name"] for e in events if e.get("cat") == "program"}
    assert {"train.step", "train.loader_wait", "loader.sample", "eval.step"} <= program
    assert runs["profiled"] == runs["plain"]  # losses and dice, bit for bit
