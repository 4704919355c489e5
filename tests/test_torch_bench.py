"""``python -m hdenseformer_tpu_torch.bench``: bench.py's protocol and lines.

Run on the CPU at 16^3, depth 2, one window of 2 steps (``--device cpu``
and the size options exist for this): one stdout line with bench.py's four
keys, its three stderr keys after ``first_call_s``. The constants are
bench.py's, and the line's value is bench.py's formula.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import bench as jax_bench  # noqa: E402
from hdenseformer_tpu_torch import bench  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_prints_bench_py_lines_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "hdenseformer_tpu_torch.bench", "--device", "cpu", "--size",
         "16", "--depth", "2", "--steps", "2", "--reps", "1"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "train_throughput_128eq_patches_per_sec"
    assert line["unit"] == "patches/s/chip" and line["value"] > 0
    err = [json.loads(s) for s in proc.stderr.strip().splitlines() if s.startswith("{")]
    assert list(err[0]) == ["first_call_s"]
    assert list(err[1]) == ["rep_window_s", "ms_per_step_best", "contention_spread"]
    assert len(err[1]["rep_window_s"]) == 1 and err[1]["contention_spread"] == 1.0


def test_constants_and_formula_are_bench_py_s():
    for name in ("VOL", "CHANNELS", "BATCH", "REMAT", "DEPTH", "STEPS", "REPS"):
        want = getattr(jax_bench, name)
        assert getattr(bench, name) == (want[0] if name == "VOL" else want), name
    with open(jax_bench._BASELINE_FILE) as f:
        base = json.load(f)["patches_per_sec"]
    line = bench.result_line(1.5)
    value = jax_bench.BATCH * jax_bench.STEPS * jax_bench.PATCH_EQUIV / 1.5
    assert line == {"metric": "train_throughput_128eq_patches_per_sec",
                    "value": round(value, 4), "unit": "patches/s/chip",
                    "vs_baseline": round(value / base, 2)}
    assert bench.result_line(1.5, baseline_file=None)["vs_baseline"] is None
    timed = {"rep_window_s": [2.0, 1.5, 1.75, 1.5], "best_window_s": 1.5, "steps": 8}
    assert bench.window_line(timed) == {"rep_window_s": [2.0, 1.5, 1.75, 1.5],
                                        "ms_per_step_best": 187.5,
                                        "contention_spread": 1.333}


def test_bench_trains_and_needs_the_card(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _train_small()
    finally:
        torch.set_num_threads(threads)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def _train_small():
    state, step, batch, gen = bench.build("cpu", size=16, depth=2)
    assert batch["image"].shape == (1, 16, 16, 16, 2) and not batch["image"].any()
    assert bool((batch["label"][..., 0] == 1).all()) and not batch["label"][..., 1].any()
    assert not state.model.remat
    assert any(getattr(m, "dtype", None) == torch.bfloat16 for m in state.model.modules())
    timed = bench.time_steps(state, step, batch, gen, steps=2, reps=2)
    assert state.step == 5 and len(timed["rep_window_s"]) == 2
    assert timed["window_losses"][-1] < timed["first_loss"]
