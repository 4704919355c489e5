"""The harness's data and arithmetic on the CPU: every file a cell names
loads, the traffic is a function of the seed, the window statistics, the
trace's busy time and idle gaps, and a run without a card fails."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import roofline, spec, traffic, trace
from portbench.drivers.serve import lattice_cell

ROOT = Path(__file__).resolve().parent.parent


def test_benchmark_names_files_that_load():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in bench["configs"]}
    for cfg in configs.values():
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        assert spec.load("configs", cfg["name"])["reduced"] == cfg["reduced"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for cell in bench["workloads"]:
        assert cell["config"] in configs and cell["chips"] == 1
        mix = spec.load("traffic", cell["traffic"])
        limits = spec.load("workloads", cell["name"])["limits"]
        assert mix["kind"] in ("train", "serve") and limits
        reported = spec.metrics_of(cell["name"], False, bench)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert spec.metrics_of(cell["name"], True, bench)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_cells_of_each_mix_report_their_metrics():
    for name in ("hdf3d-train-devaug", "hdf2d-train"):
        assert {m["name"] for m in spec.metrics_of(name, False)} == {
            "train_samples_per_s", "setup_s"}
    assert {m["name"] for m in spec.metrics_of("hdf3d-serve-preset", False)} == {
        "serve_volumes_per_s", "serve_latency_p95_ms", "setup_s"}


def test_traffic_is_a_function_of_the_seed():
    mix = {"case_size": [16, 16, 16], "cases": 2}
    a = traffic.train_cases(mix, 2 ** 31 + 7, "cpu")
    b = traffic.train_cases(mix, 2 ** 31 + 7, "cpu")
    c = traffic.train_cases(mix, 2 ** 31 + 8, "cpu")
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
    assert not np.array_equal(a[0][0], c[0][0])
    assert a[0][1].any() and not a[0][1].all()


def test_every_seed_serves_the_same_shapes():
    mix = dict(spec.load("traffic", "serve-preset-144"), pool=4, size_low=17, size_high=24)
    pools = [traffic.serve_pool(mix, seed, "cpu") for seed in (1, 2 ** 33 + 5)]
    shapes = [sorted(img.shape for img, _ in pool) for pool in pools]
    assert shapes[0] == shapes[1]
    assert not np.array_equal(pools[0][0][0], pools[1][0][0])
    full = spec.load("traffic", "serve-preset-144")
    cells = {lattice_cell(s, (144,) * 3, (72,) * 3) for s in traffic.serve_shapes(full)}
    assert cells == {(144, 144, 144)}


def test_window_statistics():
    record = {"kind": "serve", "window_s": 20.0, "units": 100,
              "latencies_s": [i / 1000 for i in range(1, 101)], "normalize_s": [0.01, 0.03]}
    assert spec.reader("serve_volumes_per_s")(record) == 5.0
    assert spec.reader("serve_latency_p95_ms")(record) == pytest.approx(95.05)
    assert spec.reader("normalize_ms.serve")(record) == pytest.approx(20.0)
    assert spec.reader("train_samples_per_s")(record) is None
    train = {"kind": "train", "window_s": 10.0, "samples": 240, "loader_wait_s": 0.5,
             "flops": 989e12, "trace": None, "kernel_bound_s": 1.0}
    assert spec.reader("train_samples_per_s")(train) == 24.0
    assert spec.reader("loader_wait_pct.train")(train) == 5.0
    assert spec.reader("mfu.train")(train) == pytest.approx(10.0)
    assert spec.reader("kernel_roofline_pct.train")(train) is None  # nothing traced


def test_busy_union_and_idle_gaps():
    busy = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert trace.union(busy) == [(0, 20), (30, 40)]
    assert trace.busy_union_s(busy) == 30e-9
    spans = [(18, 32, "portbench.normalize"), (0, 100, "portbench.predict_volume")]
    gaps = trace.idle_gaps(trace.union(busy), spans, 0, 50)
    assert gaps == pytest.approx({"normalize": 10e-9, "predict_volume": 10e-9})


def test_trace_summary_reads_a_profile():
    with trace.profiled(True) as prof:
        with trace.span("step_call"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert trace.summarize(prof["prof"], 1.0) is None  # no device operation on the CPU


def test_roofline_shapes():
    config = spec.load("configs", "hdf3d-hecktor21")
    assert len(roofline.norm_shapes(config)) == 18
    assert roofline.attention_calls(config) == (48, 729)
    bound = roofline.forward_bound_s(config, 8, 1.98e9)
    # 8 windows: 16 norms at 3.146 ms of bytes, the packed level's two at the fine
    # grid's 0.913 ms each, 48 attentions bound by their exponentials
    assert bound * 1e3 == pytest.approx(3.146 + 2 * 0.913 + 48 * 0.00813, rel=0.01)


@pytest.mark.parametrize("name", ["hdf3d-hecktor21", "hdf2d-picai22"])
def test_train_bound_counts_the_forward_that_remat_recomputes(name):
    config = spec.load("configs", name)
    assert config["remat"] is True
    forward = roofline.forward_bound_s(config, 2, 1.98e9)
    backward = roofline.backward_bound_s(config, 2)
    assert roofline.recompute_bound_s(config, 2, 1.98e9) == forward
    assert roofline.train_step_bound_s(config, 2, 1.98e9) == pytest.approx(
        2 * forward + backward)
    plain = dict(config, remat=False)
    assert roofline.train_step_bound_s(plain, 2, 1.98e9) == pytest.approx(forward + backward)
    encoder = roofline.recompute_bound_s(dict(config, remat="encoder"), 2, 1.98e9)
    assert 0 < encoder < forward


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hdf3d-serve-preset",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_result_line_is_json_with_the_contract_keys(small):
    from portbench import run

    cfg, mix = small("hdf3d-serve-preset")
    result = run.run("hdf3d-serve-preset", 2 ** 31 + 3, 0.5, False, device="cpu", config=cfg,
                     mix=mix)
    line = json.loads(json.dumps(result))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["attempted"] >= 1
