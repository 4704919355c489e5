"""What BENCHMARK.json and the benchmark's data files say, found by name.

A cell (``workloads`` entry) names a configuration, ``portbench/configs/
<config>.json``, and a traffic mix, ``portbench/traffic/<traffic>.json``;
its limits of ``correct`` are ``portbench/workloads/<cell>.json``. Every
metric is read by ``portbench/metrics/<metric name>.py``. A later cell,
configuration, mix or metric is a new file and an entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file portbench/{kind}/{name}.json")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(BENCHMARK) as f:
        return json.load(f)


def cell(name: str, bench: dict = None) -> dict:
    bench = bench or benchmark()
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(name: str, trace: bool, bench: dict = None) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones: a
    metric with a ``workloads`` key where it lists the cell; a per-layer
    metric without one wherever the end-to-end metric it moves is reported."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m["workloads"] or "workloads" not in m and m["moves"] in moved]


def reader(metric: str):
    """``read(record) -> float | None`` of ``portbench/metrics/<metric>.py``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
