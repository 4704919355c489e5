"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's ``workloads``. Its traffic mix's
``kind`` picks the window driver (``portbench/drivers/<kind>.py``); set-up,
the window and the check against the plain reference are the driver's.
With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<name>.py`` from the run's record. The numbers that
decide ``correct`` are printed beside their limits as the last lines on
standard error and under "checks", the line's last key. The last line of
standard output is the result, as one JSON object.

It runs on an NVIDIA GPU and exits with status 2, printing no result, where
there is none, or where the process holds JAX or the JAX package when the
window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.drivers import Context  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hdenseformer_tpu")


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=60, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        config: dict = None, mix: dict = None, t_start: float = None) -> dict:
    """The result of one run of cell ``name``; ``config`` and ``mix`` replace
    the cell's configuration and traffic (the tests' small sizes)."""
    bench = spec.benchmark()
    entry = spec.cell(name, bench)
    config = config or spec.load("configs", entry["config"])
    mix = mix or spec.load("traffic", entry["traffic"])
    limits = spec.load("workloads", name)["limits"]
    ctx = Context(name, config, mix, seed, seconds, trace, torch.device(device),
                  T_START if t_start is None else t_start)
    driver = importlib.import_module(f"portbench.drivers.{mix['kind']}")
    with contextlib.redirect_stdout(sys.stderr):  # the system's own prints
        record = driver.run(ctx)
    metrics = {}
    for m in spec.metrics_of(name, trace, bench):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    readings = dict(record["readings"])
    checks = {k: {"value": readings.pop(k), "limit": limit} for k, limit in limits.items()}
    diagnostics = dict(record["diagnostics"], **readings)  # numbers that decide nothing
    print(f"portbench: {json.dumps(diagnostics)}", file=sys.stderr)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": device_info(ctx.device, record)}
    if trace and record["trace"] is not None:
        result["breakdown"] = {k: record["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["diagnostics"] = diagnostics
    result["checks"] = checks
    return result


def device_info(device, record) -> dict:
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": record["peak_bytes"], "power_limit_w": power_limit_w()}
    if record["trace"] is not None:
        info.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["window_s"])
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 2
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
