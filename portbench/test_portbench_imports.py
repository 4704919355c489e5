"""The import guard: nothing the harness or its reference loads is JAX, the
JAX package or (for the reference) the system under test. Module names are
compared by their whole top-level name: the system's package name begins
with the JAX package's."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "hdenseformer_tpu"}
SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_system():
    names = _top_level_modules(
        "import portbench.reference.model, portbench.reference.augment, "
        "portbench.reference.augment2d, portbench.reference.train, portbench.reference.serve")
    assert not names & (JAX | {"hdenseformer_tpu_torch"})


def test_a_run_loads_no_jax():
    body = """
from portbench import run, control  # noqa: F401
from portbench.conftest import small_config, small_mix
for cell in ("hdf3d-train-devaug", "hdf2d-train", "hdf3d-serve-preset"):
    cfg = small_config(run.spec.cell(cell)["config"])
    run.run(cell, 11, 0.1, False, device="cpu", config=cfg, mix=small_mix(cell, cfg))
"""
    names = _top_level_modules(body)
    assert "hdenseformer_tpu_torch" in names
    assert not names & JAX
