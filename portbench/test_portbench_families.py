"""Model families on the CPU: a family is found by the name its
configuration gives, from a module that nothing else names; the drivers,
the FLOPs and the bounds go through it; and both sides start from the
buffers that a fresh reference model holds."""
import sys
import textwrap

import pytest
import torch

import hdenseformer_tpu_torch.train.loop as loop
from portbench import families, flops, roofline, run, spec, weights
from portbench.families import hdenseformer

SEED = 2 ** 31 + 33
CELLS = ("hdf3d-train-devaug", "hdf2d-train")

RENAMED = "from portbench.families.hdenseformer import *  # noqa: F401,F403\n"

# The reference scales its input by a buffer that a fresh model holds at 1;
# the system's own copy of the buffer starts at 0.5, so the two agree only
# where the driver loads one starting state into both.
SCALED = textwrap.dedent('''
    import torch

    from portbench.families import hdenseformer
    from portbench.families.hdenseformer import *  # noqa: F401,F403


    class Scaled(torch.nn.Module):
        def __init__(self, net, value, device=None):
            super().__init__()
            self.net = net
            self.register_buffer("scale", torch.full((), value, device=device))

        def set_precision(self, precision):
            self.net.set_precision(precision)
            return self

        def forward(self, x, generator=None):
            return self.net(x * self.scale, generator)


    def build(config, device=None):
        return Scaled(hdenseformer.build(config, device), 1.0, device)
''')


@pytest.fixture
def new_family(tmp_path, monkeypatch):
    """Writes a family module under a new name where the package finds it."""
    monkeypatch.setattr(families, "__path__", list(families.__path__) + [str(tmp_path)])
    written = []

    def write(name: str, source: str) -> str:
        (tmp_path / f"{name}.py").write_text(source)
        written.append(name)
        return name
    yield write
    for name in written:
        sys.modules.pop(f"{families.__name__}.{name}", None)


def _run(cell, cfg, mix):
    return run.run(cell, SEED, 0.2, False, device="cpu", config=cfg, mix=mix)


def test_a_configuration_without_a_family_is_hdenseformer():
    for entry in spec.benchmark()["configs"]:
        assert families.of(spec.load("configs", entry["name"])) is hdenseformer
    with pytest.raises(ModuleNotFoundError):
        families.of({"family": "no_such_family"})


@pytest.mark.parametrize("cell", CELLS)
def test_a_new_family_module_drives_the_same_run(cell, small, new_family):
    cfg, mix = small(cell)
    renamed = dict(cfg, family=new_family("hdf_renamed", RENAMED))
    assert families.of(renamed).__name__ == "portbench.families.hdf_renamed"
    a, b = _run(cell, cfg, mix), _run(cell, renamed, mix)
    assert a["correct"] and b["correct"]
    assert a["attempted"] == b["attempted"]
    assert {k: c["value"] for k, c in a["checks"].items()} == {
        k: c["value"] for k, c in b["checks"].items()}
    for key in ("loss_gap", "grad_gap_every_leaf"):
        assert a["diagnostics"][key] == b["diagnostics"][key]


def test_flops_and_bounds_follow_the_family(new_family):
    cfg = spec.load("configs", "hdf3d-hecktor21")
    renamed = dict(cfg, family=new_family("hdf_renamed", RENAMED))
    assert flops.count(renamed, 1, train=False) == flops.count(cfg, 1, train=False)
    family = families.of(renamed)
    assert family.train_step_bound_s(renamed, 2, 1.98e9) == roofline.train_step_bound_s(
        cfg, 2, 1.98e9)
    assert family.kernel_patterns() == hdenseformer.kernel_patterns()


def test_the_start_holds_a_fresh_reference_models_buffers(new_family):
    cfg = dict(spec.load("configs", "hdf3d-hecktor21"), family=new_family("scaled", SCALED))
    cfg["model"] = dict(cfg["model"], image_size=[32] * 3, transformer_depth=4)
    params, buffers = weights.start(cfg, SEED, torch.device("cpu"))
    assert list(buffers) == ["scale"] and float(buffers["scale"]) == 1.0
    assert "scale" not in params and all(n.startswith("net.") for n in params)
    assert weights.start(spec.load("configs", "hdf3d-hecktor21"), SEED, "cpu")[1] == {}


def test_the_reference_starts_from_the_buffers_loaded_into_the_system(small, new_family,
                                                                       monkeypatch):
    module = families.of({"family": new_family("scaled", SCALED)})
    get_net = loop.get_net

    def scaled_net(*args, **kwargs):
        return module.Scaled(get_net(*args, **kwargs), 0.5)

    monkeypatch.setattr(loop, "get_net", scaled_net)
    cfg, mix = small("hdf3d-train-devaug")
    result = _run("hdf3d-train-devaug", dict(cfg, family="scaled"), mix)
    assert result["correct"], result["checks"]
