"""The port stands alone: no JAX, no JAX package, the GPU by default."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

PORT_MODULES = [
    "hdenseformer_tpu_torch",
    "hdenseformer_tpu_torch.ops",
    "hdenseformer_tpu_torch.ops._build",
    "hdenseformer_tpu_torch.ops.dense_attention",
    "hdenseformer_tpu_torch.ops.instance_norm",
    "hdenseformer_tpu_torch.ops.resize",
    "hdenseformer_tpu_torch.ops.s2d",
    "hdenseformer_tpu_torch.ops.shift_pack",
    "hdenseformer_tpu_torch.models",
    "hdenseformer_tpu_torch.models.layers",
    "hdenseformer_tpu_torch.models.hdenseformer",
    "hdenseformer_tpu_torch.models.hecktor20top1",
    "hdenseformer_tpu_torch.models.daunet",
    "hdenseformer_tpu_torch.models.transbts",
    "hdenseformer_tpu_torch.models.unetr",
    "hdenseformer_tpu_torch.models.unet2d",
    "hdenseformer_tpu_torch.weights",
    "hdenseformer_tpu_torch.data",
    "hdenseformer_tpu_torch.data.transforms",
    "hdenseformer_tpu_torch.data.io",
    "hdenseformer_tpu_torch.data.augment3d",
    "hdenseformer_tpu_torch.data.augment2d",
    "hdenseformer_tpu_torch.data.augment_device",
    "hdenseformer_tpu_torch.data.pipeline",
    "hdenseformer_tpu_torch.data.convert",
    "hdenseformer_tpu_torch.infer",
    "hdenseformer_tpu_torch.infer.sliding",
    "hdenseformer_tpu_torch.infer.slices",
    "hdenseformer_tpu_torch.losses",
    "hdenseformer_tpu_torch.losses.losses",
    "hdenseformer_tpu_torch.metrics",
    "hdenseformer_tpu_torch.metrics.batch",
    "hdenseformer_tpu_torch.metrics.running",
    "hdenseformer_tpu_torch.metrics.eval3d",
    "hdenseformer_tpu_torch.train",
    "hdenseformer_tpu_torch.train.state",
    "hdenseformer_tpu_torch.train.loop",
    "hdenseformer_tpu_torch.train.checkpoint",
    "hdenseformer_tpu_torch.train.logging",
    "hdenseformer_tpu_torch.configs",
    "hdenseformer_tpu_torch.configs.config",
    "hdenseformer_tpu_torch.utils",
    "hdenseformer_tpu_torch.cli",
    "hdenseformer_tpu_torch.bench",
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'hdenseformer_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "hdenseformer_tpu." not in src


def test_get_net_defaults_to_the_gpu(monkeypatch):
    from hdenseformer_tpu_torch.models import get_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("HDenseFormer_32", "hecktor20top1", "da_unet", "TransBTS", "unetr"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_net(name, 2, 2, (32, 32, 32), transformer_depth=4)


@pytest.mark.parametrize("name", ["HDenseFormer_2D_32", "unet", "unet++", "deeplabv3+"])
def test_2d_names_build_on_cpu_and_need_a_card(name, monkeypatch):
    """The 2-D names are ported: each builds on the CPU when asked and, as
    every name, raises without a card otherwise."""
    from hdenseformer_tpu_torch.models import get_net

    enc = None if name.startswith("HDenseFormer") else "resnet18"
    net = get_net(name, 3, 2, (64, 64), transformer_depth=4, encoder_name=enc, device="cpu")
    assert next(net.parameters()).device.type == "cpu" and not net.training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_net(name, 3, 2, (64, 64), transformer_depth=4, encoder_name=enc)
