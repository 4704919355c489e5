"""``get_net(..., use_kernels=False)`` reaches no kernel wrapper, for every name.

Every model of ``get_net`` is built on the CPU at its default ``s2d`` (the
packed levels JAX runs) with ``use_kernels=False`` and trained one forward
and backward, with the kernel wrappers (attention, InstanceNorm forward and
backward in both modes, the half-shift and its transpose) replaced, in
every port module that holds them, by a function that raises. TransBTS's
packed ``InitConv`` then takes the half-shift's plain version. The other
way round, with ``use_kernels=True`` the models that have a kernel on their
path reach its wrapper, which shows the replacement is seen.
"""
import sys

import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.models import get_net  # noqa: E402
# every model module imported now, so that the replacement reaches its names
from hdenseformer_tpu_torch.models import (  # noqa: E402,F401
    daunet,
    hdenseformer,
    hecktor20top1,
    transbts,
    unet2d,
    unetr,
)
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.ops import dense_attention, instance_norm, shift_pack  # noqa: E402

WRAPPERS = {
    "dense_attention": dense_attention.dense_attention,
    "instance_norm_relu": instance_norm.instance_norm_relu,
    "instance_norm_relu_fwd": instance_norm.instance_norm_relu_fwd,
    "instance_norm_relu_bwd": instance_norm.instance_norm_relu_bwd,
    "instance_norm_relu_shifted": instance_norm.instance_norm_relu_shifted,
    "instance_norm_relu_shifted_bwd": instance_norm.instance_norm_relu_shifted_bwd,
    "shift_pack": shift_pack.shift_pack,
    "shift_unpack": shift_pack.shift_unpack,
}
# (name, input shape, encoder): 3-D at 32^3 (the DAUNet family and TransBTS
# at 16^3), 2-D at 32^2, the smp-style baselines at 64^2 on resnet18
NETS = [("HDenseFormer_32", (32,) * 3, None), ("HDenseFormer_16", (32,) * 3, None),
        ("HDenseFormer_2D_32", (32, 32), None), ("HDenseFormer_2D_16", (32, 32), None),
        ("hecktor20top1", (32,) * 3, None), ("unet_3d", (16,) * 3, None),
        ("da_unet", (16,) * 3, None), ("se_unet", (16,) * 3, None),
        ("da_se_unet", (16,) * 3, None), ("res_da_se_unet", (16,) * 3, None),
        ("TransBTS", (16,) * 3, None), ("unetr", (32,) * 3, None),
        ("unet", (64, 64), "resnet18"), ("unet++", (64, 64), "resnet18"),
        ("deeplabv3+", (64, 64), "resnet18")]
# the wrappers each model reaches with use_kernels=True
REACHED = {"HDenseFormer_32": {"dense_attention", "instance_norm_relu"},
           "hecktor20top1": {"instance_norm_relu", "shift_pack"},
           "TransBTS": {"shift_pack"}, "unetr": {"instance_norm_relu"}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _replace(monkeypatch, make) -> None:
    """Replace each wrapper, wherever a port module holds it, by ``make(name)``."""
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("hdenseformer_tpu_torch") or mod is None:
            continue
        for attr, value in list(vars(mod).items()):
            for name, wrapper in WRAPPERS.items():
                if value is wrapper:
                    monkeypatch.setattr(mod, attr, make(name))


def _train_once(name, shape, encoder, use_kernels: bool) -> None:
    # depth 4: one dense block of 4 attention layers (2 would build none)
    net = get_net(name, 2, 2, shape, transformer_depth=4, encoder_name=encoder,
                  use_kernels=use_kernels, device="cpu")
    init_weights(net, torch.Generator().manual_seed(0))
    net.train()
    x = torch.randn((2,) + shape + (2,), generator=torch.Generator().manual_seed(1))
    outs = net(x, generator=torch.Generator().manual_seed(2))
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    sum(o.float().square().mean() for o in outs).backward()
    assert all(p.grad is not None for p in net.parameters() if p.requires_grad) or \
        name in ("unet", "unet++", "deeplabv3+")  # their aux head's loss term is absent


@pytest.mark.parametrize("name,shape,encoder", NETS, ids=[n for n, _, _ in NETS])
def test_plain_build_reaches_no_kernel_wrapper(monkeypatch, name, shape, encoder):
    def raiser(wrapper):
        def fail(*args, **kwargs):
            raise AssertionError(f"{name} with use_kernels=False reached {wrapper}")
        return fail

    _replace(monkeypatch, raiser)
    refs = []
    real_ref = shift_pack.shift_pack_ref

    def counted_ref(xp):
        refs.append(xp.shape)
        return real_ref(xp)

    monkeypatch.setattr(sys.modules["hdenseformer_tpu_torch.ops.s2d"], "shift_pack_ref",
                        counted_ref)
    _train_once(name, shape, encoder, use_kernels=False)
    if name == "TransBTS":  # its packed InitConv: the half-shift's plain version
        assert len(refs) == 1


@pytest.mark.parametrize("name", sorted(REACHED))
def test_kernel_build_reaches_its_wrappers(monkeypatch, name):
    seen = set()

    def recorder(wrapper):
        real = WRAPPERS[wrapper]

        def record(*args, **kwargs):
            seen.add(wrapper)
            return real(*args, **kwargs)
        return record

    _replace(monkeypatch, recorder)
    shape = dict((n, s) for n, s, _ in NETS)[name]
    _train_once(name, shape, None, use_kernels=True)
    assert REACHED[name] <= seen, seen
