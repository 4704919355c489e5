"""Rematerialisation of the port's models (``remat``) on the CPU.

HDenseFormer: each of JAX's remat values checkpoints JAX's blocks, and a
train step with dropout active gives the loss and gradients of the step
without remat, with the dropout generator left in the same state: the
recompute draws the forward's masks (``checkpoint`` alone would not replay
an explicit generator).

Hecktor20Top1: ``remat=True`` checkpoints the blocks JAX's ``nn.remat``
wraps (what its ``res`` and ``sen`` helpers build), packed and fine, and a
train step gives the loss and gradients of the step without remat.
"""
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import REMAT_BLOCKS  # noqa: E402
from hdenseformer_tpu_torch.models.hecktor20top1 import Hecktor20Top1  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402

SIZE = (32, 32, 32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's cores,
    and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _step(remat, x, label, seed=3):
    """Loss, gradients, the generator's state after, and how often each
    block ran, of one forward and backward in training with dropout 0.5."""
    net = get_net("HDenseFormer_16", 2, 2, SIZE, transformer_depth=4, remat=remat,
                  device="cpu").train()
    init_weights(net, torch.Generator().manual_seed(0))
    calls = {}
    for name, module in net.named_children():  # a pre-hook: a recompute may stop early
        module.register_forward_pre_hook(
            lambda *_, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    gen = torch.Generator().manual_seed(seed)
    loss = get_loss("FocalLoss", use_ds=True)(net(x, generator=gen), label)
    loss.backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    return float(loss.detach()), grads, gen.get_state(), calls


@pytest.fixture(scope="module")
def plain():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, *SIZE, 2, generator=g)
    label = torch.zeros(2, *SIZE, 2)
    label[..., 0] = 1
    label[:, 8:20, 10:22, 6:18] = torch.tensor([0.0, 1.0])
    return x, label, _step(False, x, label)


@pytest.mark.parametrize("remat", [True, "encoder", "levels"])
def test_remat_step_equals_the_plain_step_with_dropout(plain, remat):
    x, label, (loss0, grads0, state0, calls0) = plain
    loss, grads, state, calls = _step(remat, x, label)
    assert torch.equal(state, state0)  # the generator drew the same numbers, once
    assert loss == pytest.approx(loss0, rel=1e-6, abs=0)
    top = max(float(g.abs().max()) for g in grads0.values())
    for name, g in grads0.items():
        assert float((grads[name] - g).abs().max()) <= 1e-6 * top, name
    # each checkpointed block ran twice (forward and recompute), the rest once
    blocks = REMAT_BLOCKS[remat]
    assert set(calls) == set(calls0)
    for name, n in calls.items():
        assert n == calls0[name] * (2 if name in blocks else 1), (name, n)


def test_remat_blocks_are_jax_choices():
    assert REMAT_BLOCKS[False] == frozenset()
    assert REMAT_BLOCKS["encoder"] < REMAT_BLOCKS[True]
    assert "attns" in REMAT_BLOCKS["encoder"] and "attns" not in REMAT_BLOCKS["levels"]
    assert "block_4_1_left" in REMAT_BLOCKS["encoder"]
    assert "upconv_3" in REMAT_BLOCKS[True] and "upconv_3" not in REMAT_BLOCKS["levels"]
    assert {"block_1_1_right", "block_2_2_left", "upconv_2"} <= REMAT_BLOCKS["levels"]
    assert not {"block_3_1_left", "deep_conv"} & REMAT_BLOCKS["levels"]


def test_get_net_honours_remat_and_rejects_others():
    for remat in (True, "encoder", "levels", False, None):
        net = get_net("HDenseFormer_32", 2, 2, SIZE, transformer_depth=4, remat=remat,
                      device="cpu")
        assert net.remat == (remat if remat is not None else False)
    with pytest.raises(ValueError, match="remat"):
        get_net("HDenseFormer_32", 2, 2, SIZE, transformer_depth=4, remat="all", device="cpu")
    # Hecktor20Top1 takes bool(remat), as JAX's get_net passes it
    for remat, want in ((True, True), ("levels", True), (False, False), (None, False)):
        assert get_net("hecktor20top1", 2, 2, SIZE, remat=remat, device="cpu").remat is want


def test_inference_runs_no_checkpoint(plain):
    x, _, _ = plain
    net = get_net("HDenseFormer_16", 2, 2, SIZE, transformer_depth=4, remat=True, device="cpu")
    init_weights(net, torch.Generator().manual_seed(0))
    calls = []
    net.block_1_1_left.register_forward_pre_hook(lambda *_: calls.append(1))
    with torch.no_grad():
        out = net(x[:1])
    assert len(calls) == 1 and out[0].shape == (1, *SIZE, 2)


# Hecktor20Top1: what JAX's Res and Sen build (hecktor20top1.py's res() and
# sen() calls), and nothing else: not the vision heads, transposed convs or head
HECKTOR_BLOCKS = frozenset(
    {"block_1_1_left", "block_1_2_left"}
    | {f"block_{lvl}_{i}_left" for lvl in (2, 3, 4, 5) for i in (1, 2, 3)}
    | {f"block_{lvl}_{i}_right" for lvl in (1, 2, 3, 4) for i in (1, 2)})
HECKTOR_SIZE, HECKTOR_NF = (16, 16, 16), 8


@pytest.mark.parametrize("s2d", [None, False])
@pytest.mark.parametrize("remat", [True, False])
def test_get_net_checkpoints_hecktor_blocks_as_jax(remat, s2d):
    net = get_net("hecktor20top1", 2, 2, HECKTOR_SIZE, remat=remat, s2d=s2d, device="cpu")
    assert net.packed is (s2d is None)
    assert net.remat_blocks == (HECKTOR_BLOCKS if remat else frozenset())
    assert HECKTOR_BLOCKS <= {name for name, _ in net.named_children()}


def _hecktor_step(remat, s2d, x, label):
    """Loss, gradients and how often each child ran, of one forward and
    backward of Hecktor20Top1 (nf 8) in training."""
    net = Hecktor20Top1(2, 2, HECKTOR_NF, HECKTOR_SIZE, s2d=s2d, remat=remat,
                        device="cpu").train()
    init_weights(net, torch.Generator().manual_seed(0))
    calls = {}
    for name, module in net.named_children():
        module.register_forward_pre_hook(
            lambda *_, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    loss = get_loss("FocalLoss")(net(x, generator=torch.Generator().manual_seed(2)), label)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in net.named_parameters()}, calls


@pytest.fixture(scope="module")
def hecktor_batch():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, *HECKTOR_SIZE, 2, generator=g)
    label = torch.zeros(2, *HECKTOR_SIZE, 2)
    label[..., 0] = 1
    label[:, 4:10, 5:12, 3:9] = torch.tensor([0.0, 1.0])
    return x, label


@pytest.mark.parametrize("s2d", [None, False], ids=["packed", "fine"])
def test_hecktor_remat_step_equals_the_plain_step(hecktor_batch, s2d):
    x, label = hecktor_batch
    loss0, grads0, calls0 = _hecktor_step(False, s2d, x, label)
    loss, grads, calls = _hecktor_step(True, s2d, x, label)
    assert loss == pytest.approx(loss0, rel=1e-6, abs=0)
    assert set(grads) == set(grads0)
    for name, g in grads0.items():
        assert g is not None and grads[name] is not None, name
        assert float((grads[name] - g).abs().max()) <= 1e-6 * float(g.abs().max()), name
    # each checkpointed block ran twice (forward and recompute), the rest once
    assert set(calls) == set(calls0)
    for name, n in calls.items():
        assert n == calls0[name] * (2 if name in HECKTOR_BLOCKS else 1), (name, n)
