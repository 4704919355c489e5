"""Rematerialisation of the port's HDenseFormer (``remat``) on the CPU.

Each of JAX's remat values checkpoints JAX's blocks, and a train step with
dropout active gives the loss and gradients of the step without remat,
with the dropout generator left in the same state: the recompute draws the
forward's masks (``checkpoint`` alone would not replay an explicit
generator).
"""
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import REMAT_BLOCKS  # noqa: E402
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
    # Hecktor20Top1 has no remat in JAX, and takes the argument as JAX's get_net does
    assert not hasattr(get_net("hecktor20top1", 2, 2, SIZE, remat=True, device="cpu"), "remat")


def test_inference_runs_no_checkpoint(plain):
    x, _, _ = plain
    net = get_net("HDenseFormer_16", 2, 2, SIZE, transformer_depth=4, remat=True, device="cpu")
    init_weights(net, torch.Generator().manual_seed(0))
    calls = []
    net.block_1_1_left.register_forward_pre_hook(lambda *_: calls.append(1))
    with torch.no_grad():
        out = net(x[:1])
    assert len(calls) == 1 and out[0].shape == (1, *SIZE, 2)
