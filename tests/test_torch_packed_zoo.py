"""The DAUNet family's and TransBTS's packed levels against the JAX package's.

JAX's default ``s2d=None`` packs the DAUNet family's level 0 (not the
residual builder, which ``s2d=True`` forces) and TransBTS's levels 0 and 1,
at full rank. The models run at the widths of tests/test_torch_daunet.py and
tests/test_torch_transbts.py, with random JAX parameters and running
statistics of the packed JAX model (the weight bridge on a packed tree:
its names are the fine model's) and inputs made from a numpy seed.

- fp32, eval and training mode (a train step's forward: the running
  statistics it writes against JAX's ``batch_stats``), the bars of
  tests/test_torch_daunet.py: logits within 1e-5 max|ref| + 1e-5 (training:
  or 3x JAX's own move on an input moved by 1e-6), running statistics within
  1e-5 + 1e-5 |ref|;
- bf16 against JAX's packed bf16 path (its packed norms keep bf16 where the
  fine ones return fp32, and the port's do too): within 5e-2 max|ref|, the
  bar of the fine bf16 tests;
- TransBTS with the dict ``{0: (1, 2), 1: True}``: level 0 packed over
  (H, W), whose skip the fine decoder reads unpacked. JAX's model runs a
  dict as ``s2d=True`` (it tests ``isinstance(s2d, dict)``, which flax's
  frozen attribute fails), the same function in another layout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models import daunet as jdaunet  # noqa: E402
from hdenseformer_tpu.models import transbts as jtransbts  # noqa: E402
from hdenseformer_tpu_torch.models import daunet, transbts  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_batch_stats, load_jax_params  # noqa: E402
from torch_port_util import random_jax_variables, transbts_channel_keep  # noqa: E402

WIDTH = (16, 32, 64, 128, 256)
SMALL = dict(embedding_dim=64, num_heads=4, num_layers=2, hidden_dim=96)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rel=1e-5, spread=0.0):
    ref = np.asarray(ref, np.float32)
    atol = max(rel * float(np.abs(ref).max()) + 1e-5, 3 * spread)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0, atol=atol)


def _stats_close(model, stats):
    buffers = dict(model.named_buffers())
    want = from_jax_batch_stats(stats)
    assert sorted(buffers) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(buffers[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def _jax_train(jmodel, variables, x, **kw):
    """JAX's training-mode logits and batch_stats, and the logits' largest
    move when x moves by 1e-6 (relative)."""

    @jax.jit
    def run(v, x):
        out, new = jmodel.apply(v, x, train=True, mutable=["batch_stats"], **kw)
        return out, new["batch_stats"]

    ref, stats = jax.device_get(run(variables, jnp.asarray(x)))
    moved = x * (1 + 1e-6 * np.random.RandomState(9).randn(*x.shape)).astype(np.float32)
    spread = float(np.abs(np.asarray(run(variables, jnp.asarray(moved))[0]) - ref).max())
    return ref, stats, spread


def _daunet(name, s2d, dtype=None, seed=0):
    builder = "plain" if name == "unet_3d" else name[:-len("_unet")]
    depths = tuple(16 // 2 ** k for k in range(5))
    jmodel = jdaunet.DAUNet(n_classes=2, width=WIDTH, depths=depths, conv_builder=builder,
                            dropout_flag=False, s2d=s2d,
                            dtype=None if dtype is None else jnp.bfloat16)
    model = daunet.DAUNet(2, 2, width=WIDTH, depths=depths, conv_builder=builder,
                          dropout_flag=False, dtype=dtype, s2d=s2d, device="cpu")
    x = np.random.RandomState(seed + 1).randn(2, 16, 16, 16, 2).astype(np.float32)
    variables = random_jax_variables(jmodel, jnp.asarray(x), np.random.RandomState(seed))
    load_jax_params(model, variables["params"], variables["batch_stats"])
    assert model.packs(torch.from_numpy(x))
    return jmodel, model, variables, x


@pytest.mark.parametrize("name,s2d", [("unet_3d", None), ("se_unet", None),
                                      ("da_se_unet", None), ("res_da_se_unet", True)])
def test_daunet_packed_level0_eval_and_train_step_match_jax(name, s2d):
    jmodel, model, variables, x = _daunet(name, s2d)
    ref_eval = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    ref_train, stats, spread = _jax_train(jmodel, variables, x)
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x)), ref_eval)
        _close(model.train()(torch.from_numpy(x)), ref_train, spread=spread)
    _stats_close(model, stats)


def test_daunet_packed_bf16_matches_jax_packed():
    jmodel, model, variables, x = _daunet("da_unet", None, torch.bfloat16, seed=4)
    ref_eval = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    ref_train, _, _ = _jax_train(jmodel, variables, x)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        assert got.dtype == torch.float32
        _close(got, ref_eval, rel=5e-2)
        _close(model.train()(torch.from_numpy(x)), ref_train, rel=5e-2)


def test_daunet_packed_equals_fine_with_gradients():
    """The same weights and batch, packed and fine: logits, every gradient
    and the running statistics a train step writes. The biases of the convs
    that a BatchNorm normalises in training have a true gradient of zero
    (what either returns is rounding noise) and are left out."""
    _, packed, variables, x = _daunet("da_unet", None, seed=6)
    fine = daunet.DAUNet(2, 2, width=WIDTH, depths=(16, 8, 4, 2, 1), conv_builder="da",
                         dropout_flag=False, s2d=False, device="cpu")
    load_jax_params(fine, variables["params"], variables["batch_stats"])
    runs = []
    for model in (packed, fine):
        out = model.train()(torch.from_numpy(x))
        (out * torch.rand(out.shape, generator=torch.Generator().manual_seed(0))).sum().backward()
        runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters()},
                     dict(model.named_buffers())))
    (a, ga, ba), (b, gb, bb) = runs
    torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
    for n in gb:
        if n.endswith(("conv1.bias", "conv2.bias")):
            continue
        torch.testing.assert_close(ga[n], gb[n], rtol=0, atol=1e-3 * float(gb[n].abs().max()),
                                   msg=n)
    for n in bb:
        torch.testing.assert_close(ba[n], bb[n], rtol=1e-5, atol=1e-5, msg=n)


def _transbts(s2d, dtype=None, seed=11, rate=0.0):
    jmodel = jtransbts.TransBTSModel(2, 2, 16, dropout_rate=rate, attn_dropout_rate=rate,
                                     dtype=None if dtype is None else jnp.bfloat16, s2d=s2d,
                                     **SMALL)
    model = transbts.TransBTSModel(2, 2, 16, dropout_rate=rate, attn_dropout_rate=rate,
                                   dtype=dtype, s2d=s2d, device="cpu", **SMALL)
    x = np.random.RandomState(seed).randn(2, 16, 16, 16, 2).astype(np.float32)
    variables = random_jax_variables(jmodel, jnp.asarray(x), np.random.RandomState(seed + 1))
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return jmodel, model, variables, x


@pytest.mark.parametrize("s2d", [None, {0: (1, 2), 1: True}], ids=["default", "dict_hw"])
def test_transbts_packed_train_step_matches_jax(monkeypatch, s2d):
    jmodel, model, variables, x = _transbts(s2d)
    assert model.packed == ((0, 1, 2), (0, 1, 2)) if s2d is None else ((1, 2), (0, 1, 2))
    key = jax.random.PRNGKey(4)
    # read off JAX's packed EnBlock1 input: one coin a channel, tiled over the
    # parity blocks; the port draws the (N, 1, 1, 1, 16) coins and tiles them
    keep = transbts_channel_keep(jmodel, variables, jnp.asarray(x), key)
    blocks = keep.reshape(keep.shape[:-1] + (-1, 16))
    assert (blocks == blocks[..., :1, :]).all()
    keep = np.ascontiguousarray(blocks[..., 0, :])
    ref_eval = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    ref_train, stats, spread = _jax_train(jmodel, variables, x, rngs={"dropout": key})
    monkeypatch.setattr(model.Unet, "channel_keep", lambda h, g: torch.from_numpy(keep))
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x)), ref_eval)
        _close(model.train()(torch.from_numpy(x)), ref_train, spread=spread)
    _stats_close(model, stats)


def test_transbts_packed_bf16_matches_jax_packed():
    jmodel, model, variables, x = _transbts(None, torch.bfloat16, seed=7)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, ref, rel=5e-2)


def test_transbts_packed_channel_dropout_tiles_one_coin_per_channel():
    model = transbts.TransBTSModel(2, 2, 16, device="cpu", **SMALL).train()
    assert model.packed == ((0, 1, 2), (0, 1, 2))
    keep = model.Unet.channel_keep(torch.ones(2, 8, 8, 8, 128), torch.Generator().manual_seed(0))
    assert keep.shape == (2, 1, 1, 1, 16)
    with pytest.raises(ValueError, match="would pack"):
        model(torch.zeros(1, 18, 18, 18, 2))
