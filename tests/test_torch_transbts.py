"""The port's TransBTS against the JAX package's, on CPU.

``TransBTSModel`` at embedding 64, 4 heads, hidden 96, 2 layers (the
encoder's widths, 16 to 128, are fixed by the model), 16^3 and 24^3 (a
grid of 2^3 and 3^3 tokens), JAX's weights and non-trivial running
statistics:

- eval forwards in fp32 against JAX's fine grid (``s2d=False``) and its
  default (``s2d=None``: levels 0 and 1 packed), the port run with the same
  ``s2d``, within 1e-5 max|ref| + 1e-5 (the packed path in training and in
  bf16 is tests/test_torch_packed_zoo.py's);
- bf16 against ``s2d=False`` (JAX's packed norms keep bf16 where the fine
  ones return fp32), within 5e-2 max|ref|: each conv's output is rounded to
  bf16 on both sides, and a rounding step (2^-8) carried through the 20
  convs and two attention layers moves the logits by a few percent;
- a training-mode forward with the transformer's dropout off and the
  encoder's channel dropout (0.2, one coin per sample and channel) replayed
  from JAX's draw: logits within the bars of tests/test_torch_daunet.py
  (batch statistics of few values: 3x JAX's own move on an input moved by
  1e-6 where that is more), the running statistics within 1e-5 + 1e-5 |ref|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models import get_net as jax_get_net  # noqa: E402
from hdenseformer_tpu.models import transbts as jtransbts  # noqa: E402
from hdenseformer_tpu_torch.models import get_net, transbts  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_batch_stats, load_jax_params  # noqa: E402
from torch_port_util import random_jax_variables, transbts_channel_keep  # noqa: E402

SMALL = dict(embedding_dim=64, num_heads=4, num_layers=2, hidden_dim=96)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def build(size, dtype=None, s2d=False, rate=0.1):
    jmodel = jtransbts.TransBTSModel(2, 2, size, dropout_rate=rate, attn_dropout_rate=rate,
                                     dtype=None if dtype is None else jnp.bfloat16, s2d=s2d,
                                     **SMALL)
    model = transbts.TransBTSModel(2, 2, size, dropout_rate=rate, attn_dropout_rate=rate,
                                   dtype=dtype, s2d=s2d, device="cpu", **SMALL)
    return jmodel, model


def _pair(size, batch, seed, dtype=None, s2d=False, rate=0.1):
    jmodel, model = build(size, dtype, s2d, rate)
    x = np.random.RandomState(seed).randn(batch, size, size, size, 2).astype(np.float32)
    variables = random_jax_variables(jmodel, jnp.asarray(x), np.random.RandomState(seed + 1))
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return jmodel, model, variables, x


def _close(got, ref, rel=1e-5, spread=0.0):
    ref = np.asarray(ref, np.float32)
    atol = max(rel * float(np.abs(ref).max()) + 1e-5, 3 * spread)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("size,s2d", [(16, False), (24, False), (16, None)],
                         ids=["16_fine", "24_fine", "16_jax_default_packed"])
def test_eval_forward_matches_jax(size, s2d):
    jmodel, model, variables, x = _pair(size, 2, size, s2d=s2d)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, ref)


def test_bf16_eval_forward_matches_jax_fine_grid():
    jmodel, model, variables, x = _pair(16, 2, 7, dtype=torch.bfloat16)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, ref, rel=5e-2)


def test_train_forward_with_the_channel_mask_replayed_matches_jax(monkeypatch):
    jmodel, model, variables, x = _pair(16, 2, 11, rate=0.0)
    key = jax.random.PRNGKey(4)
    keep = transbts_channel_keep(jmodel, variables, jnp.asarray(x), key)
    assert keep.shape == (2, 1, 1, 1, 16) and 0 < keep.mean() < 1

    @jax.jit
    def train(v, x):
        out, new = jmodel.apply(v, x, train=True, mutable=["batch_stats"],
                                rngs={"dropout": key})
        return out, new["batch_stats"]

    ref, stats = jax.device_get(train(variables, jnp.asarray(x)))
    moved = x * (1 + 1e-6 * np.random.RandomState(9).randn(*x.shape)).astype(np.float32)
    spread = float(np.abs(np.asarray(train(variables, jnp.asarray(moved))[0]) - ref).max())
    monkeypatch.setattr(model.Unet, "channel_keep", lambda h, g: torch.from_numpy(keep))
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))
    _close(got, ref, spread=spread)
    buffers = dict(model.named_buffers())
    want = from_jax_batch_stats(stats)
    assert sorted(buffers) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_channel_dropout_draws_a_coin_per_sample_and_channel():
    model = transbts.TransBTSModel(2, 2, 16, device="cpu", **SMALL).train()
    h = torch.ones(64, 4, 4, 4, 16)
    keep = model.Unet.channel_keep(h, torch.Generator().manual_seed(0))
    assert keep.shape == (64, 1, 1, 1, 16) and abs(float(keep.float().mean()) - 0.8) < 0.05
    with pytest.raises(ValueError, match="Generator"):
        model.Unet.channel_keep(h, None)


def test_get_net_builds_jax_configuration():
    """get_net's TransBTS has JAX's parameter tree at embedding 512, 8 heads,
    4 layers, hidden 4096, and its 1/8 token grid (position embeddings)."""
    jmodel = jax_get_net("TransBTS", 2, 2, (16, 16, 16), s2d=False)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 2)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = get_net("TransBTS", 2, 2, (16, 16, 16), device="cpu")
    load_jax_params(model, zeros["params"], zeros["batch_stats"])
    assert model.position_embeddings.shape == (8, 512) and not model.training
