"""The port's DAUNet family against the JAX package's, on CPU.

All five names (``unet_3d``, ``da_unet``, ``se_unet``, ``da_se_unet``,
``res_da_se_unet``) at widths (16, 32, 64, 128, 256), with JAX's weights
(``weights.load_jax_params``) and non-trivial running statistics, in eval
mode and in training mode (the logits and the ``batch_stats`` JAX's
``mutable`` apply returns against the port's buffers), dropout off:

- 20^3 at batch 1: the decoder's pad path (20 -> 10 -> 5 -> 2 -> 1, so the
  upsampled 2 and 4 are padded to 5 and 10) and the m = 1 bottleneck (one
  value a channel at 1^3);
- 16^3 at batch 2;
- ``da_unet`` at 20^3 built for depth 32: DepthAttention pools its depth
  bins up and back (``_adaptive_avg_depth``).

Bars: fp32 logits within 1e-5 max|ref| + 1e-5, running statistics within
1e-5 + 1e-5 |ref|. In training mode the batch statistics of a small grid
(8 or 2 values a channel at the bottom levels) amplify fp32 rounding, and
JAX's variance, E[x^2] - E[x]^2, loses more to it than the port's centred
one (unet_3d at 16^3, batch 2, against a float64 run: JAX's logits 1.6e-4
off, the port's 2.0e-5): the training logits are held to the larger of that
bar and 3x JAX's own difference on the input moved by 1e-6 (relative).

Both frameworks run the same ``s2d``: the fine grid (``s2d=False``) in the
cases above; JAX's default ``s2d=None`` (level 0 packed at 16^3) against the
port's default, in fp32 to the same bars. In bf16 the port is held against
``s2d=False`` (JAX's packed BatchNorm keeps bf16 where the fine one returns
fp32): both round each conv's output to bf16, and a rounding step there
(2^-8) carried through the network's nine double convs moves the logits by
a few percent of their scale: within 5e-2 max|ref|. The packed path in
bf16, the weight bridge of a packed tree and the running statistics after
a packed train step are tests/test_torch_packed_zoo.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models import daunet as jdaunet  # noqa: E402
from hdenseformer_tpu.models import get_net as jax_get_net  # noqa: E402
from hdenseformer_tpu_torch.models import daunet, get_net  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_batch_stats, load_jax_params  # noqa: E402
from torch_port_util import random_jax_variables  # noqa: E402

WIDTH = (16, 32, 64, 128, 256)
NAMES = ("unet_3d", "da_unet", "se_unet", "da_se_unet", "res_da_se_unet")
CASES = {"20cube_b1": (20, 1, 20), "16cube_b2": (16, 2, 16)}  # size, batch, init depth


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def build(name, init_depth, dtype=None, s2d=False):
    """The JAX model and the port's, at WIDTH, dropout off."""
    depths = tuple(init_depth // 2 ** k for k in range(5))
    builder = "plain" if name == "unet_3d" else name[:-len("_unet")]
    jax_dtype = None if dtype is None else jnp.bfloat16
    jmodel = jdaunet.DAUNet(n_classes=2, width=WIDTH, depths=depths, conv_builder=builder,
                            dropout_flag=False, dtype=jax_dtype, s2d=s2d)
    model = daunet.DAUNet(2, 2, width=WIDTH, depths=depths, conv_builder=builder,
                          dropout_flag=False, dtype=dtype, s2d=s2d, device="cpu")
    return jmodel, model


def _image(size, batch, seed=1):
    return np.random.RandomState(seed).randn(batch, size, size, size, 2).astype(np.float32)


def jax_eval_and_train(jmodel, variables, x):
    """JAX's eval logits, train logits and the train step's batch_stats, and
    its train logits' largest move when x moves by 1e-6 (relative)."""

    @jax.jit
    def run(v, x):
        train, new = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        return jmodel.apply(v, x), train, new["batch_stats"]

    ref_eval, ref_train, stats = jax.device_get(run(variables, jnp.asarray(x)))
    moved = x * (1 + 1e-6 * np.random.RandomState(9).randn(*x.shape)).astype(np.float32)
    _, moved_train, _ = jax.device_get(run(variables, jnp.asarray(moved)))
    spread = float(np.abs(np.asarray(moved_train, np.float32)
                          - np.asarray(ref_train, np.float32)).max())
    return ref_eval, ref_train, stats, spread


def assert_logits_close(got, ref, rel=1e-5, spread=0.0):
    ref = np.asarray(ref, np.float32)
    atol = max(rel * float(np.abs(ref).max()) + 1e-5, 3 * spread)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0, atol=atol)


def _check(name, size, batch, init_depth):
    jmodel, model = build(name, init_depth)
    x = _image(size, batch)
    variables = random_jax_variables(jmodel, jnp.asarray(x), np.random.RandomState(0))
    ref_eval, ref_train, ref_stats, spread = jax_eval_and_train(jmodel, variables, x)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        got_train = model.train()(torch.from_numpy(x))
    assert got_eval.dtype == torch.float32 and tuple(got_eval.shape) == x.shape
    assert_logits_close(got_eval, ref_eval)
    assert_logits_close(got_train, ref_train, spread=spread)
    buffers = dict(model.named_buffers())
    want = from_jax_batch_stats(ref_stats)
    assert sorted(buffers) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(buffers[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", NAMES)
def test_daunet_eval_and_train_match_jax(name, case):
    _check(name, *CASES[case])


def test_depth_attention_pools_its_depth_bins_as_jax():
    _check("da_unet", 20, 1, 32)


def test_fp32_matches_jax_default_packed_level0():
    """JAX's default packs level 0 at 16^3 (width 16, not residual, even
    dims), and so does the port's."""
    jmodel, model = build("da_unet", 16, s2d=None)
    x = _image(16, 2, seed=2)
    assert model.packs(torch.from_numpy(x))
    variables = random_jax_variables(jmodel, jnp.asarray(x), np.random.RandomState(3))
    ref_eval, ref_train, ref_stats, spread = jax_eval_and_train(jmodel, variables, x)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        assert_logits_close(model.eval()(torch.from_numpy(x)), ref_eval)
        assert_logits_close(model.train()(torch.from_numpy(x)), ref_train, spread=spread)
    for key, value in from_jax_batch_stats(ref_stats).items():
        np.testing.assert_allclose(dict(model.named_buffers())[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_bf16_matches_jax_fine_grid():
    jmodel, model = build("da_se_unet", 16, dtype=torch.bfloat16)
    x = _image(16, 2, seed=4)
    variables = random_jax_variables(jmodel, jnp.asarray(x), np.random.RandomState(5))
    ref_eval, ref_train, _, _ = jax_eval_and_train(jmodel, variables, x)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        got_train = model.train()(torch.from_numpy(x))
    assert got_eval.dtype == torch.float32
    assert_logits_close(got_eval, ref_eval, rel=5e-2)
    assert_logits_close(got_train, ref_train, rel=5e-2)


def test_get_net_builds_jax_configuration():
    """get_net's knobs are JAX's: the same parameter tree and buffers
    (``init_depth = input_shape[0]``; ``unet_3d`` is the plain builder)."""
    for name in NAMES:
        jmodel = jax_get_net(name, 2, 2, (16, 16, 16), s2d=False)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 16, 2)))
        params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                        shapes["params"])
        stats = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                       shapes["batch_stats"])
        model = get_net(name, 2, 2, (16, 16, 16), device="cpu")
        load_jax_params(model, params, stats)  # strict: every name and shape
        assert not model.training


def test_s2d_true_at_odd_dims_raises_as_jax():
    for name in NAMES:
        with pytest.raises(ValueError, match="even spatial dims"):
            jax_get_net(name, 2, 2, (20, 20, 21), s2d=True)
        with pytest.raises(ValueError, match="even spatial dims"):
            get_net(name, 2, 2, (20, 20, 21), s2d=True, device="cpu")
        # s2d=None: the fine grid at odd dims; level 0 packed at even ones,
        # except for the residual builder, as JAX's rule
        assert not get_net(name, 2, 2, (20, 20, 21), device="cpu").packs(
            torch.zeros(1, 20, 20, 21, 2))
        net = get_net(name, 2, 2, (20, 20, 20), device="cpu")
        assert net.packs(torch.zeros(1, 20, 20, 20, 2)) == (name != "res_da_se_unet")
