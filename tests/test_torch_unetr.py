"""The port's UNETR against the JAX package's, on CPU.

``UNETR`` at 32^3 (a 2^3 token grid), 12 layers (the skips read layers 3, 6
and 9), hidden 48, 4 heads, mlp 96, feature size 8, JAX's weights:

- eval forwards in fp32 within 1e-5 max|ref| + 1e-5, and in bf16 within
  5e-2 max|ref| (each conv's and matmul's output rounded to bf16 on both
  sides; a rounding step, 2^-8, carried through 12 layers and 9 convs
  moves the logits by a few percent);
- the weight bridge picks a ConvTranspose by the port module's type:
  ``encoder2_up1``, ``encoder2_up2`` and ``encoder3_up1`` have as many
  input as output channels, so a kernel mapped as a plain conv (the rule by
  module name, which knows only ``upconv*``) loads without complaint and
  computes something else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models import get_net as jax_get_net  # noqa: E402
from hdenseformer_tpu.models import unetr as junetr  # noqa: E402
from hdenseformer_tpu_torch.models import get_net, unetr  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params, load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

SIZE = (32, 32, 32)
SMALL = dict(feature_size=8, hidden_size=48, mlp_dim=96, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed, dtype=None):
    jmodel = junetr.UNETR(2, 2, SIZE, dtype=None if dtype is None else jnp.bfloat16, **SMALL)
    model = unetr.UNETR(2, 2, SIZE, dtype=dtype, device="cpu", **SMALL)
    x = np.random.RandomState(seed).randn(2, *SIZE, 2).astype(np.float32)
    params = random_jax_params(jmodel, jnp.asarray(x), np.random.RandomState(seed + 1))
    return jmodel, model, params, x


def _close(got, ref, rel):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()) + 1e-5)


@pytest.mark.parametrize("dtype,rel", [(None, 1e-5), (torch.bfloat16, 5e-2)],
                         ids=["fp32", "bf16"])
def test_eval_forward_matches_jax(dtype, rel):
    jmodel, model, params, x = _pair(0, dtype)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    load_jax_params(model, params)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, ref, rel)


def test_square_transposed_kernels_load_by_module_type():
    jmodel, model, params, x = _pair(3)
    square = ("encoder2_up1", "encoder2_up2", "encoder3_up1")
    by_type = from_jax_params(params, model=model)
    for name in square:
        kernel = np.asarray(params[name]["kernel"])
        assert kernel.shape[-2] == kernel.shape[-1]  # in = out: a conv's layout also fits
        as_conv = kernel.transpose(4, 3, 0, 1, 2)
        assert by_type[f"{name}.weight"].shape == as_conv.shape
        flipped = np.flip(kernel, axis=(0, 1, 2)).transpose(3, 4, 0, 1, 2)
        np.testing.assert_array_equal(by_type[f"{name}.weight"].numpy(), flipped)
        assert not np.array_equal(as_conv, flipped)
        # the upconv* name rule of HDenseFormer and Hecktor refuses it without the model
        with pytest.raises(ValueError, match="pass model="):
            from_jax_params({name: params[name]})
    assert all(getattr(model, name).bias is None for name in square)  # use_bias=False
    load_jax_params(model, params)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x)), ref, 1e-5)


def test_get_net_builds_jax_configuration():
    """get_net's UNETR: hidden 768, mlp 3072, 12 heads, feature size 16."""
    jmodel = jax_get_net("unetr", 2, 2, SIZE)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, *SIZE, 2)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    model = get_net("unetr", 2, 2, SIZE, device="cpu")
    load_jax_params(model, zeros)
    assert model.pos_embed.shape == (8, 768) and not model.training


def test_pos_embed_init_is_truncated_normal():
    from hdenseformer_tpu_torch.models.layers import init_weights

    model = unetr.UNETR(2, 2, (64, 64, 64), device="cpu", **SMALL)
    init_weights(model, torch.Generator().manual_seed(0))
    pos = model.pos_embed.detach()
    assert float(pos.abs().max()) <= 0.04 and 0.015 < float(pos.std()) < 0.02
