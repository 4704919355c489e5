"""Port layers and HDenseFormer against the JAX modules, same weights.

Random JAX parameters (shaped by tracing the flax ``init``) are carried
into the port by ``weights.from_jax_params``, and both frameworks run the
same numpy inputs in fp32 on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models import layers as jl  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models import layers as tl  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params, load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402


def _jax_layer(module, x, rng):
    params = random_jax_params(module, jnp.asarray(x), rng)
    return params, np.asarray(module.apply({"params": params}, jnp.asarray(x)))


LAYER_CASES = {
    "conv3": (lambda: jl.Conv(6, 3, 1, 1), lambda: tl.Conv(3, 6, 3, 1, 1), (2, 6, 7, 5, 3), ""),
    "patch_embed": (
        lambda: jl.Conv(8, 16, 16, padding=0, as_matmul=True),
        lambda: tl.Conv(1, 8, 16, 16, 0), (2, 32, 32, 16, 1), "",
    ),
    "head_out_f32": (
        lambda: jl.Conv(2, 1, out_f32=True), lambda: tl.Conv(5, 2, 1, out_f32=True),
        (2, 4, 6, 4, 5), "",
    ),
    "conv_transpose": (
        lambda: jl.ConvTranspose(6, 3, 2, 1, 1), lambda: tl.ConvTranspose(4, 6, 3, 2, 1, 1),
        (2, 5, 4, 6, 4), "upconv_1",
    ),
    "dense": (lambda: jl.Dense(7), lambda: tl.Dense(5, 7), (3, 10, 5), ""),
    "instance_norm_affine": (
        lambda: jl.InstanceNorm(affine=True, fuse_relu=True),
        lambda: tl.InstanceNorm(6, affine=True, fuse_relu=True), (2, 5, 6, 7, 6), "",
    ),
    "instance_norm_plain": (
        lambda: jl.InstanceNorm(affine=False, fuse_relu=True),
        lambda: tl.InstanceNorm(6, affine=False, fuse_relu=True), (2, 5, 6, 7, 6), "",
    ),
    "layer_norm": (lambda: jl.LayerNorm(), lambda: tl.LayerNorm(8), (3, 10, 8), ""),
    "basic_conv": (lambda: jl.BasicConv(6), lambda: tl.BasicConv(3, 6), (2, 6, 6, 6, 3), ""),
    "up_conv": (lambda: jl.UpConv(5), lambda: tl.UpConv(3, 5), (2, 4, 4, 4, 3), ""),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(rng, case):
    make_jax, make_port, shape, prefix = LAYER_CASES[case]
    x = rng.randn(*shape).astype(np.float32)
    params, ref = _jax_layer(make_jax(), x, rng)
    port = make_port()
    port.load_state_dict(from_jax_params(params, prefix=prefix), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_gelu_exact_matches_jax(rng):
    x = (rng.randn(1000) * 3).astype(np.float32)
    ref = np.asarray(jl.gelu_exact(jnp.asarray(x)))
    np.testing.assert_allclose(tl.gelu_exact(torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-6)


SIZE, DEPTH, IN_CH, N_CLS = (32, 32, 32), 4, 2, 2


def _jax_model(nf, s2d):
    model = JaxHDenseFormer(in_channels=IN_CH, n_cls=N_CLS, n_filters=nf, image_size=SIZE,
                            transformer_depth=DEPTH, remat=False, s2d=s2d)
    x0 = jnp.zeros((1,) + SIZE + (IN_CH,), jnp.float32)
    return model, random_jax_params(model, x0, np.random.RandomState(0))


@pytest.mark.parametrize("s2d", [False, None], ids=["fine", "default_packed"])
@pytest.mark.parametrize("nf", [4, 8])
def test_hdenseformer_matches_jax(nf, s2d):
    jmodel, params = _jax_model(nf, s2d)
    x = np.random.RandomState(1).randn(2, *SIZE, IN_CH).astype(np.float32)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    port = HDenseFormer(IN_CH, N_CLS, nf, SIZE, DEPTH, device="cpu")
    load_jax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_hdenseformer_bf16_near_fp32():
    _, params = _jax_model(8, False)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, *SIZE, IN_CH).astype(np.float32))
    outs = {}
    for dt in (None, torch.bfloat16):
        port = HDenseFormer(IN_CH, N_CLS, 8, SIZE, DEPTH, dtype=dt, device="cpu")
        load_jax_params(port, params)
        with torch.inference_mode():
            outs[dt] = port(x)
    for lo, hi in zip(outs[torch.bfloat16], outs[None]):
        assert lo.dtype == torch.float32 and torch.isfinite(lo).all()
        torch.testing.assert_close(lo, hi, rtol=0, atol=5e-2)


def test_get_net_builds_hdenseformer_and_names_the_rest():
    net = get_net("HDenseFormer_16", 2, 3, (32, 32, 32), transformer_depth=4, device="cpu")
    assert isinstance(net, HDenseFormer) and not net.training
    assert net.block_1_1_left.conv.weight.shape == (16, 2, 3, 3, 3)
    assert len(net.attns) == 2 and net.head.weight.shape == (3, 16, 1, 1, 1)
    with pytest.raises(ValueError, match="encoder name must not be 'None'"):
        get_net("unet", 1, 2, (96, 96), device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        get_net("nope", 1, 2, (32, 32, 32), device="cpu")


def test_init_weights_is_seeded():
    def build(seed):
        net = HDenseFormer(IN_CH, N_CLS, 4, SIZE, DEPTH, device="cpu")
        return tl.init_weights(net, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = build(0), build(0), build(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["block_1_1_left.conv.weight"], c["block_1_1_left.conv.weight"])
    assert torch.equal(a["attns.0.pos_embed"], torch.zeros_like(a["attns.0.pos_embed"]))
    assert torch.equal(a["block_1_1_left.norm.weight"], torch.ones(4))
