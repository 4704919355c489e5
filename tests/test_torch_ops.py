"""Port ops against the JAX package's: attention, InstanceNorm+ReLU, resize.

The same numpy inputs go through the JAX function and its port; the kernel
wrappers are exercised on CPU tensors, where they take the plain versions
(the CUDA kernels themselves are checked in tests/test_torch_cuda.py and
chip_smoke.py).
"""
import numpy as np
import pytest

# torch before jax's first use in this process, as tests/test_hdenseformer.py
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.ops.dense_attention import (  # noqa: E402
    fused_dense_attention,
    xla_attention,
)
from hdenseformer_tpu.ops.instance_norm import (  # noqa: E402
    fused_instance_norm_relu,
    xla_instance_norm_relu,
)
from hdenseformer_tpu.ops import resize as jresize  # noqa: E402
from hdenseformer_tpu_torch.ops import resize as tresize  # noqa: E402
from hdenseformer_tpu_torch.ops.dense_attention import (  # noqa: E402
    attention_ref,
    dense_attention,
)
from hdenseformer_tpu_torch.ops.instance_norm import (  # noqa: E402
    instance_norm_relu,
    instance_norm_relu_ref,
)


def _qkv(rng, shape):
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,d", [(729, 4), (64, 4), (100, 8)])
def test_attention_ref_matches_xla(rng, n, d):
    q, k, v = _qkv(rng, (2, 8, n, d))
    ref = np.asarray(xla_attention(*map(jnp.asarray, (q, k, v))))
    got = attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_attention_ref_matches_pallas_interpret(rng):
    # the ragged tail: 130 tokens, which the Pallas kernel pads to 256
    q, k, v = _qkv(rng, (1, 2, 130, 4))
    ref = np.asarray(fused_dense_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    got = attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _norm_inputs(rng, n, s, c):
    x = (rng.randn(n, s, c) * 3 + 1).astype(np.float32)
    scale = rng.rand(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,s,c", [(2, 1000, 32), (1, 300, 16), (2, 512, 64)])
def test_instance_norm_ref_matches_xla(rng, n, s, c, affine):
    x, scale, bias = _norm_inputs(rng, n, s, c)
    if not affine:
        scale = bias = None
    ref = np.asarray(xla_instance_norm_relu(
        jnp.asarray(x),
        None if scale is None else jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias),
    ))
    got = instance_norm_relu_ref(
        torch.from_numpy(x),
        None if scale is None else torch.from_numpy(scale),
        None if bias is None else torch.from_numpy(bias),
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,s,c,bs", [(2, 1000, 32, 256), (1, 300, 16, 128), (2, 512, 64, 512)])
def test_instance_norm_ref_matches_pallas_interpret(rng, n, s, c, bs):
    # 2e-4 as tests/test_pallas.py: the Pallas kernel's variance is one-pass
    x, scale, bias = _norm_inputs(rng, n, s, c)
    ref = np.asarray(fused_instance_norm_relu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), block_s=bs, interpret=True
    ))
    got = instance_norm_relu_ref(*map(torch.from_numpy, (x, scale, bias))).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_instance_norm_ref_relu_off_and_bf16(rng):
    x, scale, bias = _norm_inputs(rng, 2, 6 * 7 * 5, 8)
    x5 = x.reshape(2, 6, 7, 5, 8)
    ref = np.asarray(xla_instance_norm_relu(
        jnp.asarray(x5), jnp.asarray(scale), jnp.asarray(bias), relu=False
    ))
    got = instance_norm_relu_ref(
        *map(torch.from_numpy, (x5, scale, bias)), relu=False
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    out = instance_norm_relu_ref(torch.from_numpy(x5).bfloat16(), relu=True)
    assert out.dtype == torch.bfloat16 and out.shape == x5.shape


@pytest.mark.parametrize("shape", [(2, 4, 5, 6, 3), (1, 9, 9, 9, 8)])
def test_upsample_linear_matches_jax(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    ref = np.asarray(jresize.upsample_linear(jnp.asarray(x), 2))
    got = tresize.upsample_linear(torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 6, 8, 4, 3), (1, 7, 5, 9, 4)])
def test_max_pool_matches_jax(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    ref = np.asarray(jresize.max_pool(jnp.asarray(x)))
    got = tresize.max_pool(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [(9, 9, 9), (4, 5, 3), (12, 9, 6)])
def test_resize_nearest_matches_jax(rng, size):
    x = rng.randn(2, 9, 10, 6, 3).astype(np.float32)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), size))
    got = tresize.resize_nearest(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrappers_take_plain_versions_on_cpu(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (2, 8, 50, 4)))
    x, scale, bias = map(torch.from_numpy, _norm_inputs(rng, 2, 100, 16))
    a0, n0 = dense_attention.launches, instance_norm_relu.launches
    torch.testing.assert_close(dense_attention(q, k, v), attention_ref(q, k, v),
                               rtol=0, atol=0)
    torch.testing.assert_close(instance_norm_relu(x, scale, bias),
                               instance_norm_relu_ref(x, scale, bias), rtol=0, atol=0)
    # a CPU call never counts as a kernel launch
    assert (dense_attention.launches, instance_norm_relu.launches) == (a0, n0)


def test_wrappers_raise_off_cpu_and_cuda():
    q = torch.empty(1, 2, 10, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dense_attention(q, q, q)
    x = torch.empty(1, 10, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        instance_norm_relu(x)
