"""Gradients of the port's kernel ops and resizes against JAX, on CPU.

The same seeded numpy inputs and cotangents go through ``jax.vjp`` of the
JAX function and through autograd of its port, in fp32. On CPU tensors the
port's autograd functions take their plain versions: InstanceNorm+ReLU's
backward is ``instance_norm_relu_bwd_ref`` (the port of
``fused_norm._bwd_rule``), attention's recomputes ``attention_ref``. The
CUDA kernels behind the same functions are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

# torch before jax's first use in this process, as tests/test_hdenseformer.py
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.ops import fused_norm  # noqa: E402
from hdenseformer_tpu.ops import resize as jresize  # noqa: E402
from hdenseformer_tpu.ops.dense_attention import xla_attention  # noqa: E402
from hdenseformer_tpu_torch.models.layers import InstanceNorm  # noqa: E402
from hdenseformer_tpu_torch.ops import resize as tresize  # noqa: E402
from hdenseformer_tpu_torch.ops.dense_attention import dense_attention  # noqa: E402
from hdenseformer_tpu_torch.ops.instance_norm import (  # noqa: E402
    instance_norm_relu,
    instance_norm_relu_bwd,
    instance_norm_relu_fwd,
)

NORM_ATOL = 2e-4  # JAX's own bar for fused_norm's VJP (tests/test_fused_norm.py)


def _leaves(*arrays):
    return [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrays]


def _jax_norm_vjp(x, scale, bias, relu, dy, parity=1):
    def fn(*args):
        s, b = (args[1], args[2]) if scale is not None else (None, None)
        return fused_norm.instance_norm_relu(args[0], s, b, 1e-5, relu, parity)

    primals = [jnp.asarray(x)] + ([jnp.asarray(scale), jnp.asarray(bias)] if scale is not None
                                  else [])
    y, vjp = jax.vjp(fn, *primals)
    grads = vjp(jnp.asarray(dy))
    return np.asarray(y), [np.asarray(g) for g in grads]


def _norm_case(seed, shape, affine, ties=False):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape) * 3 + 1
    if ties:
        # post-ReLU activations on a coarse grid: runs of exact zeros and repeats
        x = np.maximum(np.round(rng.randn(*shape) * 4) / 4, 0.0)
    scale = bias = None
    if affine:
        scale = (1 + 0.3 * rng.randn(c)).astype(np.float32)
        scale[0], scale[-1] = -0.7, 0.0  # the g < 0 and g == 0 branches of the mask
        bias = (0.3 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x.astype(np.float32), scale, bias, dy


@pytest.mark.parametrize("c", [6, 32])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
def test_instance_norm_grads_match_jax(affine, relu, c):
    x, scale, bias, dy = _norm_case(10 + c, (2, 5, 6, 7, c), affine)
    y_ref, grads_ref = _jax_norm_vjp(x, scale, bias, relu, dy)
    xt, st, bt = _leaves(x, scale, bias)
    y = instance_norm_relu(xt, st, bt, 1e-5, relu)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=1e-5)
    got = [t.grad.numpy() for t in (xt, st, bt) if t is not None]
    assert len(got) == len(grads_ref)
    for g, r in zip(got, grads_ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=NORM_ATOL)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
def test_instance_norm_grads_on_post_relu_ties(affine):
    x, scale, bias, dy = _norm_case(3, (2, 6, 6, 6, 8), affine, ties=True)
    _, grads_ref = _jax_norm_vjp(x, scale, bias, True, dy)
    xt, st, bt = _leaves(x, scale, bias)
    instance_norm_relu(xt, st, bt).backward(torch.from_numpy(dy))
    got = [t.grad.numpy() for t in (xt, st, bt) if t is not None]
    for g, r in zip(got, grads_ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=NORM_ATOL)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_packed_instance_norm_grads_match_parity_8(relu):
    # Hecktor's packed InstanceNorm: the plain function on the parity-pooled
    # view, against JAX's parity=8 statistics pooled over the parity blocks
    c = 6
    x, scale, bias, dy = _norm_case(4, (2, 4, 4, 4, 8 * c), False)
    _, (dx_ref,) = _jax_norm_vjp(x, None, None, relu, dy, parity=8)
    layer = InstanceNorm(c, affine=False, fuse_relu=relu, packed=True, device="cpu")
    (xt,) = _leaves(x)
    layer(xt).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), dx_ref, rtol=0, atol=NORM_ATOL)


def test_instance_norm_backward_wrapper_takes_the_plain_version_on_cpu():
    x, scale, bias, dy = _norm_case(5, (2, 40, 8), True)
    xt, st, bt = _leaves(x, scale, bias)
    instance_norm_relu(xt, st, bt).backward(torch.from_numpy(dy))
    _, stats = instance_norm_relu_fwd(*map(torch.from_numpy, (x, scale, bias)))
    instance_norm_relu_bwd.launches = 0
    dx, dscale, dbias = instance_norm_relu_bwd(*map(torch.from_numpy, (dy, x)), stats,
                                               *map(torch.from_numpy, (scale, bias)))
    assert instance_norm_relu_bwd.launches == 0  # no kernel on the CPU
    for got, ref in ((dx, xt.grad), (dscale, st.grad), (dbias, bt.grad)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,d", [(729, 4), (50, 8)])
def test_attention_grads_match_jax(n, d):
    rng = np.random.RandomState(n)
    q, k, v, dout = (rng.randn(2, 8, n, d).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(xla_attention, *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(dout))
    leaves = _leaves(q, k, v)
    dense_attention(*leaves).backward(torch.from_numpy(dout))
    for t, r in zip(leaves, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_attention_grads_through_the_qkv_split():
    # the model's layout: head views of one projection, gradients summed back
    rng = np.random.RandomState(1)
    qkv, dout = rng.randn(2, 30, 96).astype(np.float32), rng.randn(2, 8, 30, 4).astype(np.float32)

    def heads(t):
        return t.reshape(2, 30, 8, 4).transpose(0, 2, 1, 3)

    def jfn(a):
        return xla_attention(*(heads(t) for t in jnp.split(a, 3, axis=-1)))

    _, vjp = jax.vjp(jfn, jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(dout))
    (qt,) = _leaves(qkv)
    views = [t.view(2, 30, 8, 4).transpose(1, 2) for t in qt.split(32, dim=-1)]
    dense_attention(*views).backward(torch.from_numpy(dout))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _tied(rng, shape):
    """Post-ReLU values on a coarse grid: many exact ties in every window."""
    return np.maximum(np.round(rng.randn(*shape) * 2) / 2, 0.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 6, 6, 6, 3), (2, 7, 5, 6, 3), (1, 8, 8, 8, 4)])
def test_max_pool_grads_pick_the_first_tie_as_jax(shape):
    rng = np.random.RandomState(sum(shape))
    x = _tied(rng, shape)
    y_ref, vjp = jax.vjp(lambda a: jresize.max_pool(a), jnp.asarray(x))
    dy = rng.randn(*y_ref.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(dy))
    (xt,) = _leaves(x)
    y = tresize.max_pool(xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))


@pytest.mark.parametrize("size,out", [
    ((16, 16, 16), (8, 8, 8)), ((16, 16, 16), (4, 4, 4)), ((16, 16, 16), (2, 2, 2)),
    ((9, 7, 10), (4, 3, 5)),
])
def test_resize_nearest_grads_match_jax(size, out):
    # the deep-supervision pyramid's shrinks, and a ratio that is not whole
    rng = np.random.RandomState(len(size) + out[0])
    x = _tied(rng, (2, *size, 3))
    y_ref, vjp = jax.vjp(lambda a: jresize.resize_nearest(a, out), jnp.asarray(x))
    dy = rng.randn(*y_ref.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(dy))
    (xt,) = _leaves(x)
    y = tresize.resize_nearest(xt, out)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
