"""The port's BatchNorm and GroupNorm against the JAX package's, on CPU.

``models.layers.BatchNorm`` against JAX's ``layers.BatchNorm`` (the fine
``_TorchBatchNorm``): training mode over two steps (outputs, running
statistics after each, gradients of the input, scale and bias), eval mode
on non-trivial running statistics, a bf16 input (fp32 out, as JAX), and the
m = 1 case (one value a channel: torch's ``F.batch_norm`` raises, JAX
stores the biased variance 0). ``models.layers.GroupNorm`` against
``transbts.GroupNorm`` (flax's GroupNorm(8), fp32) in fp32 and bf16.

Bars: outputs and gradients within 1e-5 + 1e-5 |ref| (fp32 statistics summed
in another order), running statistics within 1e-5; a bf16 input is rounded
the same on both sides, so the same bars hold, but for its gradient (one
bf16 step of its largest value: JAX sums two partials rounded to bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models.layers import BatchNorm as JaxBatchNorm  # noqa: E402
from hdenseformer_tpu.models.transbts import GroupNorm as JaxGroupNorm  # noqa: E402
from hdenseformer_tpu_torch.models.layers import BatchNorm, GroupNorm  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_batch_stats, from_jax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * (1 + rng.rand(c)) + rng.randn(c)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    return x, dy, scale, bias


def _jax_bn(train, params, stats, x, dy):
    """JAX's output, new batch_stats and the gradients of sum(y * dy)."""
    module = JaxBatchNorm(use_running_average=not train)

    def loss(p, x):
        y, new = module.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, new["batch_stats"])

    (_, (y, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, x)
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, new), gp, np.asarray(gx)


def _params(scale, bias):
    return {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}


@pytest.mark.parametrize("shape", [(2, 5, 4, 3, 6), (1, 1, 1, 1, 4)], ids=["m240", "m1"])
def test_batch_norm_training_matches_jax_over_two_steps(shape):
    x, dy, scale, bias = _inputs(shape, 0)
    x2 = _inputs(shape, 1)[0]
    params = _params(scale, bias)
    stats = {"BatchNorm_0": {"mean": jnp.zeros(shape[-1]), "var": jnp.ones(shape[-1])}}
    bn = BatchNorm(shape[-1], device="cpu")
    bn.load_state_dict({**from_jax_params(params), **from_jax_batch_stats(stats)})
    bn.train()
    for step, xs in enumerate((x, x2)):
        ref, stats, gp, gx = _jax_bn(True, params, stats, jnp.asarray(xs), jnp.asarray(dy))
        bn.zero_grad()
        tx = torch.from_numpy(xs).requires_grad_()
        y = bn(tx)
        (y * torch.from_numpy(dy)).sum().backward()
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.detach().numpy(), ref, **TOL, err_msg=f"step {step}")
        for name, want in from_jax_batch_stats(stats).items():
            np.testing.assert_allclose(getattr(bn, name).numpy(), want.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{name}, step {step}")
        np.testing.assert_allclose(tx.grad.numpy(), gx, **TOL)
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["BatchNorm_0"]["scale"]),
                                   **TOL)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["BatchNorm_0"]["bias"]),
                                   **TOL)
    if shape[:-1] == (1, 1, 1, 1):  # one value a channel adds a variance of 0, twice
        np.testing.assert_allclose(bn.var.numpy(), 0.9 ** 2, rtol=1e-6)


def test_batch_norm_eval_reads_the_running_statistics():
    x, dy, scale, bias = _inputs((2, 3, 4, 5, 6), 2)
    rng = np.random.RandomState(3)
    stats = {"BatchNorm_0": {"mean": jnp.asarray(0.3 * rng.randn(6), jnp.float32),
                             "var": jnp.asarray(0.5 + rng.rand(6), jnp.float32)}}
    ref, new, gp, gx = _jax_bn(False, _params(scale, bias), stats, jnp.asarray(x),
                               jnp.asarray(dy))
    bn = BatchNorm(6, device="cpu").eval()
    bn.load_state_dict({**from_jax_params(_params(scale, bias)), **from_jax_batch_stats(stats)})
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = bn(tx)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), gx, **TOL)
    assert all(torch.equal(v, bn.state_dict()[k]) for k, v in before.items())


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_bf16_input_returns_fp32_as_jax(train):
    x, _, scale, bias = _inputs((2, 4, 4, 4, 8), 4)
    xb = jnp.asarray(x, jnp.bfloat16)
    stats = {"BatchNorm_0": {"mean": jnp.full(8, 0.1), "var": jnp.full(8, 1.3)}}
    module = JaxBatchNorm(use_running_average=not train)
    ref, _ = module.apply({"params": _params(scale, bias), "batch_stats": stats}, xb,
                          mutable=["batch_stats"])
    bn = BatchNorm(8, device="cpu").train(train)
    bn.load_state_dict({**from_jax_params(_params(scale, bias)), **from_jax_batch_stats(stats)})
    with torch.no_grad():
        got = bn(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_batch_norm_state_is_jax_batch_stats():
    bn = BatchNorm(3, device="cpu")
    assert sorted(bn.state_dict()) == ["bias", "mean", "var", "weight"]
    bn.reset_parameters(torch.Generator())
    assert torch.equal(bn.mean, torch.zeros(3)) and torch.equal(bn.var, torch.ones(3))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_group_norm_matches_flax(dtype):
    x, dy, scale, bias = _inputs((2, 3, 4, 5, 16), 5)
    params = {"GroupNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    xj = jnp.asarray(x, dtype)

    def loss(p, x):
        y = JaxGroupNorm().apply({"params": p}, x)
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, xj)
    gn = GroupNorm(16, device="cpu")
    gn.load_state_dict(from_jax_params(params))
    tx = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32).requires_grad_()
    y = gn(tx)
    (y * torch.from_numpy(dy)).sum().backward()
    assert ref.dtype == jnp.float32 and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(gn.weight.grad.numpy(), np.asarray(gp["GroupNorm_0"]["scale"]),
                               **TOL)
    # a bf16 input's gradient: JAX rounds each of its two partial cotangents
    # (the centred path's and the statistics') to bf16 before adding them, so
    # its sum is good to a bf16 step of the partials, order max|ref|, not of
    # the sum: held within 2^-7 max|ref|
    bars = TOL if dtype == jnp.float32 else dict(
        rtol=0, atol=2.0 ** -7 * float(np.abs(np.asarray(gx, np.float32)).max()))
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(gx, np.float32), **bars)
