"""``get_loss`` of the port against JAX's for every name, on the CPU.

Each name of JAX's loss registry, with and without deep supervision and
``sample_weight``, class weights and top-k given: the value to 2e-6
relative (tests/test_torch_train.py's bar: JAX's fp32 sums round
differently), the gradient to 1e-5 relative plus 1e-6 of the largest. The
losses one by one are in tests/test_torch_losses.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu_torch.losses import losses as tlosses  # noqa: E402


def _check(got, ref, leaves, ref_grads):
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=2e-6)
    for t, r in zip(leaves, ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * max(float(np.abs(r).max()), 1e-30))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weight"])
@pytest.mark.parametrize("use_ds", [False, True], ids=["single", "deep_supervision"])
@pytest.mark.parametrize("loss_fun", sorted(jlosses.LOSS_REGISTRY))
def test_get_loss_matches_jax_for_every_name(loss_fun, use_ds, weighted):
    rng = np.random.RandomState(7)
    outs = [(rng.randn(2, s, s, s, 2) * 2).astype(np.float32) for s in (8, 4, 2)]
    target = np.eye(2, dtype=np.float32)[(rng.rand(2, 8, 8, 8) > 0.7).astype(np.int64)]
    sw = np.array([1.0, 0.0], np.float32) if weighted else None
    kw = dict(class_weight=[0.4, 1.6], topk=20, use_ds=use_ds)
    jfn = jlosses.get_loss(loss_fun, **kw)
    ref, ref_grads = jax.value_and_grad(lambda o: jfn(
        o, jnp.asarray(target), sample_weight=None if sw is None else jnp.asarray(sw)))(
        [jnp.asarray(o) for o in outs])
    leaves = [torch.from_numpy(o).requires_grad_() for o in outs]
    got = tlosses.get_loss(loss_fun, **kw)(
        leaves, torch.from_numpy(target), sample_weight=None if sw is None else
        torch.from_numpy(sw))
    got.backward()
    if not use_ds:  # only head 0 takes part
        assert all(t.grad is None for t in leaves[1:])
        leaves, ref_grads = leaves[:1], ref_grads[:1]
    _check(got, ref, leaves, ref_grads)
