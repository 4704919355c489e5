"""The port's losses against JAX's, one by one, on the CPU.

Each loss, with and without ``sample_weight``, held to 2e-6 relative on the
value (the bar of tests/test_torch_train.py: JAX's fp32 sums round
differently) and the gradient to 1e-5 relative plus 1e-6 of the largest;
``get_loss`` for every name is in tests/test_torch_get_loss.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu_torch.losses import losses as tlosses  # noqa: E402


def _onehot(labels, n_cls):
    return np.eye(n_cls, dtype=np.float32)[labels]


def _check(got, ref, leaves, ref_grads, grad_rtol=1e-5):
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=2e-6)
    for t, r in zip(leaves, ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=grad_rtol,
                                   atol=1e-6 * max(float(np.abs(r).max()), 1e-30))


BASE = {
    "binary_dice_mean": ("binary_dice_loss", {}),
    "binary_dice_topk": ("binary_dice_loss", {"reduction": "topk", "k": 50}),
    "binary_dice_sum_p2": ("binary_dice_loss", {"reduction": "sum", "p": 2}),
    "dice": ("dice_loss", {}),
    "dice_weighted_ignore0": ("dice_loss", {"weight": [0.2, 1.0, 1.7], "ignore_index": 0}),
    "dice_topk": ("dice_loss", {"reduction": "topk"}),
    "topk": ("topk_loss", {"k": 10}),
    "topk_weighted": ("topk_loss", {"k": 30, "weight": [0.2, 1.0, 1.7]}),
    "fl": ("fl_loss", {}),
    "fl_mean": ("fl_loss", {"reduction": "mean", "alpha": 0.25}),
    "ce_plus_dice": ("ce_plus_dice", {"ignore_index": 0}),
    "fl_plus_dice": ("fl_plus_dice", {"ignore_index": 0, "weight": [0.2, 1.0, 1.7]}),
}


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weight"])
@pytest.mark.parametrize("name", sorted(BASE))
def test_loss_matches_jax(name, weighted):
    fn, kw = BASE[name]
    rng = np.random.RandomState(len(name))
    logits = (rng.randn(4, 5, 6, 3, 3) * 2).astype(np.float32)
    target = _onehot(rng.randint(0, 3, (4, 5, 6, 3)), 3)
    sw = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if weighted else None
    if fn == "binary_dice_loss":  # probabilities of one class against its mask
        logits, target = 1 / (1 + np.exp(-logits[..., 1])), target[..., 1]
    ref, ref_grad = jax.value_and_grad(lambda x: getattr(jlosses, fn)(
        x, jnp.asarray(target), sample_weight=None if sw is None else jnp.asarray(sw),
        **kw))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = getattr(tlosses, fn)(lt, torch.from_numpy(target),
                               sample_weight=None if sw is None else torch.from_numpy(sw), **kw)
    got.backward()
    # fl_loss's log(1 - p) has the gradient 1 / (1 - p): where p nears 1, the
    # fp32 rounding of 1 - p (each framework's softmax rounds p its own way)
    # moves it by up to 1.1e-4 relative (observed, one element of 1,080)
    _check(got, ref, [lt], [ref_grad], grad_rtol=2e-4 if fn == "fl_loss" else 1e-5)


def test_masked_topk_equals_the_real_samples_alone():
    """Pad-and-mask: the masked top-k of a padded batch is the top-k of its
    real samples, as JAX's _masked_topk_mean promises."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(3, 6, 5, 4, 2).astype(np.float32))
    target = torch.from_numpy(_onehot(rng.randint(0, 2, (3, 6, 5, 4)), 2))
    real = tlosses.topk_loss(logits[:2], target[:2], k=10)
    padded = tlosses.topk_loss(logits[[0, 1, 0]], target[[0, 1, 0]], k=10,
                               sample_weight=torch.tensor([1.0, 1.0, 0.0]))
    assert float(padded) == pytest.approx(float(real), rel=1e-6)
