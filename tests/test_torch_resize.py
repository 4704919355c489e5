"""The port's resize and pooling functions against the JAX package's, on CPU.

``ops/resize.py``: ``resize_linear`` (half-pixel), ``resize_linear_align_corners``,
``upsample_linear``, ``upsample_linear_align_corners``, ``avg_pool`` and
``global_avg_pool``, in 2-D and 3-D, at odd sizes and with a length-1 axis,
on the same seeded inputs. fp32 within 1e-6 + 1e-6 |ref| (a few roundings:
the two sides weigh and sum the corners in different orders);
the dtype of the output as JAX's, bf16 within one bf16 step of JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.ops import resize as jresize  # noqa: E402
from hdenseformer_tpu_torch.ops import resize as tresize  # noqa: E402

CASES = {  # input spatial shape -> target size
    "2d_up_odd": ((5, 7), (9, 16)),
    "2d_down_odd": ((11, 9), (4, 5)),
    "2d_len1": ((1, 6), (3, 6)),
    "2d_to1": ((6, 5), (1, 5)),
    "3d_up": ((3, 4, 5), (6, 8, 10)),
    "3d_mixed": ((7, 1, 6), (4, 3, 11)),
}


def _x(spatial, seed=0, channels=3):
    return np.random.RandomState(seed).randn(2, *spatial, channels).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["resize_linear", "resize_linear_align_corners"])
def test_resize_matches_jax(name, case):
    spatial, size = CASES[case]
    x = _x(spatial)
    ref = np.asarray(getattr(jresize, name)(jnp.asarray(x), size))
    got = getattr(tresize, name)(torch.from_numpy(x), size)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spatial", [(4, 5), (3, 4, 5)], ids=["2d", "3d"])
@pytest.mark.parametrize("name", ["upsample_linear", "upsample_linear_align_corners"])
def test_upsample_matches_jax(name, spatial):
    x = _x(spatial, seed=1)
    ref = np.asarray(getattr(jresize, name)(jnp.asarray(x), 2))
    got = getattr(tresize, name)(torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("resized", [True, False], ids=["resized", "same_size"])
def test_align_corners_dtype_is_jax(resized):
    """JAX's fp32 interpolation matrix promotes a bf16 input wherever an axis
    is resized; an input left as it is keeps its dtype. Half-pixel keeps it."""
    x = _x((3, 4, 5), seed=2)
    size = (6, 8, 10) if resized else (3, 4, 5)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    ref = jresize.resize_linear_align_corners(jx, size)
    got = tresize.resize_linear_align_corners(tx, size)
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                               atol=2.0 ** -7 * float(np.abs(x).max()))
    assert tresize.resize_linear(tx, size).dtype == torch.bfloat16


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2), (2, 3)])
@pytest.mark.parametrize("spatial", [(7, 6), (5, 7, 6), (3, 4, 8)], ids=["2d", "3d", "3d_even"])
def test_avg_pool_matches_jax(spatial, window, stride):
    x = _x(spatial, seed=3)
    ref = np.asarray(jresize.avg_pool(jnp.asarray(x), window, stride))
    got = tresize.avg_pool(torch.from_numpy(x), window, stride)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("keepdims", [True, False])
@pytest.mark.parametrize("spatial", [(5, 7), (3, 1, 6)], ids=["2d", "3d"])
def test_global_avg_pool_matches_jax(spatial, keepdims):
    x = _x(spatial, seed=4)
    ref = np.asarray(jresize.global_avg_pool(jnp.asarray(x), keepdims))
    got = tresize.global_avg_pool(torch.from_numpy(x), keepdims)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_resize_rejects_a_wrong_rank():
    with pytest.raises(ValueError, match="spatial dims"):
        tresize.resize_linear(torch.zeros(1, 4, 4, 4, 2), (8, 8))
