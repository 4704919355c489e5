"""Per-slice 2-D prediction of volumes (``infer/slices.py``) against JAX's.

- ``predict_case_2d`` with HDenseFormer (2-D, n_filters 8, 32^2, depth 4, 3
  modalities) under the same random weights on one (3, 5, 40, 40) case:
  slices normalised and resized to 32^2, chunks of 2 (the last one short
  in the port, padded in JAX), the labels resized back to 40^2: equal to
  JAX's labels on every voxel but those whose JAX logits are within 1e-5
  of a tie (there are none at this seed).
- The back-resize: a threshold net (JAX's test's ``Thresh2D``) on a case of
  another in-plane shape than the net's, against JAX's, exactly; and the
  nearest index map ``floor(i * in / out)`` by itself.
- ``eval_dir_2d`` writes one ``<case>.npy`` per ``.hdf5`` case of a directory,
  each equal to ``predict_case_2d`` of that case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from hdenseformer_tpu.infer import slices as jslices  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.data.io import save_as_hdf5  # noqa: E402
from hdenseformer_tpu_torch.infer import slices  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

SIZE, NF, DEPTH, IN_CH, N_CLS = (32, 32), 8, 4, 3, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(seed, shape=(5, 40, 40)):
    rng = np.random.RandomState(seed)
    image = rng.gamma(2.0, 50.0, (IN_CH,) + shape).astype(np.float32)
    image[:, :, 10:25, 12:30] += 150.0
    return image


class Thresh2D(nn.Module):
    """JAX logits = sign of channel 0 around 0.5 (inputs in [0, 1])."""

    @nn.compact
    def __call__(self, x, train=False):
        fg = (x[..., :1] - 0.5) * 20.0
        return jnp.concatenate([-fg, fg], axis=-1)


class TorchThresh2D(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))  # gives the model a device

    def forward(self, x):
        fg = (x[..., :1] - 0.5) * 20.0
        return [torch.cat([-fg, fg], dim=-1)]


@pytest.fixture(scope="module")
def jax_case():
    """JAX's labels of one case, and its logits on the case's preprocessed slices."""
    jmodel = JaxHDenseFormer(in_channels=IN_CH, n_cls=N_CLS, n_filters=NF, image_size=SIZE,
                             transformer_depth=DEPTH, remat=False, s2d=False)
    params = random_jax_params(jmodel, jnp.zeros((1,) + SIZE + (IN_CH,)),
                               np.random.RandomState(0))
    image = _case(1)
    labels = jslices.predict_case_2d(jmodel, {"params": params}, image, SIZE, N_CLS, IN_CH,
                                     slice_batch=2)
    stack = slices.preprocess_slices(image, SIZE, N_CLS, IN_CH)
    logits = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(stack))[0])
    return dict(params=params, image=image, labels=labels, logits=logits)


def test_predict_case_2d_matches_jax(jax_case):
    ref = jax_case["labels"]
    model = load_jax_params(HDenseFormer(IN_CH, N_CLS, NF, SIZE, DEPTH, device="cpu"),
                            jax_case["params"])
    got = slices.predict_case_2d(model, jax_case["image"], SIZE, N_CLS, IN_CH, slice_batch=2)
    assert got.shape == ref.shape == (5, 40, 40) and got.dtype == np.uint8
    # JAX's logits on the same slices: no voxel within 1e-5 of a tie
    logits = jax_case["logits"]
    assert np.abs(logits[..., 1] - logits[..., 0]).min() > 1e-5
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1  # both classes present


def test_back_resize_matches_jax():
    image = _case(2, shape=(3, 37, 52))
    ref = jslices.predict_case_2d(Thresh2D(), {}, image, (16, 24), 2, IN_CH, slice_batch=2)
    got = slices.predict_case_2d(TorchThresh2D(), image, (16, 24), 2, IN_CH, slice_batch=2)
    assert got.shape == (3, 37, 52)
    np.testing.assert_array_equal(got, ref)
    idx = slices._nearest_index(37, 16, "cpu").numpy()
    np.testing.assert_array_equal(idx, np.floor(np.arange(37) * 16 / 37).astype(int))


def test_eval_dir_2d_writes_each_case(tmp_path):
    model = TorchThresh2D()
    for i in range(2):
        path = str(tmp_path / f"case{i}.hdf5")
        save_as_hdf5(_case(3 + i, shape=(4, 20, 20)), path, "ct")
        save_as_hdf5(np.zeros((4, 20, 20), np.uint8), path, "seg")
    written = slices.eval_dir_2d(model, str(tmp_path), str(tmp_path / "out"), (16, 16), 2, IN_CH)
    assert [p.split("/")[-1] for p in written] == ["case0.npy", "case1.npy"]
    for i, path in enumerate(written):
        want = slices.predict_case_2d(model, _case(3 + i, shape=(4, 20, 20)), (16, 16), 2, IN_CH)
        np.testing.assert_array_equal(np.load(path), want)
