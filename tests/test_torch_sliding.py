"""Port sliding-window inference against the JAX package's.

The window grid helpers must be exactly JAX's; ``predict_volume`` runs a
small HDenseFormer with the same weights in both frameworks and must give
the same accumulated probabilities and, wherever the decision is not a
near-tie, the same labels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.infer import sliding as js  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.infer import sliding as ts  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

GRID_CASES = [
    ((144, 144, 144), (144, 144, 144), (72, 72, 72)),
    ((200, 180, 150), (144, 144, 144), (72, 72, 72)),
    ((100, 100, 100), (144, 144, 144), (72, 72, 72)),
    ((448, 512, 512), (144, 144, 144), (72, 72, 72)),
    ((40, 41, 26), (32, 32, 16), (16, 16, 8)),
]


@pytest.mark.parametrize("image,patch,step", GRID_CASES)
def test_window_grid_equals_jax(image, patch, step):
    assert ts.cal_steps(image, patch, step) == js.cal_steps(image, patch, step)
    assert ts._lattice_pad_targets(image, patch, step) == js._lattice_pad_targets(
        image, patch, step)
    np.testing.assert_array_equal(
        ts._origins_array(ts.cal_steps(image, patch, step)),
        js._origins_array(js.cal_steps(image, patch, step)),
    )


@pytest.mark.parametrize("patch", [(16, 16, 16), (32, 32, 32), (12, 20, 8)])
def test_gaussian_equals_jax(patch):
    np.testing.assert_array_equal(ts.get_gaussian(patch), js.get_gaussian(patch))


PATCH, STEP, N_CLS = (32, 32, 32), (16, 16, 16), 2


@pytest.fixture(scope="module")
def models():
    jmodel = JaxHDenseFormer(in_channels=2, n_cls=N_CLS, n_filters=4, image_size=PATCH,
                             transformer_depth=4, remat=False, s2d=False)
    params = random_jax_params(jmodel, jnp.zeros((1,) + PATCH + (2,), jnp.float32),
                               np.random.RandomState(0))
    port = load_jax_params(HDenseFormer(2, N_CLS, 4, PATCH, 4, device="cpu"), params)
    return jmodel, {"params": params}, port


@pytest.fixture(scope="module")
def volume():
    # 40^3 at patch 32 / step 16: 2 origins per dim, 8 windows
    return np.random.RandomState(7).randn(2, 40, 40, 40).astype(np.float32)


def _windows(vol, wb):
    """predict_volume's lattice-padded volume, origins and weights."""
    spatial = vol.shape[1:]
    tgt = js._lattice_pad_targets(spatial, PATCH, STEP)
    image = np.pad(np.moveaxis(vol, 0, -1), [(0, t - s) for t, s in zip(tgt, spatial)] + [(0, 0)])
    origins = js._origins_array(js.cal_steps(spatial, PATCH, STEP))
    n_pad = -(-len(origins) // wb) * wb - len(origins)
    weights = np.concatenate([np.ones(len(origins), np.float32), np.zeros(n_pad, np.float32)])
    origins = np.concatenate([origins, np.zeros((n_pad, 3), np.int32)])
    return image, origins, weights


@pytest.mark.parametrize("wb,gauss", [(1, False), (1, True), (4, False), (4, True), (3, False)])
def test_predict_volume_matches_jax(models, volume, wb, gauss):
    jmodel, variables, port = models
    image, origins, weights = _windows(volume, wb)
    imp = js.get_gaussian(PATCH) if gauss else None
    acc_j = np.asarray(js._accumulate_windows(
        jmodel.apply, variables, jnp.asarray(image), jnp.asarray(origins),
        jnp.asarray(weights), PATCH, N_CLS, gauss,
        None if imp is None else jnp.asarray(imp), wb,
    ))
    acc_t = ts.accumulate_windows(
        port, torch.from_numpy(image), origins, weights, PATCH, N_CLS,
        None if imp is None else torch.from_numpy(imp), wb,
    ).numpy()
    np.testing.assert_allclose(acc_t, acc_j, rtol=0, atol=1e-4)

    lab_j = js.predict_volume(jmodel, variables, volume, PATCH, STEP, N_CLS,
                              use_gaussian=gauss, window_batch=wb)
    lab_t = ts.predict_volume(port, volume, PATCH, STEP, N_CLS, use_gaussian=gauss,
                              window_batch=wb)
    assert lab_t.shape == lab_j.shape == volume.shape[1:] and lab_t.dtype == np.int32
    # top-two margin of the accumulated probabilities, per unit of window
    # weight (the gaussian weights fall to ~1e-5 at a window's corners)
    acc_crop = acc_j[:40, :40, :40]
    top2 = np.sort(acc_crop / acc_crop.sum(-1, keepdims=True), axis=-1)
    decided = top2[..., -1] - top2[..., -2] > 1e-4
    assert decided.mean() > 0.95
    np.testing.assert_array_equal(lab_t[decided], lab_j[decided])


def test_lattice_padding_leaves_labels_unchanged(models):
    _, _, port = models
    vol = np.random.RandomState(5).randn(2, 37, 33, 40).astype(np.float32)
    padded = ts.predict_volume(port, vol, PATCH, STEP, N_CLS, window_batch=4)
    plain = ts.predict_volume(port, vol, PATCH, STEP, N_CLS, window_batch=4,
                              pad_to_lattice=False)
    assert padded.shape == vol.shape[1:]
    np.testing.assert_array_equal(padded, plain)


def test_predict_volume_smaller_than_patch(models):
    _, _, port = models
    vol = np.random.RandomState(3).randn(2, 20, 32, 10).astype(np.float32)
    labels = ts.predict_volume(port, vol, PATCH, STEP, N_CLS, window_batch=4)
    assert labels.shape == (20, 32, 10) and set(np.unique(labels)) <= {0, 1}


def test_inference_slidingwindow_writes_cases(models, tmp_path):
    h5py = pytest.importorskip("h5py")
    _, _, port = models
    rng = np.random.RandomState(4)
    for case in ("a", "b"):
        with h5py.File(tmp_path / f"{case}.hdf5", "w") as f:
            f.create_dataset("ct", data=rng.randn(2, 36, 33, 32).astype(np.float32) * 100)
    out = ts.inference_slidingwindow(port, str(tmp_path), str(tmp_path / "seg"), N_CLS,
                                     PATCH, STEP, window_batch=8)
    assert [p.rsplit("/", 1)[-1] for p in out] == ["a.npy", "b.npy"]
    assert np.load(out[0]).shape == (36, 33, 32)
