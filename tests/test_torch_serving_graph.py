"""The serving calls' whole-call bodies against JAX, through their host side.

JAX compiles ``predict_volume``'s whole call into one program per
(patch, step) lattice cell, the window origins traced data, and
``predict_case_2d``'s chunk into one program per chunk shape. The port runs
each as one ``utils.graphs.CapturedCall`` kept with the model: on a card a
CUDA graph, on the CPU the same body on the same static buffers, which
this file drives (``capture=True``, the default) and holds against JAX's
functions on the same weights (``weights.py``):

- HDenseFormer (n_filters 4, depth 2, patch 32^3, step 16^3): a volume on
  the lattice (48^3), then a second volume of the same cell (40 x 44 x 36:
  other origins, the same call); a volume of 48 x 48 x 32 and then one
  shorter than the patch in one dim (44 x 40 x 20) in the same cell, whose
  windows read the pad that the larger volume filled (the stale-pad trap);
  a volume that fills its cell (48 x 48 x 32) and one with permuted
  spatial strides; gaussian weighting on; ``window_batch`` 1, and 3 (8
  windows padded to 9 with a zero-weight window). Labels equal to JAX's on every voxel whose
  top-two margin in the port's eager accumulator exceeds 1e-4 of the
  window weight (at least 95 % of them), and equal to ``capture=False``'s
  on every voxel; the accumulator of ``accumulate_windows`` equal to its
  eager one bit for bit (the same arithmetic on reused buffers).
- ``predict_case_2d`` (HDenseFormer 2-D, n_filters 8, 32^2, depth 4) of 7
  slices in chunks of 3 (the last chunk padded with zeros): equal to JAX's
  labels and to ``capture=False``'s on every voxel but those whose eager
  logits are within 1e-5 of a tie, one call for every chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.infer import sliding as js  # noqa: E402
from hdenseformer_tpu.infer import slices as jslices  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.infer import sliding as ts  # noqa: E402
from hdenseformer_tpu_torch.infer import slices  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.utils.graphs import model_graphs  # noqa: E402
from hdenseformer_tpu_torch.utils.profiling import tracing  # noqa: E402
from hdenseformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

PATCH, STEP, N_CLS = (32, 32, 32), (16, 16, 16), 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxHDenseFormer(in_channels=2, n_cls=N_CLS, n_filters=4, image_size=PATCH,
                             transformer_depth=2, remat=False, s2d=False)
    params = random_jax_params(jmodel, jnp.zeros((1,) + PATCH + (2,), jnp.float32),
                               np.random.RandomState(0))
    port = load_jax_params(HDenseFormer(2, N_CLS, 4, PATCH, 2, device="cpu"), params).eval()
    return jmodel, {"params": params}, port


def _volume(seed, shape):
    return np.random.RandomState(seed).randn(2, *shape).astype(np.float32)


def _eager_accumulator(port, vol, wb, gauss):
    """``predict_volume``'s accumulator without a captured call, cropped."""
    spatial = vol.shape[1:]
    tgt = ts._lattice_pad_targets(spatial, PATCH, STEP)
    image = np.pad(np.moveaxis(vol, 0, -1), [(0, t - s) for t, s in zip(tgt, spatial)]
                   + [(0, 0)])
    origins = ts._origins_array(ts.cal_steps(spatial, PATCH, STEP))
    n_pad = -len(origins) % wb
    weights = np.concatenate([np.ones(len(origins), np.float32), np.zeros(n_pad, np.float32)])
    origins = np.concatenate([origins, np.zeros((n_pad, 3), np.int32)])
    imp = torch.from_numpy(ts.get_gaussian(PATCH)) if gauss else None
    args = (port, torch.from_numpy(image), origins, weights, PATCH, N_CLS, imp, wb)
    acc = ts.accumulate_windows(*args, capture=False)
    assert torch.equal(ts.accumulate_windows(*args), acc)  # the call's host side
    return acc.numpy()[tuple(slice(0, s) for s in spatial)]


def _check(models, vol, wb=4, gauss=False):
    """The host side's labels against JAX's and the eager body's."""
    jmodel, variables, port = models
    got = ts.predict_volume(port, vol, PATCH, STEP, N_CLS, use_gaussian=gauss, window_batch=wb)
    eager = ts.predict_volume(port, vol, PATCH, STEP, N_CLS, use_gaussian=gauss,
                              window_batch=wb, capture=False)
    ref = np.asarray(js.predict_volume(jmodel, variables, vol, PATCH, STEP, N_CLS,
                                       use_gaussian=gauss, window_batch=wb))
    assert got.shape == ref.shape == vol.shape[1:] and got.dtype == np.int32
    np.testing.assert_array_equal(got, eager)
    acc = _eager_accumulator(port, vol, wb, gauss)
    top2 = np.sort(acc / acc.sum(-1, keepdims=True), axis=-1)
    decided = top2[..., -1] - top2[..., -2] > 1e-4
    assert decided.mean() > 0.95
    np.testing.assert_array_equal(got[decided], ref[decided])


def _calls(port) -> int:
    return model_graphs(port).captured


def test_second_volume_of_a_cell_replays_its_call(models):
    """48^3 and 40 x 44 x 36 both pad to 48^3 with 8 windows: one call, the
    second volume's origins copied into it as data."""
    port = models[2]
    before = _calls(port)
    _check(models, _volume(1, (48, 48, 48)))
    after_first = _calls(port)
    small = (40, 44, 36)
    assert ts._lattice_pad_targets(small, PATCH, STEP) == [48, 48, 48]
    assert not np.array_equal(ts._origins_array(ts.cal_steps(small, PATCH, STEP)),
                              ts._origins_array(ts.cal_steps((48,) * 3, PATCH, STEP)))
    _check(models, _volume(2, small))
    assert _calls(port) == after_first > before


def test_short_volume_after_a_larger_one_reads_zeros_in_the_pad(models):
    """44 x 40 x 20 after 48 x 48 x 32 (the same cell, 4 windows): the
    shorter volume's windows read 12 pad slices along the last dim, which the
    larger volume filled in the call's buffers; they must read zeros."""
    port = models[2]
    big, short = (48, 48, 32), (44, 40, 20)
    assert (ts._lattice_pad_targets(big, PATCH, STEP)
            == ts._lattice_pad_targets(short, PATCH, STEP) == [48, 48, 32])
    _check(models, 3.0 + _volume(3, big))  # large values in the pad-to-be
    n = _calls(port)
    _check(models, _volume(4, short))
    assert _calls(port) == n


def test_volume_that_fills_its_cell_is_staged_without_a_pad(models):
    """48 x 48 x 32 is its own lattice cell: its labels as JAX's and
    ``capture=False``'s, and ``serve.pad_volumes`` does not count it."""
    shape = (48, 48, 32)
    assert ts._lattice_pad_targets(shape, PATCH, STEP) == list(shape)
    with tracing() as rec:
        _check(models, _volume(7, shape))
    assert rec.counters["serve.volumes"] == 2  # captured and capture=False
    assert "serve.pad_volumes" not in rec.counters


def test_non_contiguous_volume_serves_as_its_contiguous_copy(models):
    """A (C, *spatial) view with permuted spatial strides: the labels as
    JAX's, ``capture=False``'s and the contiguous copy's, on every voxel."""
    port = models[2]
    vol = _volume(8, (36, 48, 40)).transpose(0, 2, 1, 3)
    assert vol.shape == (2, 48, 36, 40) and not vol.flags.c_contiguous
    _check(models, vol)
    got, copy = (ts.predict_volume(port, v, PATCH, STEP, N_CLS, window_batch=4)
                 for v in (vol, np.ascontiguousarray(vol)))
    np.testing.assert_array_equal(got, copy)


@pytest.mark.parametrize("capture", [True, False], ids=["captured", "eager"])
def test_pad_volumes_counts_the_short_volume_and_not_the_full_one(models, capture):
    """``test_short_volume_after_a_larger_one_reads_zeros_in_the_pad``'s two
    volumes: the larger one fills the cell (48 x 48 x 32), the shorter one
    does not, and only it is counted."""
    port = models[2]
    counts = []
    for shape, seed in (((48, 48, 32), 3), ((44, 40, 20), 4)):
        with tracing() as rec:
            ts.predict_volume(port, _volume(seed, shape), PATCH, STEP, N_CLS, window_batch=4,
                              capture=capture)
        counts.append(rec.counters.get("serve.pad_volumes", 0))
    assert counts == [0, 1]


@pytest.mark.parametrize("wb,gauss", [(4, True), (1, False), (3, False)],
                         ids=["gaussian", "wb1", "wb3-zero-weight-pad"])
def test_window_batches_and_gaussian(models, wb, gauss):
    _check(models, _volume(5, (40, 44, 36)), wb=wb, gauss=gauss)


SIZE, NF, DEPTH, IN_CH = (32, 32), 8, 4, 3


def test_predict_case_2d_pads_the_last_chunk_as_jax():
    jmodel = JaxHDenseFormer(in_channels=IN_CH, n_cls=N_CLS, n_filters=NF, image_size=SIZE,
                             transformer_depth=DEPTH, remat=False, s2d=False)
    params = random_jax_params(jmodel, jnp.zeros((1,) + SIZE + (IN_CH,)),
                               np.random.RandomState(0))
    rng = np.random.RandomState(1)
    image = rng.gamma(2.0, 50.0, (IN_CH, 7, 40, 40)).astype(np.float32)
    image[:, :, 10:25, 12:30] += 150.0
    ref = jslices.predict_case_2d(jmodel, {"params": params}, image, SIZE, N_CLS, IN_CH,
                                  slice_batch=3)
    model = load_jax_params(HDenseFormer(IN_CH, N_CLS, NF, SIZE, DEPTH, device="cpu"), params)
    got = slices.predict_case_2d(model, image, SIZE, N_CLS, IN_CH, slice_batch=3)
    eager = slices.predict_case_2d(model, image, SIZE, N_CLS, IN_CH, slice_batch=3,
                                   capture=False)
    assert model_graphs(model).captured == 1  # three chunks, one call
    assert got.shape == ref.shape == (7, 40, 40) and got.dtype == np.uint8
    with torch.inference_mode():
        stack = torch.from_numpy(slices.preprocess_slices(image, SIZE, N_CLS, IN_CH))
        logits = model.eval()(stack)[0].float()
    assert float((logits[..., 1] - logits[..., 0]).abs().min()) > 1e-5  # no near-tie
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1
