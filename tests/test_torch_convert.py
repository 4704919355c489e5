"""The port's offline conversion helpers against ``hdenseformer_tpu/data/convert.py``.

The same numpy and scipy code on the same small arrays and files: paths,
splits, written file lists and label grids equal; resampled and resized
images equal or within 1e-6 (absolute, and relative).
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from hdenseformer_tpu.data import convert as jconv  # noqa: E402
from hdenseformer_tpu_torch.data import convert as tconv  # noqa: E402
from fixtures import make_case  # noqa: E402

INTERPOLATORS = ["linear", "nearest", "bspline", "gaussian", "label_gaussian", "hamming_sinc",
                 "cosine_sinc", "welch_sinc", "lanczos_sinc", "blackman_sinc"]


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def patients(tmp_path_factory):
    root = tmp_path_factory.mktemp("nii")
    for pid in ("p2", "p0", "p1"):
        (root / pid).mkdir()
    (root / "notes.txt").write_text("not a patient")
    return root


@pytest.mark.parametrize("append_mask", [True, False])
def test_patient_paths_match_jax(patients, append_mask):
    got = tconv.get_paths_to_patient_files(str(patients), append_mask)
    assert got == jconv.get_paths_to_patient_files(str(patients), append_mask)
    assert [os.path.basename(e[0]) for e in got] == ["p0_ct.nii.gz", "p1_ct.nii.gz",
                                                    "p2_ct.nii.gz"]


def test_train_val_split_matches_jax(patients, tmp_path):
    split = tmp_path / "split.json"
    split.write_text(json.dumps({"train": ["p0", "p2"], "val": ["p1"]}))
    paths = tconv.get_paths_to_patient_files(str(patients))
    got = tconv.get_train_val_paths(paths, str(split))
    assert got == jconv.get_train_val_paths(paths, str(split))
    assert [len(s) for s in got] == [2, 1]


@pytest.mark.parametrize("interpolator", INTERPOLATORS)
@pytest.mark.parametrize("target", ["spacing", "size"])
def test_resample_image_matches_jax(interpolator, target):
    rng = np.random.RandomState(0)
    image = rng.randn(9, 10, 11).astype(np.float32) * 100
    if interpolator == "label_gaussian":
        image = rng.randint(0, 3, (9, 10, 11)).astype(np.uint8)
    kw = (dict(new_spacing=(2.0, 1.5, 0.8)) if target == "spacing"
          else dict(new_size=(6, 13, 8)))
    got, got_sp = tconv.resample_image(image, (1.0, 1.2, 1.0), interpolator=interpolator, **kw)
    ref, ref_sp = jconv.resample_image(image, (1.0, 1.2, 1.0), interpolator=interpolator, **kw)
    assert got_sp == ref_sp
    _close(got, ref)


def test_resample_label_and_bad_arguments_match_jax():
    label = np.random.RandomState(1).randint(0, 3, (7, 8, 9)).astype(np.uint8)
    got, _ = tconv.resample_image(label, (1, 1, 1), new_size=(10, 5, 9), is_label=True,
                                  interpolator="bspline")
    ref, _ = jconv.resample_image(label, (1, 1, 1), new_size=(10, 5, 9), is_label=True,
                                  interpolator="bspline")
    np.testing.assert_array_equal(got, ref)
    for kw in (dict(), dict(new_spacing=(1, 1, 1), new_size=(2, 2, 2))):
        with pytest.raises(ValueError, match="exactly one"):
            tconv.resample_image(label, (1, 1, 1), **kw)
    with pytest.raises(ValueError, match="unknown interpolator"):
        tconv.resample_image(label, (1, 1, 1), new_size=(2, 2, 2), interpolator="cubic")


def _cases(root, shapes, channels=2):
    """Cases with a (channels, *shape) image, or a 3-D one for channels None."""
    root.mkdir()
    for i, shape in enumerate(shapes):
        path = str(root / f"case{i}.hdf5")
        image, label = make_case(path, shape=shape, channels=channels or 1, seed=i)
        if channels is None:
            with h5py.File(path, "w") as f:
                f.create_dataset("ct", data=image[0])
                f.create_dataset("seg", data=label)
    return root


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def _same_files(got, ref):
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    for g, r in zip(got, ref):
        a, b = _read(g), _read(r)
        assert sorted(a) == sorted(b) == ["ct", "seg"]
        _close(a["ct"], b["ct"])
        np.testing.assert_array_equal(a["seg"], b["seg"])
        assert a["seg"].dtype == np.uint8


@pytest.mark.parametrize("channels", [2, None])
def test_resize_data_matches_jax(tmp_path, channels):
    src = _cases(tmp_path / "src", [(20, 18, 16), (12, 14, 10)], channels)
    got = tconv.resize_data(str(src), str(tmp_path / "port"), (8, 9, 10))
    ref = jconv.resize_data(str(src), str(tmp_path / "jax"), (8, 9, 10))
    _same_files(got, ref)
    assert _read(got[0])["ct"].shape == ((channels,) if channels else ()) + (8, 9, 10)


def test_split_and_resize_data_matches_jax(tmp_path):
    src = _cases(tmp_path / "src", [(12, 12, 12)] * 5)
    got = tconv.split_and_resize_data(str(src), str(tmp_path / "port"), (8, 8, 8), retain=2,
                                      seed=3)
    ref = jconv.split_and_resize_data(str(src), str(tmp_path / "jax"), (8, 8, 8), retain=2,
                                      seed=3)
    for g, r, n in zip(got, ref, (3, 2)):
        assert len(g) == n
        _same_files(g, r)
