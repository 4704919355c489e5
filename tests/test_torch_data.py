"""The port's host data path against the JAX package's, on the CPU.

The port copies the JAX package's numpy and scipy code (io, transforms,
augment3d, pipeline, convert), so the same files and seeds must give the
same bytes: every comparison here is exact.
"""
import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from hdenseformer_tpu.data import augment3d as jaug  # noqa: E402
from hdenseformer_tpu.data import convert as jconvert  # noqa: E402
from hdenseformer_tpu.data import io as jio  # noqa: E402
from hdenseformer_tpu.data import pipeline as jpipe  # noqa: E402
from hdenseformer_tpu.data import transforms as jtf  # noqa: E402
from hdenseformer_tpu_torch.data import augment3d as taug  # noqa: E402
from hdenseformer_tpu_torch.data import convert as tconvert  # noqa: E402
from hdenseformer_tpu_torch.data import io as tio  # noqa: E402
from hdenseformer_tpu_torch.data import pipeline as tpipe  # noqa: E402
from hdenseformer_tpu_torch.data import transforms as ttf  # noqa: E402
from fixtures import make_dataset_dir  # noqa: E402


def _sample(seed, channels=2, shape=(12, 10, 14)):
    rng = np.random.RandomState(seed)
    image = (rng.randn(channels, *shape) * 300 + 40).astype(np.float32)
    label = np.zeros(shape, np.float32)
    label[3:9, 2:7, 4:11] = 1
    label[5:7, 3:5, 6:8] = 2
    return {"image": image, "label": label}


def _run_both(make, seed, sample_kw=None):
    """The JAX transform and the port's on copies of one sample, each with a
    generator from one seed."""
    out = []
    for mod in (jtf, ttf) if make[0] == "tf" else (jaug, taug):
        t = make[1](mod)
        s = {k: v.copy() for k, v in _sample(seed, **(sample_kw or {})).items()}
        out.append(t(s, np.random.default_rng(seed)))
    return out


TRANSFORMS = {
    "crop": ("aug", lambda m: m.RandomCrop3D((8, 7, 9))),
    "affine_tr": ("aug", lambda m: m.RandomTranslationRotationZoom3D("tr", num_class=3)),
    "affine_trz": ("aug", lambda m: m.RandomTranslationRotationZoom3D("trz", num_class=3)),
    "flip_hv": ("aug", lambda m: m.RandomFlip3D("hv")),
    "flip_h": ("aug", lambda m: m.RandomFlip3D("h")),
    "pet_ct_normalize": ("tf", lambda m: m.PETandCTNormalize()),
    "trunc_normalize": ("tf", lambda m: m.TruncAndNormalize((-100, 200))),
    "mr_normalize": ("tf", lambda m: m.MRNormalize()),
    "crop_resize": ("tf", lambda m: m.CropResize(dim=(8, 9, 7), num_class=3, crop=1,
                                                  channel=2)),
    "to_one_hot": ("tf", lambda m: m.ToOneHot(num_class=3, input_channel=2)),
    "raw_channels_last": ("tf", lambda m: m.RawChannelsLast()),
    "compose": ("tf", lambda m: m.Compose([m.PETandCTNormalize(),
                                           m.ToOneHot(num_class=3, input_channel=2)])),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax_bitwise(name, seed):
    ref, got = _run_both(TRANSFORMS[name], seed)
    assert sorted(ref) == sorted(got)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_resize_helpers_and_roi_remap_match_jax_bitwise():
    rng = np.random.RandomState(3)
    vol = rng.rand(9, 11, 7).astype(np.float32)
    for kw in ({}, {"anti_aliasing": True}, {"order": 0}):
        np.testing.assert_array_equal(ttf.resize_half_pixel(vol, (5, 13, 7), **kw),
                                      jtf.resize_half_pixel(vol, (5, 13, 7), **kw))
    label = rng.randint(0, 4, (9, 11, 7)).astype(np.float32)
    np.testing.assert_array_equal(ttf.resize_label_per_class(label, (5, 6, 4), 4),
                                  jtf.resize_label_per_class(label, (5, 6, 4), 4))
    for roi, n in ((None, 4), (2, 2), ([1, 3], 3)):
        np.testing.assert_array_equal(ttf.remap_roi_labels(label, roi, n),
                                      jtf.remap_roi_labels(label, roi, n))


@pytest.mark.parametrize("n_patients,fold_num", [(6, 3), (7, 3), (5, 5), (4, 2)])
def test_cross_validation_split_matches_jax(n_patients, fold_num):
    paths = [f"/data/p{i}_{j}.hdf5" for i in range(n_patients) for j in range(2)]
    for fold in range(1, fold_num + 1):
        for seed in (None, 0, 7):
            if seed is None:  # unseeded: the split's membership only
                a = tpipe.get_cross_validation_by_sample(paths, fold_num, fold)
                b = jpipe.get_cross_validation_by_sample(paths, fold_num, fold)
                assert [sorted(x) for x in a] == [sorted(x) for x in b]
            else:
                assert tpipe.get_cross_validation_by_sample(paths, fold_num, fold, seed) == \
                    jpipe.get_cross_validation_by_sample(paths, fold_num, fold, seed)


def _loader(mod_pipe, mod_tf, mod_aug, paths, **kw):
    tfm = mod_tf.Compose([
        mod_aug.RandomCrop3D((32, 32, 32)), mod_tf.PETandCTNormalize(),
        mod_aug.RandomTranslationRotationZoom3D(mode="tr", num_class=2),
        mod_aug.RandomFlip3D(mode="hv"), mod_tf.ToOneHot(num_class=2, input_channel=2),
    ])
    ds = mod_pipe.SegDataset(paths, roi_number=None, num_class=2, transform=tfm)
    return mod_pipe.BatchLoader(ds, 2, shuffle=True, num_workers=2, seed=5, **kw)


def test_batch_loader_two_epochs_match_jax_bitwise(tmp_path):
    """Crop 32^3 from 40^3 with the trainer's transforms 1, 2, 4, 5, 6."""
    paths = make_dataset_dir(str(tmp_path), n_cases=3, shape=(40, 40, 40))
    ours = _loader(tpipe, ttf, taug, paths)
    ref = _loader(jpipe, jtf, jaug, paths)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 2
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a["image"].shape == (a["image"].shape[0], 32, 32, 32, 2)
            for key in ("image", "label"):
                np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(list(ours.epoch(0))[0]["image"], got[0]["image"])


def test_batch_loader_stops_its_thread_and_raises_worker_errors(tmp_path):
    import threading

    paths = make_dataset_dir(str(tmp_path), n_cases=6, shape=(8, 8, 8))
    ds = tpipe.SegDataset(paths, roi_number=None, transform=ttf.ToOneHot(2, 2))
    before = threading.active_count()
    loader = tpipe.BatchLoader(ds, 1, num_workers=2, prefetch=1)
    for _ in loader.epoch(0):
        break  # leaving early stops the producer
    assert threading.active_count() == before
    bad = tpipe.SegDataset(paths + [str(tmp_path / "missing.hdf5")], roi_number=None)
    with pytest.raises(FileNotFoundError):
        list(tpipe.BatchLoader(bad, 7, shuffle=False, num_workers=2).epoch(0))
    assert threading.active_count() == before


def test_seg_dataset_takes_another_reader(tmp_path):
    paths = make_dataset_dir(str(tmp_path), n_cases=2, shape=(6, 6, 6))
    calls = []

    def reader(path, key):
        calls.append(key)
        return tio.hdf5_reader(path, key)

    ours = tpipe.SegDataset(paths, roi_number=None, reader=reader).get(1)
    ref = jpipe.SegDataset(paths, roi_number=None).get(1)
    assert calls == ["ct", "seg"]
    for key in ("image", "label"):
        np.testing.assert_array_equal(ours[key], ref[key])


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32, np.float64])
def test_nifti_bytes_match_jax(tmp_path, dtype):
    arr = (np.random.RandomState(2).rand(5, 6, 7) * 100).astype(dtype)
    spacing = (2.5, 0.75, 1.25)  # exact in the header's float32
    for suffix in (".nii", ".nii.gz"):
        ours, ref = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
        tio.write_nifti(str(ours), arr, spacing)
        jio.write_nifti(str(ref), arr, spacing)
        raw = [p.read_bytes() for p in (ours, ref)]
        if suffix == ".nii.gz":  # gzip's header carries the write time
            raw = [gzip.decompress(b) for b in raw]
        assert raw[0] == raw[1]
        (a, sa), (b, sb) = tio.read_nifti(str(ref)), jio.read_nifti(str(ours))
        assert sa == sb == spacing and a.dtype == b.dtype == arr.dtype
        np.testing.assert_array_equal(a, arr)
        np.testing.assert_array_equal(b, arr)


def test_save_as_hdf5_matches_jax(tmp_path):
    data = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    for mod, name in ((tio, "t.hdf5"), (jio, "j.hdf5")):
        mod.save_as_hdf5(data, str(tmp_path / name), "ct")
        mod.save_as_hdf5(data * 2, str(tmp_path / name), "ct")  # overwrite a key
    np.testing.assert_array_equal(tio.hdf5_reader(str(tmp_path / "t.hdf5"), "ct"),
                                  jio.hdf5_reader(str(tmp_path / "j.hdf5"), "ct"))


def _nifti_cases(root, ids, suffixes, rng):
    for pid in ids:
        d = root / pid
        d.mkdir(parents=True)
        for suffix in suffixes:
            arr = rng.randint(0, 5 if suffix in ("_gtvt", "_seg") else 3000,
                              (4, 5, 6)).astype(np.int16)
            tio.write_nifti(str(d / f"{pid}{suffix}.nii.gz"), arr, (3.0, 1.0, 1.0))


@pytest.mark.parametrize("fmt", ["hecktor", "brats"])
def test_convert_matches_jax(tmp_path, fmt):
    rng = np.random.RandomState(4)
    if fmt == "hecktor":
        suffixes, keys = ("_ct", "_pt", "_gtvt"), ("ct", "seg")
    else:
        suffixes, keys = ("_flair", "_t1ce", "_t1", "_t2", "_seg"), ("image", "label")
    _nifti_cases(tmp_path / "raw", ["P1", "P2"], suffixes, rng)
    fn = "nii2npy_" + fmt
    ours = getattr(tconvert, fn)(str(tmp_path / "raw"), str(tmp_path / "t"))
    ref = getattr(jconvert, fn)(str(tmp_path / "raw"), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref]
    for a, b in zip(ours, ref):
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
            assert sorted(fa) == sorted(fb) == sorted(keys)
            for key in keys:
                assert fa[key].dtype == fb[key].dtype
                np.testing.assert_array_equal(fa[key][()], fb[key][()])
