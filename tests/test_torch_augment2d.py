"""The port's 2-D augmentations against JAX's, on the cv2 branch and on the
scipy branch (each module's ``cv2`` set to None in both packages; the card
machine has no cv2, so the port trains there on the scipy branch).

Each class of ``data/augment2d.py`` runs on the same sample with the same
seed in both packages, for several seeds (so that each draw's branches are
taken: the erase sides, the flips, the zoom's crop and pad, the noise's and
the distortion's coin). The bar is equality, or 1e-6 of the image's scale
where an interpolation rounds.
"""
import numpy as np
import pytest

from hdenseformer_tpu.data import augment2d as jaug
from hdenseformer_tpu_torch.data import augment2d as taug

CLASSES = {
    "erase": lambda m: m.RandomErase2D(scale_flag=True),
    "erase_fixed": lambda m: m.RandomErase2D(scale_flag=False),
    "flip": lambda m: m.RandomFlip2D(mode="hv"),
    "flip_h": lambda m: m.RandomFlip2D(mode="h"),
    "rotate": lambda m: m.RandomRotate2D(),
    "zoom": lambda m: m.RandomZoom2D(),
    "adjust": lambda m: m.RandomAdjust2D(),
    "noise": lambda m: m.RandomNoise2D(),
    "distort": lambda m: m.RandomDistort2D(),
}
SEEDS = range(12)


def _sample(seed, empty_label=False):
    rng = np.random.RandomState(100 + seed)
    image = rng.rand(3, 48, 40).astype(np.float32)
    label = np.zeros((48, 40), np.float32)
    if not empty_label:
        label[12 + seed % 5:30, 9:26 + seed % 7] = 1.0
    return {"image": image, "label": label}


@pytest.fixture(params=["cv2", "scipy"])
def branch(request, monkeypatch):
    if request.param == "scipy":
        monkeypatch.setattr(jaug, "cv2", None)
        monkeypatch.setattr(taug, "cv2", None)
    elif taug.cv2 is None:
        pytest.skip("cv2 does not import here")
    return request.param


@pytest.mark.parametrize("empty_label", [False, True], ids=["roi", "no_roi"])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_augmentation_matches_jax(name, empty_label, branch):
    for seed in SEEDS:
        ref = CLASSES[name](jaug)(_sample(seed, empty_label), np.random.default_rng(seed))
        got = CLASSES[name](taug)(_sample(seed, empty_label), np.random.default_rng(seed))
        for key in ("image", "label"):
            assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-6,
                                       err_msg=f"{name} seed {seed} {key} ({branch})")


def test_draws_follow_the_generator():
    """The same seed gives the same sample; another seed moves it."""
    aug = taug.RandomRotate2D()
    a = aug(_sample(0), np.random.default_rng(1))["image"]
    b = aug(_sample(0), np.random.default_rng(1))["image"]
    assert np.array_equal(a, b)
    outs = [aug(_sample(0), np.random.default_rng(s))["image"] for s in range(6)]
    assert any(not np.array_equal(outs[0], o) for o in outs[1:])
