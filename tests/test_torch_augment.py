"""The port's on-device augmentation against ``hdenseformer_tpu/data/augment_jax.py``.

Each random function of the port is a draw from a ``torch.Generator``
followed by a deterministic apply. Here JAX's draws are replayed: the
test splits JAX's key as JAX's function does (the per-sample
``jax.random.split(key, b)``, the six-way split in ``random_affine_3d``,
``augment_batch_3d``'s three-way split), draws the crop origins, flip
coins, affine parameters, gammas, noise mask and noise with JAX, and
hands them to the port's apply on the same numpy input.

Tolerances: the image within 1e-5 (absolute, and relative to the value);
labels exact except at voxels where JAX's soft value lies within 1e-4 of
0.5 (trilinear weights round differently in the two frameworks);
``pet_ct_normalize``'s CT channel exact and its PET channel within 1e-6
(absolute, and relative) of JAX's formula computed in float64; JAX's own
fp32 mean and std sum in another order and stray further from it, so
against JAX the PET channel is held to JAX's own distance from the float64
value plus that 1e-6. ``to_onehot``, crop and flip exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.data import augment_jax as ja  # noqa: E402
from hdenseformer_tpu_torch.data import augment_device as ta  # noqa: E402

SOFT = 1e-4  # labels may differ where JAX's soft value is this close to 0.5


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _keys(key, b):
    return [jax.random.split(key, b)[i] for i in range(b)]


def jax_crop_origins(key, shape, patch):
    out = []
    for k in _keys(key, shape[0]):
        starts = []
        for i, p in enumerate(patch):
            k, sub = jax.random.split(k)
            hi = shape[1 + i] - p
            starts.append(int(jax.random.randint(sub, (), 0, hi + 1)) if hi > 0 else 0)
        out.append(starts)
    return np.asarray(out, np.int64)


def jax_flip_coins(key, b):
    return np.asarray([bool(jax.random.uniform(k) > 0.5) for k in _keys(key, b)])


def jax_affine_draw(key, b, mode):
    t, a, z = [], [], []
    for k in _keys(key, b):
        kt, kr, kz1, kz2, kt1, kt2 = jax.random.split(k, 6)
        del kt
        t.append([0.0, jax.random.uniform(kt1, minval=-5.0, maxval=5.0),
                  jax.random.uniform(kt2, minval=-5.0, maxval=5.0)] if "t" in mode else [0.0] * 3)
        a.append(jax.random.uniform(kr, minval=-5.0, maxval=5.0) / 180.0 * jnp.pi
                 if "r" in mode else 0.0)
        z.append([1.0, jax.random.uniform(kz1, minval=0.9, maxval=1.1),
                  jax.random.uniform(kz2, minval=0.9, maxval=1.1)] if "z" in mode else [1.0] * 3)
    f32 = np.float32
    return ta.AffineDraw(translation=_t(np.asarray(t, f32)), angle=_t(np.asarray(a, f32)),
                         zoom=_t(np.asarray(z, f32)))


def jax_soft_labels(key, label, num_classes, mode):
    """JAX's warped soft mask of each class z >= 1, (B, *spatial, K - 1): the
    masks go through JAX's affine as image channels (the same sampler)."""
    masks = np.stack([(label == z).astype(np.float32) for z in range(1, num_classes)], -1)
    soft, _ = ja.random_affine_3d(key, jnp.asarray(masks), jnp.zeros(label.shape), 2, mode)
    return np.asarray(soft)


def assert_image_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def assert_labels_match(got, ref, soft):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    near = (np.abs(soft - 0.5) <= SOFT).any(-1)
    np.testing.assert_array_equal(got[~near], ref[~near])
    assert near.mean() < 1e-3


def _volume(rng, shape, channels=2, num_classes=3):
    image = rng.randn(*shape, channels).astype(np.float32)
    image[..., 0] = image[..., 0] * 800 + 100  # CT-like, some beyond +-1024
    image[..., 1] = np.abs(image[..., 1]) * 5 + 1  # PET-like
    label = np.zeros(shape, np.float32)
    grid = np.indices(shape[1:]) - (np.asarray(shape[1:]) / 2)[:, None, None, None]
    r = np.sqrt((grid ** 2).sum(0))
    label[:, r < 5] = 1
    if num_classes > 2:
        label[:, (r < 3) & (grid[1] > 0)] = 2
    return image, label


def test_pet_ct_normalize_matches_jax(rng):
    image, _ = _volume(rng, (2, 9, 10, 11), channels=3)
    ref = np.asarray(ja.pet_ct_normalize(jnp.asarray(image)))
    got = ta.pet_ct_normalize(_t(image)).numpy()
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 2], image[..., 2])
    pet = image[..., 1].astype(np.float64)
    mu = pet.mean(axis=(1, 2, 3), keepdims=True)
    exact = (pet - mu) / (np.sqrt(((pet - mu) ** 2).mean(axis=(1, 2, 3), keepdims=True)) + 1e-3)
    bar = 1e-6 + 1e-6 * np.abs(exact)
    assert (np.abs(got[..., 1] - exact) <= bar).all()
    assert (np.abs(got[..., 1] - ref[..., 1]) <= np.abs(ref[..., 1] - exact) + bar).all()


@pytest.mark.parametrize("num_classes", [2, 3])
def test_to_onehot_matches_jax(num_classes):
    label = np.random.RandomState(0).randint(0, num_classes + 1, (2, 5, 6, 7)).astype(np.float32)
    ref = np.asarray(ja.to_onehot(jnp.asarray(label), num_classes))
    got = ta.to_onehot(_t(label), num_classes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_crop_matches_jax(rng, seed):
    image, label = _volume(rng, (3, 19, 21, 16))
    patch = (16, 14, 16)  # D and H cropped, W at its extent (origin 0)
    key = jax.random.PRNGKey(seed)
    ref_i, ref_l = ja.random_crop(key, jnp.asarray(image), jnp.asarray(label), patch)
    origins = jax_crop_origins(key, image.shape, patch)
    got_i, got_l = ta.crop(_t(image), _t(label), _t(origins), patch)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))


@pytest.mark.parametrize("seed", [0, 3])
def test_random_flip_matches_jax(rng, seed):
    image, label = _volume(rng, (6, 6, 7, 8))
    key = jax.random.PRNGKey(seed)
    ref_i, ref_l = ja.random_flip(key, jnp.asarray(image), jnp.asarray(label))
    coins = jax_flip_coins(key, 6)
    assert 0 < coins.sum() < 6  # both branches run
    got_i, got_l = ta.flip(_t(image), _t(label), _t(coins))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))


@pytest.mark.parametrize("mode", ["tr", "trz", "z"])
@pytest.mark.parametrize("num_classes", [2, 3])
def test_random_affine_3d_matches_jax(rng, mode, num_classes):
    image, label = _volume(rng, (2, 20, 22, 24), num_classes=num_classes)
    image = np.asarray(ja.pet_ct_normalize(jnp.asarray(image)))  # as the pipeline feeds it
    key = jax.random.PRNGKey(7)
    ref_i, ref_l = ja.random_affine_3d(key, jnp.asarray(image), jnp.asarray(label),
                                       num_classes, mode)
    draw = jax_affine_draw(key, 2, mode)
    got_i, got_l = ta.affine_3d(_t(image), _t(label), draw, num_classes)
    assert_image_close(got_i, ref_i)
    assert got_l.dtype == torch.float32
    assert_labels_match(got_l, ref_l, jax_soft_labels(key, label, num_classes, mode))
    assert set(np.unique(got_l.numpy())) <= set(range(num_classes))


def test_affine_zeroes_each_corner_outside_the_volume():
    # a pure translation past the border: the sampled coordinates leave the
    # volume, where JAX's map_coordinates(cval=0) zeroes corner by corner
    image = np.random.RandomState(2).rand(1, 6, 7, 8, 1).astype(np.float32)
    label = np.zeros((1, 6, 7, 8), np.float32)
    draw = ta.AffineDraw(translation=_t(np.asarray([[0.0, 1.5, -2.25]], np.float32)),
                         angle=_t(np.zeros(1, np.float32)), zoom=_t(np.ones((1, 3), np.float32)))
    got, _ = ta.affine_3d(_t(image), _t(label), draw, 2)
    grid = np.indices((6, 7, 8)).astype(np.float32)
    coords = [grid[0], grid[1] + 1.5, grid[2] - 2.25]
    ref = jax.scipy.ndimage.map_coordinates(jnp.asarray(image[0, ..., 0]),
                                            [jnp.asarray(c) for c in coords], order=1, cval=0.0)
    np.testing.assert_allclose(got.numpy()[0, ..., 0], np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_random_gamma_matches_jax(rng):
    image = rng.randn(3, 8, 9, 1).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(ja.random_gamma(key, jnp.asarray(image)))
    gammas = np.asarray(jax.random.uniform(key, (3,), minval=0.8, maxval=1.2))
    got = ta.gamma(_t(image), _t(gammas)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_random_noise_matches_jax():
    image = np.random.RandomState(5).rand(64, 6, 6, 1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(ja.random_noise(key, jnp.asarray(image)))
    k1, k2 = jax.random.split(key)
    apply = np.asarray(jax.random.uniform(k1, (64,)) > 0.9)
    noise = np.asarray(jax.random.normal(k2, image.shape) * 0.1)
    assert 0 < apply.sum() < 64
    got = ta.add_noise(_t(image), _t(apply), _t(noise)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 5])
def test_augment_batch_3d_matches_jax(rng, seed):
    image, label = _volume(rng, (2, 20, 19, 18), num_classes=2)
    patch = (16, 16, 16)
    key = jax.random.PRNGKey(seed)
    ref_i, ref_oh = ja.augment_batch_3d(key, jnp.asarray(image), jnp.asarray(label), patch)
    k1, k2, k3 = jax.random.split(key, 3)
    draw = ta.BatchDraw3D(patch=patch, origins=_t(jax_crop_origins(k1, image.shape, patch)),
                          affine=jax_affine_draw(k2, 2, "tr"), flips=_t(jax_flip_coins(k3, 2)))
    got_i, got_oh = ta.apply_batch_3d(_t(image), _t(label), draw, 2)
    assert_image_close(got_i, ref_i)
    # JAX's soft labels of the cropped, warped volume, then flipped as the labels are
    cropped = np.asarray(ja.random_crop(k1, jnp.asarray(image), jnp.asarray(label), patch)[1])
    soft = jax_soft_labels(k2, cropped, 2, "tr")
    soft, _ = ta.flip(_t(soft), _t(cropped), draw.flips)
    assert got_oh.shape == (2, *patch, 2)
    assert_labels_match(got_oh.numpy().argmax(-1), np.asarray(ref_oh).argmax(-1), soft.numpy())
    np.testing.assert_array_equal(got_oh.numpy().sum(-1), 1.0)


def test_one_seed_gives_the_same_draws_twice():
    shape, patch = (3, 20, 19, 18, 2), (16, 16, 16)
    draws = [ta.draw_batch_3d(torch.Generator().manual_seed(11), shape, patch)
             for _ in range(2)]
    other = ta.draw_batch_3d(torch.Generator().manual_seed(12), shape, patch)
    for a in (draws[1], other):
        same = [torch.equal(draws[0].origins, a.origins),
                torch.equal(draws[0].affine.translation, a.affine.translation),
                torch.equal(draws[0].affine.angle, a.affine.angle),
                torch.equal(draws[0].flips, a.flips)]
        assert all(same) if a is draws[1] else not all(same)
    d = draws[0]
    assert d.origins.shape == (3, 3) and int(d.origins.min()) >= 0
    assert (d.origins.max(0).values <= torch.tensor([4, 3, 2])).all()
    assert (d.affine.translation[:, 0] == 0).all() and d.affine.translation.abs().max() <= 5
    assert d.affine.angle.abs().max() <= 5 / 180 * np.pi
    assert (d.affine.zoom == 1).all()  # "tr": no zoom
    image = torch.randn(shape)
    label = torch.zeros(shape[:-1])
    a = ta.augment_batch_3d(torch.Generator().manual_seed(11), image, label, patch)
    b = ta.augment_batch_3d(torch.Generator().manual_seed(11), image, label, patch)
    c = ta.apply_batch_3d(image, label, draws[1].to("cpu"), 2)  # a moved draw applies alike
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))


def test_crop_refuses_a_volume_smaller_than_the_patch():
    with pytest.raises(ValueError, match="smaller than the patch"):
        ta.draw_crop(torch.Generator(), (1, 12, 20, 20, 2), (16, 16, 16))
