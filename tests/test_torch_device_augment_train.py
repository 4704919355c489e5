"""The port's trainer with on-device augmentation (``device_augment=True``).

As JAX's tests/test_device_augment_train.py: HDenseFormer_16 trains two
epochs on 16^3 cases with the augmentation inside the step. A step with
``augment_fn`` equals the plain step on the batch augmented beforehand from
the same generator (bitwise: the same operations on the CPU), and the
dropout generator is not touched by the augmentation: the trainer draws the
same masks with it on and off (the augmentation has its own generator,
seeded from (seed, 777, step)).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from hdenseformer_tpu_torch.data.augment_device import augment_batch_3d  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models import hdenseformer as thdf  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    SemanticSeg,
    TrainState,
    augment_seed,
    make_train_step,
    step_seed,
)
from hdenseformer_tpu_torch.train.state import get_optimizer  # noqa: E402
from fixtures import make_case, make_dataset_dir  # noqa: E402

KNOBS = dict(net_name="HDenseFormer_16", lr=1e-3, n_epoch=2, channels=2, num_classes=2,
             roi_number=None, input_shape=(16, 16, 16), crop=0, batch_size=2, num_workers=2,
             transform_3d=[1, 2, 4, 5, 6], transformer_depth=4, use_fp16=False,
             patch_size=(16, 16, 16), device="cpu", seed=3)
SETUP = dict(optimizer="Adam", loss_fun="FocalLoss", lr_scheduler="poly_lr", use_ds=True,
             n_devices=1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's cores,
    and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return make_dataset_dir(str(tmp_path_factory.mktemp("data")), n_cases=4,
                            shape=(16, 16, 16), channels=2, num_classes=2)


def _train(tmp, paths, **knobs):
    seg = SemanticSeg(**dict(KNOBS, **knobs))
    hist = seg.trainer(train_path=paths[:2], val_path=paths[2:], cur_fold=1,
                       output_dir=str(tmp / "ckpt"), log_dir=str(tmp / "log"), **SETUP)
    return seg, hist


def test_train_with_device_augment(tmp_path, paths):
    seg, history = _train(tmp_path, paths, device_augment=True)
    assert len(history["train_loss"]) == 2
    assert all(np.isfinite(v) for v in history["train_loss"] + history["val_loss"])
    assert seg.state.step == 2


def _raw_batch(seed=0):
    rng = np.random.RandomState(seed)
    image = rng.randint(-1024, 2000, (2, 20, 19, 18, 2)).astype(np.float32)
    label = np.zeros((2, 20, 19, 18), np.float32)
    label[:, 5:14, 6:13, 4:12] = 1
    return {"image": torch.from_numpy(image), "label": torch.from_numpy(label),
            "weight": torch.tensor([1.0, 0.0])}


def _net(seed=0):
    net = get_net("HDenseFormer_16", 2, 2, (16, 16, 16), transformer_depth=2, device="cpu")
    return init_weights(net, torch.Generator().manual_seed(seed))


def test_step_with_augment_fn_equals_the_step_on_the_augmented_batch():
    def augment(generator, image, label):
        return augment_batch_3d(generator, image, label, (16, 16, 16), num_classes=2)

    loss = get_loss("FocalLoss", use_ds=True)
    raw = _raw_batch()
    runs = []
    for with_fn in (True, False):
        net = _net()
        state = TrainState(net, get_optimizer("Adam", 1e-3, weight_decay=1e-4,
                                              params=net.parameters()))
        dropout = torch.Generator().manual_seed(step_seed(3, 0))
        aug = torch.Generator().manual_seed(augment_seed(3, 0))
        if with_fn:
            state, out = make_train_step(loss, 2, augment_fn=augment)(state, raw, dropout, aug)
        else:
            image, label = augment(aug, raw["image"], raw["label"])
            assert image.shape == (2, 16, 16, 16, 2) and label.shape == (2, 16, 16, 16, 2)
            batch = {"image": image, "label": label, "weight": raw["weight"]}
            state, out = make_train_step(loss, 2)(state, batch, dropout)
        runs.append((state, out, dropout.get_state()))
    (sa, oa, ga), (sb, ob, gb) = runs
    assert sa.step == sb.step == 1
    for key in ("loss", "dice", "cm"):
        assert torch.equal(oa[key], ob[key]), key
    assert torch.equal(ga, gb)
    for (name, p), q in zip(sa.model.named_parameters(), sb.model.parameters()):
        assert torch.equal(p, q), name
    with pytest.raises(ValueError, match="augment_generator"):
        make_train_step(loss, 2, augment_fn=augment)(sa, raw, torch.Generator())


def test_dropout_masks_are_equal_with_augmentation_on_and_off(tmp_path, paths, monkeypatch):
    """The trainer's dropout generator is in the same state at every mask
    drawn, with the augmentation on the card or on the host."""
    seen = {}

    def recording(key):
        def dropout(x, p, training, generator):
            if training and p > 0:
                seen[key].append((tuple(x.shape), generator.get_state()))
            return real(x, p, training, generator)
        return dropout

    real = thdf.dropout
    for on in (True, False):
        seen[on] = []
        monkeypatch.setattr(thdf, "dropout", recording(on))
        _train(tmp_path / str(on), paths, device_augment=on, n_epoch=1)
    assert len(seen[True]) == len(seen[False]) > 0
    for (shape_a, state_a), (shape_b, state_b) in zip(seen[True], seen[False]):
        assert shape_a == shape_b and torch.equal(state_a, state_b)


def test_a_batch_of_mixed_case_shapes_says_so(tmp_path):
    cases = []
    for i, shape in enumerate(((16, 16, 16), (18, 16, 16), (16, 16, 16))):
        cases.append(str(tmp_path / f"c{i}.hdf5"))
        make_case(cases[-1], shape=shape, seed=i)
    seg = SemanticSeg(**dict(KNOBS, device_augment=True, n_epoch=1))
    with pytest.raises(ValueError, match="a batch mixes image shapes"):
        seg.trainer(cases[:2], cases[2:], 1, output_dir=str(tmp_path / "ckpt"),
                    log_dir=str(tmp_path / "log"), **SETUP)


def test_device_augment_refuses_a_2d_input(tmp_path):
    seg = SemanticSeg(**dict(KNOBS, device_augment=True))
    seg.input_shape = (16, 16)  # the shape alone makes the input 2-D
    with pytest.raises(ValueError, match="device_augment currently supports the 3D pipeline"):
        seg.trainer([], [], 1, output_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "log"),
                    **SETUP)
