"""The port's ``SemanticSeg`` trainer on the CPU.

One epoch of the trainer equals the same epoch built by hand from
``BatchLoader``, ``pad_and_mask_batch`` and ``make_train_step`` (whose
step tests/test_torch_train.py holds against JAX's), and a run resumed from
its checkpoint equals the unbroken run. HDenseFormer_16 at 32^3 patches
cropped from 40^3 cases, depth 4, fp32, remat on, dropout 0.5.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from hdenseformer_tpu_torch.data import augment3d as aug  # noqa: E402
from hdenseformer_tpu_torch.data import transforms as tf  # noqa: E402
from hdenseformer_tpu_torch.data.pipeline import BatchLoader, SegDataset  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.metrics.running import AverageMeter  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.train.checkpoint import get_weight_path  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    SemanticSeg,
    TrainState,
    make_train_step,
    pad_and_mask_batch,
    step_seed,
)
from hdenseformer_tpu_torch.train.state import get_optimizer  # noqa: E402
from fixtures import make_dataset_dir  # noqa: E402

KNOBS = dict(net_name="HDenseFormer_16", channels=2, num_classes=2, roi_number=None,
             input_shape=(32, 32, 32), patch_size=(32, 32, 32), step_size=(16, 16, 16),
             batch_size=2, num_workers=2, lr=1e-3, weight_decay=1e-4, use_fp16=False,
             transformer_depth=4, transform_3d=[1, 2, 4, 5, 6], seed=3, device="cpu")
SETUP = dict(optimizer="Adam", loss_fun="FocalLoss", use_ds=True, lr_scheduler=None)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's cores,
    and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("cases")
    paths = make_dataset_dir(str(root), n_cases=4, shape=(40, 40, 40))
    return paths[:3], paths[3:], root


def _train(tmp, cases, n_epoch, **knobs):
    train, val, _ = cases
    seg = SemanticSeg(**dict(KNOBS, n_epoch=n_epoch, **knobs))
    hist = seg.trainer(train, val, 1, output_dir=str(tmp / "ckpt"), log_dir=str(tmp / "log"),
                       **SETUP)
    return seg, hist


def test_pad_and_mask_batch_pads_cyclically():
    batch = {"image": np.arange(3 * 4, dtype=np.float32).reshape(3, 4),
             "label": np.arange(3, dtype=np.float32)[:, None]}
    out = pad_and_mask_batch(batch, 5, "cpu")
    assert out["image"].shape == (5, 4) and out["image"].device.type == "cpu"
    np.testing.assert_array_equal(out["label"].numpy()[:, 0], [0, 1, 2, 0, 1])
    np.testing.assert_array_equal(out["weight"].numpy(), [1, 1, 1, 0, 0])
    full = pad_and_mask_batch(batch, 2, "cpu")  # a batch larger than batch_size stays
    np.testing.assert_array_equal(full["weight"].numpy(), [1, 1, 1])


@pytest.fixture(scope="module")
def first_epoch(tmp_path_factory, cases):
    """One epoch of the trainer in its own directory: (seg, history, dir)."""
    tmp = tmp_path_factory.mktemp("first")
    return (*_train(tmp, cases, 1), tmp)


def test_trainer_epoch_equals_the_epoch_built_by_hand(first_epoch, cases):
    seg, hist, _ = first_epoch

    train, _, _ = cases
    net = get_net("HDenseFormer_16", 2, 2, (32, 32, 32), transformer_depth=4, device="cpu")
    init_weights(net, torch.Generator().manual_seed(KNOBS["seed"]))
    state = TrainState(net, get_optimizer("Adam", 1e-3, weight_decay=1e-4,
                                          params=net.parameters()))
    step = make_train_step(get_loss("FocalLoss", use_ds=True), 2)
    tfm = tf.Compose([aug.RandomCrop3D((32, 32, 32)), tf.PETandCTNormalize(),
                      aug.RandomTranslationRotationZoom3D(mode="tr", num_class=2),
                      aug.RandomFlip3D(mode="hv"), tf.ToOneHot(2, 2)])
    loader = BatchLoader(SegDataset(train, roi_number=None, transform=tfm), 2, shuffle=True,
                         num_workers=2, seed=KNOBS["seed"])
    meter, gen = AverageMeter(), torch.Generator()
    for batch in loader.epoch(0):
        n = batch["image"].shape[0]
        gen.manual_seed(step_seed(KNOBS["seed"], state.step))
        state, out = step(state, pad_and_mask_batch(batch, 2, "cpu"), gen)
        meter.update(float(out["loss"]), n)

    assert state.step == seg.state.step == 2  # 3 cases: a batch of 2, one of 1 padded
    assert hist["train_loss"] == [meter.avg]
    for (name, p), q in zip(net.named_parameters(), seg.state.model.parameters()):
        assert torch.equal(p, q), name


def test_resume_equals_the_unbroken_run(tmp_path, cases, first_epoch):
    """lr_scheduler None: 2 epochs straight equal 1 epoch, then a resume from
    its checkpoint for 1 more (weights, Adam's moments, the step, the data
    order and the dropout masks all carry over)."""
    straight, hist = _train(tmp_path, cases, 2)
    _, hist1, first_dir = first_epoch
    ckpt = get_weight_path(str(first_dir / "ckpt" / "fold1"))
    assert os.path.basename(ckpt).startswith("epoch=0-")
    resumed, hist2 = _train(first_dir, cases, 2, pre_trained=True, ckpt_point=True,
                            weight_path=ckpt)
    assert resumed.start_epoch == 1 and resumed.state.step == straight.state.step == 4
    for key in ("train_loss", "val_loss", "train_dice", "val_dice"):
        assert hist1[key] + hist2[key] == pytest.approx(hist[key], rel=1e-6), key
    top = max(float(p.detach().abs().max()) for p in straight.state.model.parameters())
    for p, q in zip(straight.state.model.parameters(), resumed.state.model.parameters()):
        assert float((p - q).detach().abs().max()) <= 1e-6 * top
    # both epochs saved (val dice improved or not, the resumed run's first save
    # counts from 0); at most 3 kept
    assert 1 <= len(os.listdir(first_dir / "ckpt" / "fold1")) <= 3
    assert os.path.exists(first_dir / "log" / "fold1" / "metrics.jsonl")


def test_trainer_inference_writes_each_case(tmp_path, cases, first_epoch):
    _, val, _ = cases
    seg = first_epoch[0]
    out = seg.inference_slidingwindow(val, str(tmp_path / "seg"), window_batch=8,
                                      save_nii=True)
    name = os.path.basename(val[0]).split(".")[0]
    assert [os.path.basename(p) for p in out] == [name + ".npy", name + ".nii.gz"]
    assert np.load(out[0]).shape == (40, 40, 40)


@pytest.mark.parametrize("knob,match", [
    (dict(ex_pre_trained=True), "smp-style"), (dict(ex_pre_trained="x.pth"), "smp-style"),
])
def test_ex_pre_trained_refused_off_smp(knob, match):
    """``ex_pre_trained`` loads an ImageNet encoder into the smp-style 2-D
    baselines only: on HDenseFormer it raises JAX's ValueError when the
    state is built."""
    seg = SemanticSeg(**dict(KNOBS, **knob))
    with pytest.raises(ValueError, match=match):
        seg.build_state()


def test_more_than_one_device_raises(tmp_path, cases):
    seg = SemanticSeg(**KNOBS)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        seg.trainer(cases[0], cases[1], 1, output_dir=str(tmp_path), log_dir=str(tmp_path),
                    n_devices=2, **SETUP)
