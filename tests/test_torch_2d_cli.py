"""The 2-D path through the port's command line on the CPU (``--device cpu``).

- ``-m train`` (one epoch of fold 1 of 2 on 4 synthetic 2-D slice cases,
  fp32, batch 2, the PI-CAI22 preset's transforms 1, 6, 7, 10), then ``-m
  predict-2d`` of 2 synthetic volumes of another in-plane shape (labels equal
  to ``predict_case_2d`` under the checkpoint's weights), then ``-m eval``
  (a row per volume): HDenseFormer_2D_16 at 32^2 (depth 4; deep supervision
  by the preset's rule) and unet on resnet18 at 64^2 (its running statistics
  moved off (0, 1) in the checkpoint).
- ``ex_pre_trained`` through the trainer: a torchvision-format ResNet-18
  state dict as ``.pth`` and as ``.npz`` fills the encoder before training
  (after one step each weight lies within lr of it); ``True`` raises.
- A fold directory that the JAX package wrote for unet on resnet18 after one
  Adam step (weights, ``batch_stats``, optimizer state) served by the port's
  ``-m predict-2d``: labels equal to JAX's ``predict_case_2d`` on every
  voxel; resumed by ``load_pretrained``: the Adam moments of the 4-D kernels
  and of every other tensor are JAX's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu_torch import cli  # noqa: E402
from hdenseformer_tpu_torch.data.io import hdf5_reader, save_as_hdf5  # noqa: E402
from hdenseformer_tpu_torch.infer.slices import predict_case_2d  # noqa: E402
from hdenseformer_tpu_torch.train.checkpoint import get_weight_path, load_checkpoint  # noqa: E402
from hdenseformer_tpu_torch.train.loop import SemanticSeg  # noqa: E402
from torch_port_util import random_jax_variables  # noqa: E402

NETS = {
    "HDenseFormer_2D_16": ["--net", "HDenseFormer_2D_16", "--input-shape", "32", "32",
                           "--transformer-depth", "4"],
    "unet": ["--net", "unet", "--encoder", "resnet18", "--input-shape", "64", "64"],
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blob(shape, seed):
    """(3, *shape) MR-like channels around a bright box, and its label."""
    rng = np.random.RandomState(seed)
    label = np.zeros(shape, np.uint8)
    h, w = shape[-2:]
    label[..., h // 4 + seed % 3:h // 2 + 4, w // 3:w // 2 + 5 + seed % 4] = 1
    image = rng.gamma(2.0, 40.0, (3,) + tuple(shape)).astype(np.float32) + 200.0 * label
    return image, label


def _write(root, names, shape, seed):
    os.makedirs(root, exist_ok=True)
    for i, name in enumerate(names):
        image, label = _blob(shape, seed + i)
        path = os.path.join(root, name + ".hdf5")
        save_as_hdf5(image, path, "ct")
        save_as_hdf5(label, path, "seg")
    return root


def _common(net, version):
    return ["--dataset", "PI-CAI22", *NETS[net], "--no-bf16", "--folds", "2", "--version",
            version, "--device", "cpu"]


@pytest.mark.parametrize("net", sorted(NETS))
def test_train_predict_2d_eval(tmp_path, monkeypatch, net):
    size = int(NETS[net][NETS[net].index("--input-shape") + 1])
    data = _write(str(tmp_path / "slices"), [f"s{i}" for i in range(4)], (size, size), 0)
    vols = _write(str(tmp_path / "vols"), ["va", "vb"], (3, size + 8, size - 4), 10)
    monkeypatch.chdir(tmp_path)
    common = _common(net, "v2")
    cfg = cli.make_config(cli.build_parser().parse_args(["-m", "train"] + common))
    assert cfg.mode == "2d_seg" and cfg.use_ds == (net != "unet")
    history = cli.main(["-m", "train", "--data-path", data, "--fold", "1", "--epochs", "1",
                        "--batch-size", "2"] + common)
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"]).all()
    ckpt = get_weight_path(os.path.join(cfg.output_dir, "fold1"))
    assert ckpt is not None and cfg.output_dir.startswith("./ckpt/PI-CAI22/2d_seg")
    state = load_checkpoint(ckpt)["model"]
    if net == "unet":
        assert not torch.equal(state["encoder.bn1.var"], torch.ones(64))

    written = cli.main(["-m", "predict-2d", "--test-path", vols, "--save-path", "seg",
                        "--fold", "1"] + common)
    assert [os.path.basename(p) for p in written] == ["va.npy", "vb.npy"]
    seg = SemanticSeg(**cfg.init_trainer_kwargs(), device="cpu")
    seg.model.load_state_dict(state)
    for path in written:
        image = hdf5_reader(os.path.join(vols, os.path.basename(path)[:-4] + ".hdf5"), "ct")
        want = predict_case_2d(seg.model, image, (size, size), 2, 3)
        got = np.load(path)
        assert got.shape == (3, size + 8, size - 4) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    rows = cli.main(["-m", "eval", "--test-path", vols, "--save-path", "seg"] + common)
    assert [r["case"] for r in rows] == ["va", "vb"]
    assert os.path.exists(os.path.join("seg", "eval_results.json"))


def _torchvision_state_dict():
    from test_unet2d_pretrained import TorchResNet18

    torch.manual_seed(5)
    return TorchResNet18(in_ch=3).state_dict()


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_ex_pre_trained_through_the_trainer(tmp_path, fmt):
    sd = _torchvision_state_dict()
    path = str(tmp_path / f"resnet18.{fmt}")
    if fmt == "pth":
        torch.save(sd, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    data = _write(str(tmp_path / "slices"), ["a", "b", "c", "d"], (64, 64), 0)
    files = sorted(os.path.join(data, f) for f in os.listdir(data))
    lr = 1e-3
    seg = SemanticSeg(net_name="unet", encoder_name="resnet18", lr=lr, n_epoch=1, channels=3,
                      num_classes=2, roi_number=None, input_shape=(64, 64), crop=0,
                      batch_size=2, transform_2d=[1, 10], use_fp16=False,
                      ex_pre_trained=path, device="cpu")
    seg.trainer(files[:2], files[2:], 1, output_dir=str(tmp_path / "ckpt"),
                log_dir=str(tmp_path / "log"), loss_fun="FocalLoss")
    trained = seg.state.model.state_dict()
    assert seg.state.step == 1
    for ours, theirs in (("encoder.conv1.weight", "conv1.weight"),
                         ("encoder.layer3_0.downsample_conv.weight",
                          "layer3.0.downsample.0.weight"),
                         ("encoder.layer4_1.conv2.weight", "layer4.1.conv2.weight")):
        moved = float((trained[ours] - sd[theirs]).abs().max())
        assert 0 < moved <= lr * 1.001, ours  # one Adam step from the loaded weights
    with pytest.raises(ValueError, match="local checkpoint"):
        SemanticSeg(net_name="unet", encoder_name="resnet18", channels=3, num_classes=2,
                    roi_number=None, input_shape=(64, 64), use_fp16=False,
                    ex_pre_trained=True, device="cpu").build_state()


@pytest.fixture(scope="module")
def jax_fold(tmp_path_factory):
    """A fold directory that the JAX package wrote for unet on resnet18 after
    one Adam step (weights, ``batch_stats``, optimizer state), 2 volumes, and
    JAX's ``predict_case_2d`` labels of each."""
    import jax

    from hdenseformer_tpu.infer.slices import predict_case_2d as jax_predict
    from hdenseformer_tpu.models import get_net as jax_get_net
    from hdenseformer_tpu.train import checkpoint as jckpt
    from hdenseformer_tpu.train import state as jstate

    root = tmp_path_factory.mktemp("jax_fold")
    vols = _write(str(root / "vols"), ["va", "vb"], (3, 70, 60), 10)
    jmodel = jax_get_net("unet", 3, 2, (64, 64), encoder_name="resnet18")
    variables = random_jax_variables(jmodel, jnp.zeros((1, 64, 64, 3)), np.random.RandomState(7))
    state = jstate.TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                     tx=jstate.get_optimizer("Adam", 1e-3, weight_decay=1e-4))
    rng = np.random.RandomState(8)  # a step on random gradients: moments of every shape
    state = state.apply_gradients(jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32), variables["params"]))
    fold = root / "ckpt" / "PI-CAI22" / "2d_seg" / "vj" / "fold1"
    path = str(fold / jckpt.metric_filename(3, 0.5, 0.5, 0.5, 0.4, 0.6, 0.6))
    jckpt.save_checkpoint(path, state.params, state.opt_state, 3, 1,
                          model_state={"batch_stats": variables["batch_stats"]})
    want = {}
    for name in ("va", "vb"):
        image = hdf5_reader(os.path.join(vols, name + ".hdf5"), "ct")
        want[name] = jax_predict(jmodel, {"params": state.params, **{
            "batch_stats": variables["batch_stats"]}}, image, (64, 64), 2, 3)
    return dict(root=root, vols=vols, path=path, want=want,
                mu=jax.device_get(state.opt_state.inner_state[1].mu))


def test_predict_2d_serves_a_fold_directory_written_by_jax(jax_fold, monkeypatch):
    monkeypatch.chdir(jax_fold["root"])
    written = cli.main(["-m", "predict-2d", "--test-path", jax_fold["vols"], "--save-path",
                        "seg", "--fold", "1"] + _common("unet", "vj"))
    assert [os.path.basename(p) for p in written] == ["va.npy", "vb.npy"]
    for path in written:
        np.testing.assert_array_equal(np.load(path), jax_fold["want"][os.path.basename(path)[:-4]])


def test_a_jax_2d_checkpoint_resumes_with_its_adam_moments(jax_fold):
    """``load_pretrained`` with ``ckpt_point``: the 4-D kernels' first moments
    (and every other tensor's) are JAX's, through the weight bridge."""
    from hdenseformer_tpu_torch.weights import from_jax_params

    seg = SemanticSeg(net_name="unet", encoder_name="resnet18", channels=3, num_classes=2,
                      roi_number=None, input_shape=(64, 64), use_fp16=False, device="cpu")
    state = seg.load_pretrained(seg.build_state("Adam"), jax_fold["path"], ckpt_point=True)
    assert seg.start_epoch == 4 and state.step == 1
    mu = from_jax_params(jax_fold["mu"], model=state.model)
    named = dict(state.model.named_parameters())
    assert named["encoder.conv1.weight"].dim() == 4
    for name, p in named.items():
        assert torch.equal(state.optimizer.state[p]["exp_avg"], mu[name]), name
