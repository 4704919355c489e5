"""BatchNorm state through checkpoints: the JAX package's and the port's.

- A ``da_unet`` checkpoint written by JAX's ``save_checkpoint`` after one
  JAX Adam step (widths 16 to 256, 16^3, batch 2, dropout off), with its
  ``model_state``: the port reads it with ``load_jax_state`` for serving
  (the running statistics equal the checkpoint's; the eval forward equals
  JAX's within 1e-5 max|ref| + 1e-5) and for resuming (one further step:
  the loss within 1e-4 relative of JAX's next step, the running statistics
  within 1e-5 + 1e-5 |ref| or 3x JAX's own move on the batch moved by 1e-6,
  as tests/test_torch_zoo_train.py holds them).
- The port's own checkpoint of a BatchNorm model resumes losslessly: a step
  from the saved and reloaded state equals the step of the run that never
  stopped, bit for bit (parameters, buffers, Adam's state).
- ``-m inf-sw`` serves a fold directory that JAX's ``save_checkpoint``
  wrote for ``get_net("da_unet")`` (fp32, 16^3 windows): its labels are
  those of JAX's ``inference_slidingwindow`` under the same variables.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models import daunet as jdaunet  # noqa: E402
from hdenseformer_tpu.train import checkpoint as jckpt  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import _train_step_fn  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import daunet  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step, step_seed  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_batch_stats  # noqa: E402
from torch_port_util import random_jax_variables  # noqa: E402

N_CLS, LR, WD, EPOCH = 2, 1e-3, 1e-4, 3
WIDTH = (16, 32, 64, 128, 256)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed, size=16):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, size, size, size), np.int64)
    labels[:, 4:12, 5:12, 4:11] = 1
    return {"image": rng.randn(2, size, size, size, 2).astype(np.float32),
            "label": np.eye(N_CLS, dtype=np.float32)[labels]}


def _port_model(dropout_flag=False):
    return daunet.da_unet(16, 2, N_CLS, width=WIDTH, dropout_flag=dropout_flag, device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX: one Adam step, the checkpoint (with model_state), the next step
    (and the next step on the batch moved by 1e-6)."""
    jmodel = jdaunet.da_unet(16, 2, N_CLS, width=WIDTH, dropout_flag=False, s2d=False)
    variables = random_jax_variables(jmodel, jnp.zeros((1, 16, 16, 16, 2)),
                                     np.random.RandomState(0))
    state = jstate.TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        tx=jstate.get_optimizer("Adam", LR, weight_decay=WD),
        model_state={"batch_stats": variables["batch_stats"]})
    step = jax.jit(_train_step_fn(jlosses.get_loss("FocalLoss", use_ds=False), N_CLS))
    b1, b2 = _batch(1), _batch(2)
    key = jax.random.PRNGKey(0)
    state1, _ = step(state, {k: jnp.asarray(v) for k, v in b1.items()}, key)
    path = str(tmp_path_factory.mktemp("zoo") / "jax.ckpt")
    jckpt.save_checkpoint(path, state1.params, state1.opt_state, EPOCH, int(state1.step),
                          model_state=state1.model_state)
    state2, jm2 = jax.device_get(step(state1, {k: jnp.asarray(v) for k, v in b2.items()}, key))
    moved = dict(b2, image=b2["image"] * (1 + 1e-6 * np.random.RandomState(9).randn(
        *b2["image"].shape)).astype(np.float32))
    state2m, _ = jax.device_get(step(state1, {k: jnp.asarray(v) for k, v in moved.items()},
                                     key))
    x = np.random.RandomState(3).randn(2, 16, 16, 16, 2).astype(np.float32)
    jout = jax.device_get(jax.jit(jmodel.apply)(
        {"params": state1.params, **state1.model_state}, jnp.asarray(x)))
    return dict(path=path, x=x, jout=jout, b2=b2, jm2=jm2,
                stats1=from_jax_batch_stats(jax.device_get(state1.model_state["batch_stats"])),
                stats2=from_jax_batch_stats(state2.model_state["batch_stats"]),
                stats2m=from_jax_batch_stats(state2m.model_state["batch_stats"]))


def test_jax_checkpoint_with_model_state_serves(jax_run):
    model = _port_model()
    ckpt = tckpt.load_checkpoint(jax_run["path"])
    assert set(ckpt["model_state"]) == {"batch_stats"}
    assert not tckpt.load_jax_state(ckpt, model)  # weights and statistics, no optimizer
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == sorted(jax_run["stats1"])
    for name, want in jax_run["stats1"].items():
        assert torch.equal(buffers[name], want), name
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(jax_run["x"]))
    ref = np.asarray(jax_run["jout"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()) + 1e-5)


def test_jax_checkpoint_with_model_state_resumes(jax_run):
    model = _port_model()
    opt = tstate.get_optimizer("Adam", LR, weight_decay=WD, params=model.parameters())
    ckpt = tckpt.load_checkpoint(jax_run["path"])
    assert tckpt.load_jax_state(ckpt, model, opt)
    step = make_train_step(get_loss("FocalLoss", use_ds=False), N_CLS)
    _, m2 = step(TrainState(model, opt, step=int(ckpt["step"])),
                 {k: torch.from_numpy(v) for k, v in jax_run["b2"].items()}, None)
    np.testing.assert_allclose(float(m2["loss"]), float(jax_run["jm2"]["loss"]), rtol=1e-4)
    buffers = dict(model.named_buffers())
    for name, ref in jax_run["stats2"].items():
        bar = 1e-5 + 1e-5 * ref.abs() + 3 * (jax_run["stats2m"][name] - ref).abs().max()
        assert bool(((buffers[name] - ref).abs() <= bar).all()), name
    assert all(float(s["step"]) == 2.0 for s in opt.state.values())


def test_port_checkpoint_of_a_batchnorm_model_resumes_losslessly(tmp_path):
    """Two steps in one run against one step, save, load into a fresh model
    and optimizer, one step: equal bit for bit, dropout (0.5) included."""
    batches = [{k: torch.from_numpy(v) for k, v in _batch(s).items()} for s in (4, 5)]
    step = make_train_step(get_loss("FocalLoss", use_ds=False), N_CLS)
    gen = torch.Generator()

    def fresh():
        model = _port_model(dropout_flag=True)
        init_weights(model, torch.Generator().manual_seed(0))
        return TrainState(model, tstate.get_optimizer("Adam", LR, weight_decay=WD,
                                                      params=model.parameters()))

    straight = fresh()
    for batch in batches:
        step(straight, batch, gen.manual_seed(step_seed(0, straight.step)))
    run = fresh()
    step(run, batches[0], gen.manual_seed(step_seed(0, run.step)))
    path = str(tmp_path / "bn.ckpt")
    tckpt.save_checkpoint(path, run.model.state_dict(), run.optimizer.state_dict(), 0, run.step)
    ckpt = tckpt.load_checkpoint(path)
    assert "inc.bn1.mean" in ckpt["model"] and "up4.bn2.var" in ckpt["model"]
    resumed = fresh()
    resumed.model.load_state_dict(ckpt["model"])
    resumed.optimizer.load_state_dict(ckpt["optimizer"])
    resumed.step = ckpt["step"]
    step(resumed, batches[1], gen.manual_seed(step_seed(0, resumed.step)))
    want = straight.model.state_dict()
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, want[name]), name
    assert not torch.equal(want["inc.bn1.var"], torch.ones_like(want["inc.bn1.var"]))


def test_inf_sw_serves_a_da_unet_fold_directory_written_by_jax(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    from fixtures import make_case

    from hdenseformer_tpu.infer.sliding import inference_slidingwindow as jax_inference
    from hdenseformer_tpu.models import get_net as jax_get_net
    from hdenseformer_tpu_torch import cli

    h5 = tmp_path / "h5"
    h5.mkdir()
    for i, name in enumerate(("ca", "cb")):
        make_case(str(h5 / f"{name}.hdf5"), shape=(20, 18, 22), seed=i)
    jmodel = jax_get_net("da_unet", 2, 2, (16, 16, 16), s2d=False)
    variables = random_jax_variables(jmodel, jnp.zeros((1, 16, 16, 16, 2)),
                                     np.random.RandomState(7))
    fold = tmp_path / "ckpt" / "Hecktor21" / "3d_seg" / "vz" / "fold1"
    jckpt.save_checkpoint(str(fold / jckpt.metric_filename(EPOCH, 0.5, 0.5, 0.5, 0.4, 0.6, 0.6)),
                          variables["params"], None, EPOCH, 1,
                          model_state={"batch_stats": variables["batch_stats"]})
    monkeypatch.chdir(tmp_path)
    written = cli.main(["-m", "inf-sw", "--net", "da_unet", "--test-path", str(h5),
                        "--save-path", str(tmp_path / "seg"), "--version", "vz", "--dataset",
                        "Hecktor21", "--input-shape", "16", "16", "16", "--step-size", "8", "8",
                        "8", "--no-bf16", "--folds", "1", "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["ca.npy", "cb.npy"]
    want = jax_inference(jmodel, variables, str(h5), str(tmp_path / "jseg"), num_classes=2,
                         patch_size=(16, 16, 16), step_size=(8, 8, 8), window_batch=8)
    for got_path, want_path in zip(written, want):
        np.testing.assert_array_equal(np.load(got_path), np.load(want_path))
