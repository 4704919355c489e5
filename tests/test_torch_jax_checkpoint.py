"""The port reads checkpoints written by the JAX package (flax msgpack).

JAX's ``save_checkpoint`` writes, on the CPU, an HDenseFormer_16 (32^3,
depth 2, dropout 0, fine grid) and a Hecktor20Top1 (nf 8, 16^3, level 1
packed), each after one JAX Adam step (coupled L2 1e-4, lr 1e-3). The
port decodes the file with msgpack alone and loads weights and Adam state:

- its forward equals JAX's under the checkpoint's weights within
  tests/test_torch_model.py's bars (HDenseFormer 1e-4, absolute and
  relative; Hecktor20Top1 1e-3 of the logits' scale, tests/test_torch_hecktor.py);
- one further step from the read state equals JAX's next step within
  tests/test_torch_train.py's bars: loss within 1e-4 relative, Adam's
  moments within its gradient bar (1e-3 of each tensor's largest, 2e-3 for
  the squared gradients' average, or 3x JAX's own difference on an input
  moved by 1e-6 where that is more), each parameter within the change of
  its update that this bar allows (step 2 divides by sqrt(v): the first
  step's 1e-5 where the gradient is clear does not carry over) and within
  2 lr everywhere;
- chunked arrays, a bf16 leaf, the dispatch on the file's bytes, a
  ``model_state`` that does not fit the model raises (a BatchNorm model's
  loads: tests/test_torch_zoo_checkpoint.py), epoch and step through
  ``load_pretrained``,
  and ``-m inf-sw`` on a fold directory JAX wrote, against JAX's
  ``inference_slidingwindow`` labels.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu.models.hecktor20top1 import Hecktor20Top1 as JaxHecktor  # noqa: E402
from hdenseformer_tpu.train import checkpoint as jckpt  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import _train_step_fn  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.models.hecktor20top1 import Hecktor20Top1  # noqa: E402
from hdenseformer_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import SemanticSeg, TrainState, make_train_step  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

N_CLS, LR, WD, EPOCH = 2, 1e-3, 1e-4, 4
# the conv biases under an InstanceNorm without affine: true gradient zero
ZERO_GRADIENT = ("deep_conv.conv.bias", "up1.conv.bias", "up2.conv.bias", "up3.conv.bias")

MODELS = {
    "hdenseformer": dict(
        size=(32, 32, 32), use_ds=True,
        jax=lambda: JaxHDenseFormer(in_channels=2, n_cls=N_CLS, n_filters=16,
                                    image_size=(32, 32, 32), transformer_depth=2,
                                    dropout=0.0, remat=False, s2d=False),
        port=lambda: HDenseFormer(2, N_CLS, 16, (32, 32, 32), 2, dropout=0.0, device="cpu")),
    "hecktor": dict(
        size=(16, 16, 16), use_ds=False,
        jax=lambda: JaxHecktor(in_channels=2, n_cls=N_CLS, n_filters=8, s2d=None),
        port=lambda: Hecktor20Top1(2, N_CLS, 8, (16, 16, 16), s2d=None, device="cpu")),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's cores,
    and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed, size):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, *size), np.int64)
    lo, hi = size[0] // 4, 3 * size[0] // 4
    labels[:, lo:hi, lo + 1:hi, lo:hi - 1] = 1
    return {"image": rng.randn(2, *size, 2).astype(np.float32),
            "label": np.eye(N_CLS, dtype=np.float32)[labels]}


def _make_run(name, tmp_path_factory):
    """JAX: one Adam step, the checkpoint, the next step. The port: the
    checkpoint read into a fresh model and optimizer, then that next step."""
    spec = MODELS[name]
    jmodel = spec["jax"]()
    params = random_jax_params(jmodel, jnp.zeros((1,) + spec["size"] + (2,), jnp.float32),
                               np.random.RandomState(0))
    criterion = jlosses.get_loss("FocalLoss", use_ds=spec["use_ds"])
    state = jstate.TrainState.create(apply_fn=jmodel.apply, params=params,
                                     tx=jstate.get_optimizer("Adam", LR, weight_decay=WD))
    step = jax.jit(_train_step_fn(criterion, N_CLS))
    b1, b2 = _batch(1, spec["size"]), _batch(2, spec["size"])
    state1, _ = step(state, {k: jnp.asarray(v) for k, v in b1.items()}, jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp(name) / "jax.ckpt")
    jckpt.save_checkpoint(path, state1.params, state1.opt_state, EPOCH, int(state1.step))
    state2, jm2 = jax.device_get(step(state1, {k: jnp.asarray(v) for k, v in b2.items()},
                                      jax.random.PRNGKey(0)))
    # the same step on the image moved by 1e-6 (relative): the network's own
    # sensitivity, which sets the moments' bar where it exceeds 1e-3
    moved = dict(b2, image=b2["image"] * (1 + 1e-6 * np.random.RandomState(9).randn(
        *b2["image"].shape).astype(np.float32)))
    state2m, _ = jax.device_get(step(state1, {k: jnp.asarray(v) for k, v in moved.items()},
                                     jax.random.PRNGKey(0)))
    x = np.random.RandomState(3).randn(2, *spec["size"], 2).astype(np.float32)
    jout = jax.device_get(jax.jit(jmodel.apply)({"params": state1.params}, jnp.asarray(x)))

    model = spec["port"]()
    opt = tstate.get_optimizer("Adam", LR, weight_decay=WD, params=model.parameters())
    ckpt = tckpt.load_checkpoint(path)
    assert tckpt.load_jax_state(ckpt, model, opt)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(x))
    params1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstep = make_train_step(get_loss("FocalLoss", use_ds=spec["use_ds"]), N_CLS)
    _, m2 = tstep(TrainState(model, opt, step=int(ckpt["step"])),
                  {k: torch.from_numpy(v) for k, v in b2.items()}, None)
    mu2, mu2m = state2.opt_state.inner_state[1], state2m.opt_state.inner_state[1]
    return dict(name=name, path=path, ckpt=ckpt, jout=jout, out=out, model=model,
                opt=opt, params1=params1, jm2=jm2, m2=m2,
                jparams2=from_jax_params(state2.params), jmu2=from_jax_params(mu2.mu),
                jnu2=from_jax_params(mu2.nu), jmu2_moved=from_jax_params(mu2m.mu),
                jnu2_moved=from_jax_params(mu2m.nu))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            made[name] = _make_run(name, tmp_path_factory)
        return made[name]

    return get


@pytest.fixture(params=sorted(MODELS))
def run(request, runs):
    return runs(request.param)


@pytest.fixture
def hdf_run(runs):
    return runs("hdenseformer")


def test_forward_of_the_read_weights_matches_jax(run):
    outs = run["out"] if isinstance(run["out"], (list, tuple)) else [run["out"]]
    refs = run["jout"] if isinstance(run["jout"], (list, tuple)) else [run["jout"]]
    assert len(outs) == len(refs)
    for got, ref in zip(outs, refs):
        ref = np.asarray(ref)
        if run["name"] == "hdenseformer":
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-3 * float(np.abs(ref).max()))


def test_next_step_from_the_read_adam_state_matches_jax(run):
    """Step 2 from the read state. Its moments are running averages of the
    gradients and are held to the gradients' bar, 1e-3 of each tensor's
    largest (2e-3 for the squares: d(g^2) = 2 g dg), or, where larger,
    3x the difference JAX's own step 2 shows on the image moved by 1e-6
    (the network's own sensitivity: after a step Hecktor20Top1's SE gates
    move more than 1e-3 of their largest on that input). Adam divides by
    sqrt(v), so a gradient's error moves the update most where |g| is
    small: each parameter is held to the error in its update that the
    moments' bars allow (the first-order change of lr mhat / (sqrt(vhat) +
    eps), plus 1e-6 for rounding), and to 2 lr everywhere. A wrong count
    (bias correction) or a mis-mapped moment breaks both."""
    np.testing.assert_allclose(float(run["m2"]["loss"]), float(run["jm2"]["loss"]), rtol=1e-4)
    named = dict(run["model"].named_parameters())
    assert sorted(named) == sorted(run["jparams2"])
    c1, c2 = 1 - 0.9 ** 2, 1 - 0.999 ** 2
    for name, ref in run["jparams2"].items():
        st = run["opt"].state[named[name]]
        assert float(st["step"]) == 2.0
        d = (named[name].detach() - ref).abs()
        assert float(d.max()) <= 2 * LR, name
        if name in ZERO_GRADIENT:  # their gradients, and so moments, are rounding noise
            continue
        bars = {}
        for key, jref, jmoved, rel in (
                ("exp_avg", run["jmu2"][name], run["jmu2_moved"][name], 1e-3),
                ("exp_avg_sq", run["jnu2"][name], run["jnu2_moved"][name], 2e-3)):
            bars[key] = max(rel * float(jref.abs().max()),
                            3 * float((jmoved - jref).abs().max()))
            err = float((st[key] - jref).abs().max())
            assert err <= bars[key], (name, key, err, bars[key])
        # v is 0 where a gate gets no gradient: float64 keeps 0 / 0 out
        m, v = run["jmu2"][name].double(), run["jnu2"][name].double()
        mh, rv = m / c1, (v / c2).sqrt()
        den = rv + 1e-8
        dm, dv = bars["exp_avg"] / c1, bars["exp_avg_sq"] / c2
        bound = LR * (dm / den + mh.abs() * dv / (2 * rv.clamp_min(1e-300) * den ** 2)) + 1e-6
        worst = float((d / bound).max())
        assert worst <= 1.0, (name, worst)


def test_read_moments_are_the_checkpoint_moments(run):
    """Before the next step the optimizer holds exactly the checkpoint's
    mu, nu and count (through from_jax_params, as the weights)."""
    model = MODELS[run["name"]]["port"]()
    opt = tstate.get_optimizer("Adam", LR, weight_decay=WD, params=model.parameters())
    tckpt.load_jax_state(run["ckpt"], model, opt)
    inner = run["ckpt"]["opt_state"]["inner_state"]["1"]
    mu, nu = from_jax_params(inner["mu"]), from_jax_params(inner["nu"])
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert float(st["step"]) == float(inner["count"]) == 1.0
    for name in ("SGD", "AdamW"):  # an Adam state has no trace, nor moments at "0"
        other = tstate.get_optimizer(name, LR, params=model.parameters())
        with pytest.raises(ValueError, match=f"not {name}'s"):
            tckpt.load_jax_state(run["ckpt"], model, other)


@pytest.mark.parametrize("name", ["SGD", "AdamW"])
def test_sgd_and_adamw_states_map_too(name, tmp_path):
    spec = MODELS["hecktor"]
    jmodel = spec["jax"]()
    params = random_jax_params(jmodel, jnp.zeros((1,) + spec["size"] + (2,), jnp.float32),
                               np.random.RandomState(0))
    state = jstate.TrainState.create(apply_fn=jmodel.apply, params=params,
                                     tx=jstate.get_optimizer(name, LR, weight_decay=WD))
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params)
    state = state.apply_gradients(grads)
    jckpt.save_checkpoint(str(tmp_path / "s.ckpt"), state.params, state.opt_state, 1, 1)
    model = spec["port"]()
    opt = tstate.get_optimizer(name, LR, weight_decay=WD, params=model.parameters())
    assert tckpt.load_jax_state(tckpt.load_checkpoint(str(tmp_path / "s.ckpt")), model, opt)
    inner = state.opt_state.inner_state[1 if name == "SGD" else 0]
    key, ref = (("momentum_buffer", inner.trace) if name == "SGD" else ("exp_avg", inner.mu))
    ref = from_jax_params(jax.device_get(ref))
    for n, p in model.named_parameters():
        assert torch.equal(opt.state[p][key], ref[n]), n


def test_load_pretrained_reads_epoch_step_and_optimizer(hdf_run):
    knobs = dict(net_name="HDenseFormer_16", channels=2, num_classes=2, roi_number=None,
                 input_shape=(32, 32, 32), transformer_depth=2, use_fp16=False, device="cpu",
                 lr=LR, weight_decay=WD)
    seg = SemanticSeg(**knobs)
    state = seg.load_pretrained(seg.build_state("Adam"), hdf_run["path"], ckpt_point=True)
    assert seg.start_epoch == EPOCH + 1 and state.step == 1
    assert len(state.optimizer.state) == len(list(state.model.parameters()))
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), hdf_run["params1"][name])
    seg = SemanticSeg(**knobs)
    state = seg.load_pretrained(seg.build_state("Adam"), hdf_run["path"], ckpt_point=False)
    assert seg.start_epoch == 0 and state.step == 0 and not state.optimizer.state


def test_chunked_arrays_are_joined(tmp_path, monkeypatch):
    tree = {"a": np.arange(3000, dtype=np.float32).reshape(10, 300),
            "b": {"c": np.arange(7, dtype=np.int32)}}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1024)
    jckpt.save_checkpoint(str(tmp_path / "c.ckpt"), tree, epoch=2, step=5)
    with open(tmp_path / "c.ckpt", "rb") as f:
        raw = tckpt.msgpack.unpackb(f.read(), ext_hook=tckpt._ext_hook)
    assert raw["params"]["a"]["__msgpack_chunked_array__"] and len(raw["params"]["a"]["chunks"]) > 1
    got = tckpt.load_checkpoint(str(tmp_path / "c.ckpt"))
    assert got["epoch"] == 2 and got["step"] == 5
    np.testing.assert_array_equal(got["params"]["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(got["params"]["b"]["c"].numpy(), tree["b"]["c"])


def test_bf16_leaf_and_scalars_are_read(tmp_path):
    ref = jnp.asarray(np.random.RandomState(0).randn(4, 5), jnp.bfloat16)
    tree = {"w": ref, "s": np.float64(0.25), "z": complex(1.5, -2.0)}
    jckpt.save_checkpoint(str(tmp_path / "b.ckpt"), tree, extra={"note": np.int32(7)})
    got = tckpt.load_checkpoint(str(tmp_path / "b.ckpt"))
    w = got["params"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (4, 5)
    np.testing.assert_array_equal(w.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    w[0, 0] = 1.0  # writable: a copy of the file's buffer
    assert got["params"]["s"] == 0.25 and got["params"]["z"] == complex(1.5, -2.0)
    assert got["extra"]["note"] == 7
    np.testing.assert_array_equal(from_jax_params({"w": w})["w"].numpy(),
                                  w.float().numpy())


def test_format_is_told_by_the_bytes(tmp_path, hdf_run):
    torch_path = str(tmp_path / "t.ckpt")
    tckpt.save_checkpoint(torch_path, hdf_run["model"].state_dict(), None, 1, 2)
    assert tckpt.checkpoint_format(torch_path) == "torch"
    assert tckpt.checkpoint_format(hdf_run["path"]) == "flax"
    assert set(tckpt.load_checkpoint(torch_path)) == {"epoch", "step", "model"}
    assert {"epoch", "step", "params", "opt_state"} <= set(tckpt.load_checkpoint(hdf_run["path"]))
    (tmp_path / "x.ckpt").write_bytes(b"\x00\x01junk")
    with pytest.raises(ValueError, match="neither a torch.save zip nor a flax msgpack map"):
        tckpt.load_checkpoint(str(tmp_path / "x.ckpt"))


def test_model_state_raises(tmp_path, hdf_run):
    path = str(tmp_path / "ms.ckpt")
    params = jax.tree_util.tree_map(lambda t: t.numpy(), hdf_run["ckpt"]["params"])
    jckpt.save_checkpoint(path, params,
                          model_state={"batch_stats": {"mean": np.zeros(3, np.float32)}})
    seg = SemanticSeg(net_name="HDenseFormer_16", channels=2, num_classes=2, roi_number=None,
                      input_shape=(32, 32, 32), transformer_depth=2, use_fp16=False,
                      device="cpu")
    # HDenseFormer has no BatchNorm: the strict load refuses the statistics
    with pytest.raises(RuntimeError, match="Unexpected key.*mean"):
        seg.load_pretrained(seg.build_state(), path)
    jckpt.save_checkpoint(path, params, model_state={"cache": {"x": np.zeros(1, np.float32)}})
    with pytest.raises(ValueError, match="batch_stats only"):
        seg.load_pretrained(seg.build_state(), path)


def test_inf_sw_serves_a_fold_directory_written_by_jax(hdf_run, tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    from fixtures import make_case

    from hdenseformer_tpu.infer.sliding import inference_slidingwindow as jax_inference
    from hdenseformer_tpu.models import get_net as jax_get_net
    from hdenseformer_tpu_torch import cli

    h5 = tmp_path / "h5"
    h5.mkdir()
    for i, name in enumerate(("ca", "cb")):
        make_case(str(h5 / f"{name}.hdf5"), shape=(40, 36, 44), seed=i)
    fold = tmp_path / "ckpt" / "Hecktor21" / "3d_seg" / "vj" / "fold1"
    params = jax.tree_util.tree_map(lambda t: t.numpy(), hdf_run["ckpt"]["params"])
    jckpt.save_checkpoint(str(fold / jckpt.metric_filename(EPOCH, 0.5, 0.5, 0.5, 0.4, 0.6, 0.6)),
                          params, None, EPOCH, 1)
    monkeypatch.chdir(tmp_path)
    written = cli.main(["-m", "inf-sw", "--net", "HDenseFormer_16", "--test-path", str(h5),
                        "--save-path", str(tmp_path / "seg"), "--version", "vj", "--dataset",
                        "Hecktor21", "--input-shape", "32", "32", "32", "--step-size", "16",
                        "16", "16", "--transformer-depth", "2", "--no-bf16", "--folds", "1",
                        "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["ca.npy", "cb.npy"]
    jmodel = jax_get_net("HDenseFormer_16", 2, 2, (32, 32, 32), transformer_depth=2)
    want = jax_inference(jmodel, {"params": params}, str(h5), str(tmp_path / "jseg"),
                         num_classes=2, patch_size=(32, 32, 32), step_size=(16, 16, 16),
                         window_batch=8)
    for got_path, want_path in zip(written, want):
        np.testing.assert_array_equal(np.load(got_path), np.load(want_path))
