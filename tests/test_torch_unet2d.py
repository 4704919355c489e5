"""The smp-style 2-D baselines against JAX's, on CPU: unet, unet++ and
deeplabv3+ on resnet18 (tests/test_torch_unet2d_encoders.py runs unet on
resnet34 and resnet50 through the helpers below).

Each net from JAX's ``get_2d_net`` and the port's ``get_net`` (aux head of
``num_classes - 1`` = 1 class) gets the same random weights and running
statistics (``random_jax_variables``), at 64^2 and batch 2 (the second
sample masked out by ``weight``):

- an eval forward: masks and aux logits;
- one train step (JAX's ``_train_step_fn`` against the port's
  ``make_train_step``: FocalLoss, Adam with coupled L2 1e-4, lr 1e-3): the
  loss and confusion matrix, the running statistics that the step's one
  training-mode forward leaves (every one must move), every gradient and
  every updated parameter. The aux head's logits enter no loss, so its
  ``fc`` weight moves by the coupled decay alone, as in JAX, and its bias
  (no decay) stays.

JAX runs in float64 (x64, its modules' ``jnp.float32`` casts read as
float64), the eval forward and the step compiled together once per net in a
module-scoped fixture; the port runs the same in fp32 and in float64. The
float64 runs hold the logic: forward within 1e-6 of the output's largest
value (observed <= 4e-14), loss, running statistics, gradients (relative to
each tensor's largest) and parameters within 1e-9. The fp32 run is held
against JAX's float64 step: forward within 1e-5 of the scale (observed <=
4.3e-6), loss 1e-5 relative, running statistics 1e-5 (1 + |ref|), each
gradient within the larger of 1e-3 and 3x the port's own fp32 error against
its float64 step, each parameter within 1e-5 where its gradient is clear of
that bar and 2 lr (plus 1e-6 for its fp32 rounding) everywhere. The second
term is needed: a train-mode BatchNorm's backward over few values a channel
(8 x 8 x 2 at layer2) cancels most of each sum, and fp32 keeps only part of
what is left, the same on every run: the port's fp32 gradients lie up to 3.6 % (unet++,
``encoder.layer2_0.conv2.weight``) and 8.8 % (resnet50,
``encoder.layer4_2.conv3.weight``) of their tensor's largest from the
float64 step, while an input moved by 1e-6 moves them by 1.2e-5 there.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models.unet2d import get_2d_net as jax_get_2d_net  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import _train_step_fn  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step  # noqa: E402
from hdenseformer_tpu_torch.weights import (  # noqa: E402
    from_jax_batch_stats,
    from_jax_params,
    load_jax_params,
)
from torch_port_util import jax_float64, random_jax_variables, torch_float64  # noqa: E402

SIZE, IN_CH, N_CLS, LR, WD = 64, 3, 2, 1e-3, 1e-4
NETS = [("unet", "resnet18"), ("unet++", "resnet18"), ("deeplabv3+", "resnet18")]
FORWARD_BAR = {"fp32": 1e-5, "f64": 1e-6}
# param_rounding: an fp32 parameter against JAX's float64 one, rounded
STEP_BAR = {"fp32": dict(loss=1e-5, stats=1e-5, grad=1e-3, param=1e-5, param_rounding=1e-6),
            "f64": dict(loss=1e-9, stats=1e-9, grad=1e-9, param=1e-9, param_rounding=0.0)}
RUNS = ["fp32", "f64"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.RandomState(1)
    labels = np.zeros((2, SIZE, SIZE), np.int64)
    labels[:, 20:41, 17:45] = 1
    return {"image": rng.randn(2, SIZE, SIZE, IN_CH).astype(np.float32),
            "label": np.eye(N_CLS, dtype=np.float32)[labels],
            "weight": np.array([1.0, 0.0], np.float32)}


# the JAX modules of these steps that cast to jnp.float32
F64_MODULES = tuple(f"hdenseformer_tpu.{m}" for m in (
    "models.layers", "models.unet2d", "losses.losses", "train.loop", "train.state"))


def _jax_run(jmodel, variables, batch):
    """JAX's eval forward and one train step in float64, compiled together."""
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    with jax_float64(F64_MODULES):
        criterion = jlosses.get_loss("FocalLoss", use_ds=False)
        state = jstate.TrainState.create(
            apply_fn=jmodel.apply, params=f64(variables["params"]),
            tx=jstate.get_optimizer("Adam", LR, weight_decay=WD),
            model_state={"batch_stats": f64(variables["batch_stats"])})
        body = _train_step_fn(criterion, N_CLS)

        @jax.jit
        def run(state, batch):
            outs = jmodel.apply({"params": state.params, **state.model_state}, batch["image"],
                                train=False)
            new_state, metrics = body(state, batch, jax.random.PRNGKey(0))
            # Adam's first moment after one step is (1 - b1) (g + WD p), the
            # coupled decay on tensors of rank 2 and more: the step's gradient
            mu = new_state.opt_state.inner_state[1].mu
            grads = jax.tree_util.tree_map(
                lambda m, p: m / 0.1 - (WD * p if p.ndim > 1 else 0.0), mu, state.params)
            return outs, grads, new_state, metrics

        return jax.device_get(run(state, {k: jnp.asarray(v) for k, v in f64(batch).items()}))


def _port_run(build, batch, f64: bool):
    """The port's eval forward and one train step (in float64 with ``f64``)."""
    model = build()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if f64:
        model.double()
        tbatch = {k: v.double() for k, v in tbatch.items()}
    with torch_float64() if f64 else contextlib.nullcontext():
        with torch.no_grad():
            outs = model(tbatch["image"])
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        buffers0 = {n: b.clone() for n, b in model.named_buffers()}
        opt = tstate.get_optimizer("Adam", LR, weight_decay=WD, params=model.parameters())
        step = make_train_step(get_loss("FocalLoss", use_ds=False), N_CLS)
        _, metrics = step(TrainState(model, opt), tbatch, torch.Generator().manual_seed(0))
    return dict(model=model, outs=outs, metrics=metrics, params0=params0, buffers0=buffers0)


def _in_float64(convert, tree):
    """``convert`` (which gives float32) of a float64 tree, kept in float64:
    the float32 part and its remainder, each converted."""
    hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    lo = convert(jax.tree_util.tree_map(lambda a, h: np.asarray(a - h, np.float32), tree, hi))
    return {k: v.double() + lo[k].double() for k, v in convert(hi).items()}


def build_pair(net_name: str, encoder: str) -> dict:
    """JAX's float64 eval forward and step, and the port's in fp32 and float64."""
    jmodel = jax_get_2d_net(net_name, encoder, IN_CH, N_CLS, aux_classes=N_CLS - 1)
    variables = random_jax_variables(jmodel, jnp.zeros((1, SIZE, SIZE, IN_CH)),
                                     np.random.RandomState(0))
    batch = _batch()
    jouts, jgrads, jstate2, jmetrics = _jax_run(jmodel, variables, batch)

    def build():
        model = get_net(net_name, IN_CH, N_CLS, (SIZE, SIZE), encoder_name=encoder,
                        device="cpu")
        return load_jax_params(model, variables["params"], variables["batch_stats"])

    runs = {"fp32": _port_run(build, batch, False), "f64": _port_run(build, batch, True)}
    model = runs["fp32"]["model"]

    def port(tree):
        return from_jax_params(tree, model=model)

    return dict(name=(net_name, encoder), runs=runs, jouts=jouts, jmetrics=jmetrics,
                jgrads=_in_float64(port, jgrads), jparams=_in_float64(port, jstate2.params),
                jstats=_in_float64(from_jax_batch_stats, jstate2.model_state["batch_stats"]))


@pytest.fixture(scope="module", params=NETS, ids=["-".join(n) for n in NETS])
def pair(request):
    return build_pair(*request.param)


def _err(a, b) -> float:
    return float((torch.as_tensor(np.array(a)).double() - torch.as_tensor(np.array(b)).double()
                  ).abs().max())


def check_eval_forward(pair, run):
    """Masks and aux logits of an eval forward, within FORWARD_BAR[run] of
    each output's largest value."""
    masks, labels = pair["runs"][run]["outs"]
    jmasks, jlabels = pair["jouts"]
    assert masks.shape == (2, SIZE, SIZE, N_CLS) and labels.shape == (2, N_CLS - 1)
    for got, ref in ((masks, jmasks), (labels, jlabels)):
        err = _err(got, ref) / float(np.abs(ref).max())
        assert err <= FORWARD_BAR[run], (pair["name"], run, err)


def check_train_step(pair, run):
    """One step against JAX's float64 step: the loss and confusion matrix; the
    running statistics that its training-mode forward leaves, every one
    moved; each gradient, relative to its tensor's largest; each updated
    parameter (within ``param`` where its gradient is clear of the bar, and
    2 lr everywhere, where Adam's first step may flip a sign)."""
    r, bar = pair["runs"][run], STEP_BAR[run]
    model = r["model"]
    np.testing.assert_allclose(float(r["metrics"]["loss"]), float(pair["jmetrics"]["loss"]),
                               rtol=bar["loss"])
    np.testing.assert_array_equal(r["metrics"]["cm"].numpy(), np.asarray(pair["jmetrics"]["cm"]))
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == sorted(pair["jstats"])
    for name, ref in pair["jstats"].items():
        assert not torch.equal(buffers[name], r["buffers0"][name]), name
        err = float(((buffers[name].double() - ref).abs() / (1 + ref.abs())).max())
        assert err <= bar["stats"], (pair["name"], run, name, err)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(pair["jgrads"])
    largest = max(float(g.abs().max()) for g in pair["jgrads"].values())
    f64 = dict(pair["runs"]["f64"]["model"].named_parameters())
    bars = {}
    for name, ref in pair["jgrads"].items():
        got = named[name].grad
        if name.startswith("cls_head."):  # no loss reaches the aux head
            assert torch.equal(got, torch.zeros_like(got)), name
            assert float(ref.abs().max()) <= 1e-9 * largest, name  # JAX's: Adam's rounding
            continue
        top = float(ref.abs().max())
        bars[name] = bar["grad"] if run == "f64" else max(
            bar["grad"], 3 * _err(got, f64[name].grad) / top)
        err = _err(got, ref) / top
        assert err <= bars[name], (pair["name"], run, name, err)
    for name, ref in pair["jparams"].items():
        p0 = r["params0"][name].double()
        g = (pair["jgrads"][name] + (WD * p0 if p0.dim() > 1 else 0.0)).abs()
        clear = g > bars.get(name, bar["grad"]) * float(g.max())
        d = (named[name].detach().double() - ref).abs()
        if bool(clear.any()):
            assert float(d[clear].max()) <= bar["param"], (pair["name"], run, name)
        assert float(d.max()) <= 2 * LR + bar["param_rounding"], (pair["name"], run, name)


def check_aux_head(pair):
    """The aux logits enter no loss: every fc weight moves (its coupled L2
    term), as in JAX; the fc bias (no decay) stays."""
    r = pair["runs"]["fp32"]
    named = dict(r["model"].named_parameters())
    w0, b0 = r["params0"]["cls_head.fc.weight"], r["params0"]["cls_head.fc.bias"]
    w, b = named["cls_head.fc.weight"].detach(), named["cls_head.fc.bias"].detach()
    assert bool(((w - w0).abs() > 0).all())
    assert _err(w, pair["jparams"]["cls_head.fc.weight"]) <= 1e-6
    assert torch.equal(b, b0) and _err(b, pair["jparams"]["cls_head.fc.bias"]) == 0.0


@pytest.mark.parametrize("run", RUNS)
def test_eval_forward_matches_jax(pair, run):
    check_eval_forward(pair, run)


@pytest.mark.parametrize("run", RUNS)
def test_train_step_matches_jax(pair, run):
    check_train_step(pair, run)


def test_aux_head_moves_by_the_coupled_decay(pair):
    check_aux_head(pair)
