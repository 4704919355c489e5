"""One train step of each 3-D zoo family against JAX's, on CPU, fp32.

JAX's ``_train_step_fn`` (the body of ``make_train_step``) against the
port's ``train.loop.make_train_step`` from the same weights, running
statistics and batch (2 samples, the second masked out by ``weight``):
FocalLoss, Adam with coupled L2 1e-4, lr 1e-3. Compared: the loss, every
gradient, every updated parameter and the running statistics the step
leaves (JAX's new ``model_state``). The models:

- ``da_unet`` at 32^3, widths 16 to 256, ``dropout_flag=False``;
- ``unetr`` at 32^3, 12 layers, hidden 48 (its get_net dropout rate, 0);
- TransBTS at 16^3, embedding 64, the transformer's dropout off and the
  encoder's channel mask (rate 0.2) replayed from JAX's draw.

Each framework also runs the step in float64 (JAX with x64 on and its
modules' ``jnp.float32`` casts read as float64; the port with
``Tensor.float()`` returning float64). The two float64 steps agree to
1e-6 of each gradient tensor's largest (observed <= 1.1e-7: JAX's
resize matrix stays float32) and their running statistics to
1e-8 (1 + |ref|) (observed <= 1.5e-9). Each
framework's fp32 error is its distance from its own float64 step; a logic
fault in the port is in both of its runs, so it does not widen a bar.

The fp32 bars, as tests/test_torch_train.py holds HDenseFormer's step:
the loss within 1e-4 relative; each gradient within ``bar``, the larger
of 1e-3 and 3x the two frameworks' fp32 errors summed for that tensor,
relative to its largest; each updated parameter within 1e-5 where its
gradient (plus the coupled decay) is clear of that bar and within 2 lr
everywhere; running statistics within 1e-5 + 1e-5 |ref| plus 3x the two
fp32 errors. da_unet's fp32 step is ill-conditioned on JAX's side: its
variance is E[x^2] - mean^2 over few values (16 a channel at the
bottleneck), and its gradients lie up to 2.4 % of their tensor's largest
from the float64 step (down1.conv1.weight; 2.1e-3 at the median tensor;
the port's at most 4.8e-3, at up4.conv1.weight, and 2.9e-4 at the median).

The conv biases that feed a BatchNorm in training (``ZERO_GRADIENT``) have
a true gradient of zero, since the batch mean takes them out: what either
framework returns for them is rounding noise, held by size, as
tests/test_torch_train.py holds its zero-gradient biases. It grows with
the voxels summed (2 x 32^3 a channel at da_unet's level 0) and with the
summation order (the port's CPU convolutions split it by thread): observed
up to 2.1e-6 (JAX) and 1.0e-5 (the port, two threads) of the model's
largest gradient. Both are held to 1e-4 of it, and their update within
2 lr.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models import daunet as jdaunet  # noqa: E402
from hdenseformer_tpu.models import transbts as jtransbts  # noqa: E402
from hdenseformer_tpu.models import unetr as junetr  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import _train_step_fn  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import daunet, transbts, unetr  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step  # noqa: E402
from hdenseformer_tpu_torch.weights import (  # noqa: E402
    from_jax_batch_stats,
    from_jax_params,
    load_jax_params,
)
from torch_port_util import (  # noqa: E402
    jax_float64,
    random_jax_variables,
    torch_float64,
    transbts_channel_keep,
)

N_CLS, LR, WD = 2, 1e-3, 1e-4
WIDTH = (16, 32, 64, 128, 256)
TB = dict(embedding_dim=64, num_heads=4, num_layers=2, hidden_dim=96, dropout_rate=0.0,
          attn_dropout_rate=0.0)
UN = dict(feature_size=8, hidden_size=48, mlp_dim=96, num_heads=4)
MODELS = {
    "da_unet": (32, lambda: jdaunet.da_unet(32, 2, N_CLS, width=WIDTH, dropout_flag=False,
                                            s2d=False),
                lambda: daunet.da_unet(32, 2, N_CLS, width=WIDTH, dropout_flag=False,
                                       device="cpu")),
    "unetr": (32, lambda: junetr.UNETR(2, N_CLS, (32,) * 3, **UN),
              lambda: unetr.UNETR(2, N_CLS, (32,) * 3, device="cpu", **UN)),
    "transbts": (16, lambda: jtransbts.TransBTSModel(2, N_CLS, 16, s2d=False, **TB),
                 lambda: transbts.TransBTSModel(2, N_CLS, 16, device="cpu", **TB)),
}
# the conv biases whose output goes straight into a BatchNorm
ZERO_GRADIENT = {
    "da_unet": {f"{block}.conv{j}.bias" for j in (1, 2) for block in (
        "inc", "down1", "down2", "down3", "down4", "up1", "up2", "up3", "up4")},
    "transbts": ({f"{b}_conv{j}.bias" for j in (1, 2) for b in (
        "Enblock8_1", "Enblock8_2", "DeBlock4", "DeBlock3", "DeBlock2")}
        | {"Unet.EnBlock4_4.conv2.bias"}),  # the encoder's output feeds bn
    "unetr": set(),  # its convs have no bias
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(size):
    rng = np.random.RandomState(1)
    labels = np.zeros((2, size, size, size), np.int64)
    q = size // 4
    labels[:, q:3 * q, q + 1:3 * q, q:3 * q - 1] = 1
    return {"image": rng.randn(2, size, size, size, 2).astype(np.float32),
            "label": np.eye(N_CLS, dtype=np.float32)[labels],
            "weight": np.array([1.0, 0.0], np.float32)}


# the JAX modules of the three steps that cast to jnp.float32
F64_MODULES = tuple(f"hdenseformer_tpu.{m}" for m in (
    "models.layers", "models.daunet", "models.transbts", "models.unetr", "ops.fused_norm",
    "ops.instance_norm", "losses.losses", "train.loop", "train.state"))


def _jax_step(jmodel, variables, batch, key, f64=False):
    """JAX's gradients, new state and metrics (in float64 with ``f64``)."""
    as_f64 = (lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
              ) if f64 else (lambda tree: tree)
    with jax_float64(F64_MODULES) if f64 else contextlib.nullcontext():
        criterion = jlosses.get_loss("FocalLoss", use_ds=False)
        stats = as_f64(variables["batch_stats"])
        state = jstate.TrainState.create(apply_fn=jmodel.apply, params=as_f64(variables["params"]),
                                         tx=jstate.get_optimizer("Adam", LR, weight_decay=WD),
                                         model_state={"batch_stats": stats} if stats else {})
        body = _train_step_fn(criterion, N_CLS)

        @jax.jit
        def run(state, batch):
            new_state, metrics = body(state, batch, key)
            # Adam's first moment after one step is (1 - b1) (g + WD p), the
            # coupled decay on tensors of rank 2 and more: the step's gradient
            mu = new_state.opt_state.inner_state[1].mu
            grads = jax.tree_util.tree_map(
                lambda m, p: m / 0.1 - (WD * p if p.ndim > 1 else 0.0), mu, state.params)
            return grads, new_state, metrics

        return jax.device_get(run(state, {k: jnp.asarray(v) for k, v in as_f64(batch).items()}))


def _port_step(make_port, variables, batch, keep, f64=False):
    """The port's model after one train step from JAX's weights (in float64
    with ``f64``), its starting parameters and the step's metrics."""
    model = make_port()
    load_jax_params(model, variables["params"], variables["batch_stats"])
    if keep is not None:
        model.Unet.channel_keep = lambda h, g: torch.from_numpy(keep)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if f64:
        model.double()
        tbatch = {k: v.double() for k, v in tbatch.items()}
    opt = tstate.get_optimizer("Adam", LR, weight_decay=WD, params=model.parameters())
    step = make_train_step(get_loss("FocalLoss", use_ds=False), N_CLS)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch_float64() if f64 else contextlib.nullcontext():
        _, metrics = step(TrainState(model, opt), tbatch, torch.Generator().manual_seed(0))
    return model, params0, metrics


@pytest.fixture(scope="module", params=sorted(MODELS))
def step_pair(request):
    size, make_jax, make_port = MODELS[request.param]
    jmodel = make_jax()
    batch = _batch(size)
    variables = random_jax_variables(jmodel, jnp.zeros((1, size, size, size, 2)),
                                     np.random.RandomState(0))
    key = jax.random.PRNGKey(0)
    jgrads, jstate2, jmetrics = _jax_step(jmodel, variables, batch, key)
    jgrads64, jstate64, jmetrics64 = _jax_step(jmodel, variables, batch, key, f64=True)
    keep = None
    if request.param == "transbts":  # JAX's mask of step 0: fold_in(key, 0)
        keep = transbts_channel_keep(jmodel, variables, jnp.asarray(batch["image"]),
                                     jax.random.fold_in(key, 0))
    model, params0, metrics = _port_step(make_port, variables, batch, keep)
    model64, _, metrics64 = _port_step(make_port, variables, batch, keep, f64=True)

    def port(tree):
        return from_jax_params(tree, model=model)

    def stats(state):
        return from_jax_batch_stats(state.model_state.get("batch_stats", {}))

    def in_float64(convert, tree):
        """``convert`` (which gives float32) of a float64 tree, kept in
        float64: the float32 part and its remainder, each converted."""
        hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
        lo = convert(jax.tree_util.tree_map(lambda a, h: np.asarray(a - h, np.float32), tree, hi))
        return {k: v.double() + lo[k].double() for k, v in convert(hi).items()}

    return dict(name=request.param, model=model, metrics=metrics, jmetrics=jmetrics,
                params0=params0, jgrads=port(jgrads), jparams=port(jstate2.params),
                jstats=stats(jstate2), jgrads64=in_float64(port, jgrads64),
                jstats64=in_float64(from_jax_batch_stats,
                                    jstate64.model_state.get("batch_stats", {})),
                jmetrics64=jmetrics64, metrics64=metrics64,
                grads64={n: p.grad for n, p in model64.named_parameters()},
                stats64=dict(model64.named_buffers()))


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bar(run, name) -> float:
    """The gradient bar of tensor ``name``, relative to its largest: 1e-3,
    or 3x the two frameworks' fp32 errors (each against its own float64
    step) where that is larger."""
    port = dict(run["model"].named_parameters())[name].grad
    top = max(float(run["jgrads"][name].abs().max()), 1e-30)
    noise = (_err(run["jgrads"][name], run["jgrads64"][name])
             + _err(port, run["grads64"][name]))
    return max(1e-3, 3 * noise / top)


def test_loss_matches_jax(step_pair):
    np.testing.assert_allclose(float(step_pair["metrics"]["loss"]),
                               float(step_pair["jmetrics"]["loss"]), rtol=1e-4)
    np.testing.assert_array_equal(step_pair["metrics"]["cm"].numpy(),
                                  np.asarray(step_pair["jmetrics"]["cm"]))


def test_gradients_match_jax(step_pair):
    named = dict(step_pair["model"].named_parameters())
    assert sorted(named) == sorted(step_pair["jgrads"])
    zero = ZERO_GRADIENT[step_pair["name"]]
    assert zero <= set(named)
    top = max(float(g.abs().max()) for g in step_pair["jgrads"].values())
    for name, ref in step_pair["jgrads"].items():
        got = named[name].grad
        if name in zero:
            noise = max(float(ref.abs().max()), float(got.abs().max()))
            assert noise <= 1e-4 * top, (step_pair["name"], name, noise / top)
            continue
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert err <= bar(step_pair, name), (step_pair["name"], name, err)


def test_updated_parameters_match_jax(step_pair):
    named = dict(step_pair["model"].named_parameters())
    for name, ref in step_pair["jparams"].items():
        p0 = step_pair["params0"][name]
        g = (step_pair["jgrads"][name] + (WD * p0 if p0.dim() > 1 else 0.0)).abs()
        clear = g > bar(step_pair, name) * float(g.max())
        d = (named[name].detach() - ref).abs()
        if bool(clear.any()) and name not in ZERO_GRADIENT[step_pair["name"]]:
            assert float(d[clear].max()) <= 1e-5, (step_pair["name"], name)
        assert float(d.max()) <= 2 * LR, (step_pair["name"], name)


def test_running_statistics_match_jax(step_pair):
    buffers = dict(step_pair["model"].named_buffers())
    assert sorted(buffers) == sorted(step_pair["jstats"])
    assert bool(buffers) == (step_pair["name"] != "unetr")
    for name, ref in step_pair["jstats"].items():
        noise = (_err(ref, step_pair["jstats64"][name])
                 + _err(buffers[name], step_pair["stats64"][name]))
        limit = 1e-5 + 1e-5 * ref.abs() + 3 * noise
        assert bool(((buffers[name] - ref).abs() <= limit).all()), (step_pair["name"], name)


def test_float64_steps_match_jax(step_pair):
    """Both frameworks' float64 steps: loss, gradients and running statistics."""
    np.testing.assert_allclose(float(step_pair["metrics64"]["loss"]),
                               float(step_pair["jmetrics64"]["loss"]), rtol=1e-9)
    zero = ZERO_GRADIENT[step_pair["name"]]
    top = max(float(g.abs().max()) for g in step_pair["jgrads64"].values())
    for name, ref in step_pair["jgrads64"].items():
        got = step_pair["grads64"][name]
        assert got.dtype == torch.float64
        if name in zero:  # zero but for rounding, as in the fp32 test
            assert max(float(ref.abs().max()), float(got.abs().max())) <= 1e-9 * top, name
            continue
        err = _err(got, ref) / float(ref.abs().max())
        assert err <= 1e-6, (step_pair["name"], name, err)
    for name, ref in step_pair["jstats64"].items():
        got = step_pair["stats64"][name]
        assert bool(((got - ref).abs() <= 1e-8 + 1e-8 * ref.abs()).all()), (
            step_pair["name"], name)
