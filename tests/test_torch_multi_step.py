"""K chained train steps of the port against JAX's, on the CPU, fp32.

``train.loop.make_multi_train_step`` (on the CPU the loop of K
``make_train_step`` steps; on a card one step captured as a CUDA graph,
tests/test_torch_cuda.py) against:

- JAX's ``make_multi_train_step`` (a ``lax.scan`` of the step) at K = 3 on
  HDenseFormer_2D_16 at 32^2, depth 4, as JAX's tests/test_multi_step.py
  runs it but with dropout off (the two frameworks draw other masks):
  losses within 1e-5 relative and parameters within 1e-2, JAX's own bars
  for its scan against its loop (Adam's early steps move a parameter by
  about lr whatever its gradient's size, so a last-ulp difference in a
  near-zero gradient flips an update by up to 2 lr a step);
- JAX's ``make_train_step`` over a K = 4 trajectory from shared weights and
  batches, dropout off: HDenseFormer_16 at 32 x 32 x 16 (4 tokens) and
  da_unet at 32^3 (BatchNorm, level 0 packed; at 16^3 its bottleneck
  normalises 2 values a channel, and JAX's own trajectory moves by 13 % of
  an update when the two samples of each batch swap places), Adam lr 1e-3
  with coupled L2 1e-4, DS FocalLoss / FocalLoss. Per step, the loss within
  1e-4 relative (the one-step bar of tests/test_torch_train.py; observed
  <= 7.6e-5 at step 4), the dice within 1e-3 relative and the confusion
  matrices within 0.1 % of a step's voxels (hard argmax: a voxel at a
  near-tie flips as the weights drift by rounding); after the 4 steps
  every parameter within 1e-2 (as above, over one more step) and each
  running statistic within 1e-2 of its norm (observed <= 4.1e-3, the
  decoder's means, which follow the weights' drift; a wrong momentum or
  unbiasing factor, 6 % at the bottleneck's 16 values, is well beyond).

And the port against itself: K chained steps equal K ``make_train_step``
calls seeded ``step_seed(seed, step)`` (as the trainer seeds them), bit for
bit, with dropout on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models import daunet as jdaunet  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu.train import loop as jloop  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import daunet, hdenseformer  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    TrainState,
    make_multi_train_step,
    make_train_step,
    step_seed,
)
from hdenseformer_tpu_torch.weights import (  # noqa: E402
    from_jax_batch_stats,
    from_jax_params,
    load_jax_params,
)
from torch_port_util import random_jax_variables  # noqa: E402

N_CLS, LR, WD = 2, 1e-3, 1e-4
DA_WIDTH = (8, 16, 32, 64, 128)
# name -> (spatial, JAX model, port model, deep supervision)
MODELS = {
    "HDenseFormer_2D_16": ((32, 32),
                           lambda: JaxHDenseFormer(in_channels=2, n_cls=N_CLS, n_filters=16,
                                                   image_size=(32, 32), transformer_depth=4,
                                                   dropout=0.0, remat=False),
                           lambda: hdenseformer.HDenseFormer_2D_16(
                               2, N_CLS, (32, 32), 4, dropout=0.0, remat=False, device="cpu"),
                           True),
    "HDenseFormer_16": ((32, 32, 16),
                        lambda: JaxHDenseFormer(in_channels=2, n_cls=N_CLS, n_filters=16,
                                                image_size=(32, 32, 16), transformer_depth=4,
                                                dropout=0.0, remat=False),
                        lambda: hdenseformer.HDenseFormer_16(
                            2, N_CLS, (32, 32, 16), 4, dropout=0.0, remat=False, device="cpu"),
                        True),
    "da_unet": ((32, 32, 32),
                lambda: jdaunet.da_unet(32, 2, N_CLS, width=DA_WIDTH, dropout_flag=False),
                lambda: daunet.da_unet(32, 2, N_CLS, width=DA_WIDTH, dropout_flag=False,
                                       device="cpu"),
                False),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(spatial, k: int) -> dict:
    """K batches of 2 with a bright cube as the label, as JAX's test."""
    rng = np.random.RandomState(0)
    image = rng.randn(k, 2, *spatial, 2).astype(np.float32)
    cube = (slice(None), slice(None)) + tuple(slice(s // 4, 3 * s // 4) for s in spatial)
    labels = np.zeros((k, 2) + tuple(spatial), np.int64)
    labels[cube] = 1
    image[cube + (0,)] += 2.0
    return {"image": image, "label": np.eye(N_CLS, dtype=np.float32)[labels]}


def _setup(name: str):
    spatial, make_jax, make_port, ds = MODELS[name]
    jmodel = make_jax()
    variables = random_jax_variables(jmodel, jnp.zeros((1,) + spatial + (2,), jnp.float32),
                                     np.random.RandomState(0))
    stats = variables.get("batch_stats") or {}
    jstate0 = jstate.TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        tx=jstate.get_optimizer("Adam", LR, weight_decay=WD),
        model_state={"batch_stats": stats} if stats else {})
    port = make_port()
    load_jax_params(port, variables["params"], stats or None)
    opt = tstate.get_optimizer("Adam", LR, weight_decay=WD, params=port.parameters())
    return jstate0, TrainState(port, opt), get_loss("FocalLoss", use_ds=ds), \
        jlosses.get_loss("FocalLoss", use_ds=ds)


def _metrics(ms: dict) -> dict:
    return {k: np.asarray(v) for k, v in ms.items()}


def _assert_cms(got, ref) -> None:
    """Stacked confusion matrices, each within 0.1 % of its step's voxels."""
    for step, (g, r) in enumerate(zip(got, ref)):
        assert np.abs(g - r).sum() <= 1e-3 * r.sum(), (step, g, r)


@pytest.fixture(scope="module")
def scan_k3():
    """JAX's scanned K = 3 steps and the port's multi step."""
    name, k = "HDenseFormer_2D_16", 3
    batches = _batches(MODELS[name][0], k)
    jst, state, crit, jcrit = _setup(name)
    jst, jms = jloop.make_multi_train_step(jcrit, N_CLS)(
        jst, {n: jnp.asarray(v) for n, v in batches.items()}, jax.random.PRNGKey(0))
    state, ms = make_multi_train_step(crit, N_CLS)(
        state, {n: torch.from_numpy(v) for n, v in batches.items()}, 0)
    return dict(jms=_metrics(jax.device_get(jms)), ms=_metrics(ms), state=state,
                jparams=from_jax_params(jax.device_get(jst.params), model=state.model),
                jstep=int(jst.step))


def test_multi_step_losses_match_jax_scan(scan_k3):
    np.testing.assert_allclose(scan_k3["ms"]["loss"], scan_k3["jms"]["loss"], rtol=1e-5,
                               atol=1e-6)
    _assert_cms(scan_k3["ms"]["cm"], scan_k3["jms"]["cm"])
    assert scan_k3["state"].step == scan_k3["jstep"] == 3


def test_multi_step_params_match_jax_scan(scan_k3):
    named = dict(scan_k3["state"].model.named_parameters())
    for n, ref in scan_k3["jparams"].items():
        np.testing.assert_allclose(named[n].detach().numpy(), ref.numpy(), rtol=0, atol=1e-2,
                                   err_msg=n)


@pytest.fixture(scope="module", params=["HDenseFormer_16", "da_unet"])
def trajectory(request):
    """K = 4 single JAX steps against the port's 4 chained steps."""
    name, k = request.param, 4
    batches = _batches(MODELS[name][0], k)
    jst, state, crit, jcrit = _setup(name)
    jstep, jms = jloop.make_train_step(jcrit, N_CLS), []
    for i in range(k):
        jst, m = jstep(jst, {n: jnp.asarray(v[i]) for n, v in batches.items()},
                       jax.random.PRNGKey(0))
        jms.append(_metrics(jax.device_get(m)))
    state, ms = make_multi_train_step(crit, N_CLS)(
        state, {n: torch.from_numpy(v) for n, v in batches.items()}, 0)
    model = state.model
    return dict(name=name, ms=_metrics(ms),
                jms={n: np.stack([m[n] for m in jms]) for n in jms[0]},
                named=dict(model.named_parameters()), buffers=dict(model.named_buffers()),
                jparams=from_jax_params(jax.device_get(jst.params), model=model),
                jstats=from_jax_batch_stats(jax.device_get(jst.model_state).get(
                    "batch_stats", {})))


def test_trajectory_metrics_track_jax(trajectory):
    ms, jms = trajectory["ms"], trajectory["jms"]
    np.testing.assert_allclose(ms["loss"], jms["loss"], rtol=1e-4)
    np.testing.assert_allclose(ms["dice"], jms["dice"], rtol=1e-3)
    _assert_cms(ms["cm"], jms["cm"])


def test_trajectory_params_track_jax(trajectory):
    for n, ref in trajectory["jparams"].items():
        np.testing.assert_allclose(trajectory["named"][n].detach().numpy(), ref.numpy(),
                                   rtol=0, atol=1e-2, err_msg=n)


def test_trajectory_running_statistics_track_jax(trajectory):
    assert bool(trajectory["jstats"]) == (trajectory["name"] == "da_unet")
    for n, ref in trajectory["jstats"].items():
        err = float((trajectory["buffers"][n] - ref).norm())
        assert err <= 1e-2 * float(ref.norm()), (n, err, float(ref.norm()))


def test_multi_step_equals_seeded_single_steps_with_dropout():
    """On the CPU, K chained steps are the K single steps the trainer runs,
    dropout (0.5) drawn from ``step_seed(seed, step)``: bit for bit."""
    batches = {n: torch.from_numpy(v) for n, v in _batches((32, 32), 3).items()}
    runs = []
    for chained in (True, False):
        net = hdenseformer.HDenseFormer_2D_16(2, N_CLS, (32, 32), 4, dropout=0.5,
                                              remat=False, device="cpu")
        init_weights(net, torch.Generator().manual_seed(3))
        state = TrainState(net, tstate.get_optimizer("Adam", LR, weight_decay=WD,
                                                     params=net.parameters()), step=5)
        crit = get_loss("FocalLoss", use_ds=True)
        if chained:
            state, ms = make_multi_train_step(crit, N_CLS)(state, batches, 7)
            losses = ms["loss"]
        else:
            step, gen, losses = make_train_step(crit, N_CLS), torch.Generator(), []
            for i in range(3):
                gen.manual_seed(step_seed(7, state.step))
                state, m = step(state, {n: v[i] for n, v in batches.items()}, gen)
                losses.append(m["loss"])
            losses = torch.stack(losses)
        runs.append((losses, [p.detach().clone() for p in net.parameters()], state.step))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][2] == runs[1][2] == 8
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
