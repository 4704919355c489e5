"""HDenseFormer_2D against JAX's, on CPU: 32^2, n_filters 8, depth 4, 3
modalities (PI-CAI22's channels), 2 classes, batch 2.

- The eval forward, fp32, against JAX's fine grid (``s2d=False``) within
  1e-5 of each head's logit scale, and against JAX's default (``s2d=None``:
  levels 0-2 space-to-depth packed at full rank at n_filters 8) within
  rtol = atol = 1e-4, the bar of JAX's own packed-vs-fine test: a user's
  JAX checkpoint was trained on that default.
- One train step (dropout 0, fine grid, the second sample masked out by
  ``weight``; deep-supervision FocalLoss, Adam with coupled L2 1e-4, lr
  1e-3) against JAX's ``_train_step_fn``: the loss within 1e-4 relative,
  and tests/test_torch_zoo_train.py's per-tensor gradient bars: each
  gradient within the larger of 1e-3 and 3x the two frameworks' fp32 errors
  (each against its own float64 step) relative to its largest; the
  UpConvs' conv biases, whose true gradient is zero under a norm without
  affine, within 1e-6 of the model's largest gradient; each updated
  parameter within 1e-5 where its gradient is clear of its bar, 2 lr
  everywhere. The two float64 steps agree within 1e-6 of each tensor's
  largest gradient, the losses within 1e-7 (JAX's bilinear matrices stay
  float32).
- Remat: a step with ``remat=True`` (dropout 0.5) equals the plain step.
- The weight bridge on a 2-D tree: 4-D kernels, the transposed convs
  flipped on both axes, the ``attns`` banks split per modality.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models import layers as jl  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import _train_step_fn  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models import layers as tl  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params, load_jax_params  # noqa: E402
from torch_port_util import jax_float64, random_jax_params, torch_float64  # noqa: E402

SIZE, NF, DEPTH, IN_CH, N_CLS, LR, WD = (32, 32), 8, 4, 3, 2, 1e-3, 1e-4
ZERO_GRADIENT = ("deep_conv.conv.bias", "up1.conv.bias", "up2.conv.bias", "up3.conv.bias")
# the JAX modules of the fine step that cast to jnp.float32
F64_MODULES = tuple(f"hdenseformer_tpu.{m}" for m in (
    "models.layers", "models.hdenseformer", "ops.fused_norm", "ops.dense_attention",
    "losses.losses", "train.loop", "train.state"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_model(s2d, dropout=0.0):
    return JaxHDenseFormer(in_channels=IN_CH, n_cls=N_CLS, n_filters=NF, image_size=SIZE,
                           transformer_depth=DEPTH, dropout=dropout, remat=False, s2d=s2d)


@pytest.fixture(scope="module")
def params():
    x0 = jnp.zeros((1,) + SIZE + (IN_CH,), jnp.float32)
    return random_jax_params(_jax_model(False), x0, np.random.RandomState(0))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    labels = np.zeros((2,) + SIZE, np.int64)
    labels[:, 9:22, 7:25] = 1
    return {"image": rng.randn(2, *SIZE, IN_CH).astype(np.float32),
            "label": np.eye(N_CLS, dtype=np.float32)[labels],
            "weight": np.array([1.0, 0.0], np.float32)}


def _build(params):
    """The port's model at NF (get_net builds 16 and 32; 8 is HDenseFormer's own)."""
    model = HDenseFormer(IN_CH, N_CLS, NF, SIZE, DEPTH, dropout=0.0, device="cpu")
    return load_jax_params(model, params)


def _jax_step(params, batch, f64):
    """JAX's eval forward (fine grid) and one train step, compiled together;
    in float64 with ``f64``. Returns (outs, grads, new params, metrics)."""
    cast = (lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)) if f64 \
        else (lambda t: t)
    jmodel = _jax_model(False)
    with jax_float64(F64_MODULES) if f64 else contextlib.nullcontext():
        criterion = jlosses.get_loss("FocalLoss", use_ds=True)
        state = jstate.TrainState.create(apply_fn=jmodel.apply, params=cast(params),
                                         tx=jstate.get_optimizer("Adam", LR, weight_decay=WD))
        body = _train_step_fn(criterion, N_CLS)

        @jax.jit
        def run(state, batch):
            outs = jmodel.apply({"params": state.params}, batch["image"])
            new_state, metrics = body(state, batch, jax.random.PRNGKey(0))
            # Adam's first moment after one step is (1 - b1) (g + WD p), the
            # coupled decay on tensors of rank 2 and more: the step's gradient
            mu = new_state.opt_state.inner_state[1].mu
            grads = jax.tree_util.tree_map(
                lambda m, p: m / 0.1 - (WD * p if p.ndim > 1 else 0.0), mu, state.params)
            return outs, grads, new_state.params, metrics

        return jax.device_get(run(state, {k: jnp.asarray(v) for k, v in cast(batch).items()}))


def _port_step(params, batch, f64):
    model = _build(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if f64:
        model.double()
        tbatch = {k: v.double() for k, v in tbatch.items()}
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = tstate.get_optimizer("Adam", LR, weight_decay=WD, params=model.parameters())
    step = make_train_step(get_loss("FocalLoss", use_ds=True), N_CLS)
    with torch_float64() if f64 else contextlib.nullcontext():
        _, metrics = step(TrainState(model, opt), tbatch, None)
    return model, params0, metrics


@pytest.fixture(scope="module")
def step_pair(params, batch):
    jouts, jgrads, jparams, jmetrics = _jax_step(params, batch, False)
    _, jgrads64, _, jmetrics64 = _jax_step(params, batch, True)
    model, params0, metrics = _port_step(params, batch, False)
    model64, _, metrics64 = _port_step(params, batch, True)

    def in_float64(tree):
        hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
        lo = from_jax_params(jax.tree_util.tree_map(lambda a, h: np.asarray(a - h, np.float32),
                                                    tree, hi), model=model)
        return {k: v.double() + lo[k].double() for k, v in from_jax_params(
            hi, model=model).items()}

    return dict(model=model, params0=params0, metrics=metrics, jmetrics=jmetrics, jouts=jouts,
                jgrads=from_jax_params(jgrads, model=model),
                jparams=from_jax_params(jparams, model=model),
                jgrads64=in_float64(jgrads64), jmetrics64=jmetrics64, metrics64=metrics64,
                grads64={n: p.grad for n, p in model64.named_parameters()})


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def test_forward_matches_jax_fine(params, batch, step_pair):
    model = _build(params)
    with torch.inference_mode():
        got = model(torch.from_numpy(batch["image"]))
    assert [tuple(g.shape) for g in got] == [(2, 32 // 2 ** i, 32 // 2 ** i, N_CLS)
                                             for i in range(4)]
    for g, r in zip(got, step_pair["jouts"]):
        assert g.dtype == torch.float32
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def packed_outs(params, batch):
    """JAX's default ``s2d=None`` forward, which packs every level of at most
    32 channels in 2-D: the same parameter tree, another execution."""
    return jax.jit(_jax_model(None).apply)({"params": params}, jnp.asarray(batch["image"]))


def test_forward_matches_jax_default_packed(params, batch, packed_outs):
    ref = packed_outs
    model = _build(params)
    with torch.inference_mode():
        got = model(torch.from_numpy(batch["image"]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_train_step_loss_matches_jax(step_pair):
    np.testing.assert_allclose(float(step_pair["metrics"]["loss"]),
                               float(step_pair["jmetrics"]["loss"]), rtol=1e-4)
    np.testing.assert_array_equal(step_pair["metrics"]["cm"].numpy(),
                                  np.asarray(step_pair["jmetrics"]["cm"]))
    # float64: 1e-7, since JAX's bilinear matrices (UpConv) stay float32
    np.testing.assert_allclose(float(step_pair["metrics64"]["loss"]),
                               float(step_pair["jmetrics64"]["loss"]), rtol=1e-7)


def bar(run, name) -> float:
    """1e-3, or 3x the two frameworks' fp32 errors (each against its own
    float64 step) where larger, relative to the tensor's largest gradient."""
    port = dict(run["model"].named_parameters())[name].grad
    top = max(float(run["jgrads"][name].abs().max()), 1e-30)
    noise = _err(run["jgrads"][name], run["jgrads64"][name]) + _err(port, run["grads64"][name])
    return max(1e-3, 3 * noise / top)


def test_train_step_gradients_match_jax(step_pair):
    named = dict(step_pair["model"].named_parameters())
    assert sorted(named) == sorted(step_pair["jgrads"])
    top = max(float(g.abs().max()) for g in step_pair["jgrads"].values())
    for name, ref in step_pair["jgrads"].items():
        got = named[name].grad
        if name in ZERO_GRADIENT:
            assert max(float(ref.abs().max()), float(got.abs().max())) <= 1e-6 * top, name
            continue
        err = _err(got, ref) / float(ref.abs().max())
        assert err <= bar(step_pair, name), (name, err)
        err64 = _err(step_pair["grads64"][name], step_pair["jgrads64"][name])
        assert err64 <= 1e-6 * float(ref.abs().max()), (name, err64)


def test_train_step_update_matches_jax(step_pair):
    named = dict(step_pair["model"].named_parameters())
    for name, ref in step_pair["jparams"].items():
        p0 = step_pair["params0"][name]
        g = (step_pair["jgrads"][name] + (WD * p0 if p0.dim() > 1 else 0.0)).abs()
        d = (named[name].detach() - ref).abs()
        if name not in ZERO_GRADIENT:
            clear = g > bar(step_pair, name) * float(g.max())
            assert float(d[clear].max()) <= 1e-5, name
        assert float(d.max()) <= 2 * LR, name


def test_remat_step_equals_the_plain_step():
    """remat=True (get_net's default) against remat=False, dropout 0.5 from
    one seed: the same loss, gradients within 1e-6 of the largest, and the
    generator left in one state."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, *SIZE, IN_CH, generator=g)
    label = torch.zeros(2, *SIZE, N_CLS)
    label[..., 0] = 1
    label[:, 8:20, 10:22] = torch.tensor([0.0, 1.0])
    runs = {}
    for remat in (True, False):
        net = get_net("HDenseFormer_2D_16", IN_CH, N_CLS, SIZE, transformer_depth=DEPTH,
                      remat=remat, device="cpu").train()
        init_weights(net, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(3)
        loss = get_loss("FocalLoss", use_ds=True)(net(x, generator=gen), label)
        loss.backward()
        runs[remat] = (float(loss), {n: p.grad for n, p in net.named_parameters()},
                       gen.get_state())
    (loss1, g1, s1), (loss0, g0, s0) = runs[True], runs[False]
    assert loss1 == pytest.approx(loss0, rel=1e-6, abs=0) and torch.equal(s1, s0)
    top = max(float(v.abs().max()) for v in g0.values())
    for name, v in g0.items():
        assert float((g1[name] - v).abs().max()) <= 1e-6 * top, name


LAYERS_2D = {
    "conv3": (lambda: jl.Conv(6, 3, 1, 1), lambda: tl.Conv(3, 6, 3, 1, 1, ndim=2),
              (2, 7, 5, 3), ""),
    "conv_dilated": (lambda: jl.Conv(5, 3, 1, 2, dilation=2),
                     lambda: tl.Conv(4, 5, 3, 1, 2, dilation=2, ndim=2), (2, 9, 8, 4), ""),
    "patch_embed": (lambda: jl.Conv(8, 16, 16, padding=0, as_matmul=True),
                    lambda: tl.Conv(1, 8, 16, 16, 0, ndim=2), (2, 32, 48, 1), ""),
    "conv_transpose": (lambda: jl.ConvTranspose(6, 3, 2, 1, 1),
                       lambda: tl.ConvTranspose(4, 6, 3, 2, 1, 1, ndim=2), (2, 5, 6, 4),
                       "upconv_1"),
    "basic_conv": (lambda: jl.BasicConv(6), lambda: tl.BasicConv(3, 6, ndim=2), (2, 6, 7, 3), ""),
    "up_conv": (lambda: jl.UpConv(5), lambda: tl.UpConv(3, 5, ndim=2), (2, 4, 6, 3), ""),
}


@pytest.mark.parametrize("case", sorted(LAYERS_2D))
def test_2d_layer_matches_jax(case):
    """Each 2-D layer through the weight bridge: 4-D kernels to (out, in, kh,
    kw), the transposed conv's flipped on both axes."""
    rng = np.random.RandomState(4)
    make_jax, make_port, shape, prefix = LAYERS_2D[case]
    x = rng.randn(*shape).astype(np.float32)
    module = make_jax()
    p = random_jax_params(module, jnp.asarray(x), rng)
    ref = np.asarray(module.apply({"params": p}, jnp.asarray(x)))
    port = make_port()
    port.load_state_dict(from_jax_params(p, prefix=prefix), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_weight_bridge_on_a_2d_tree(params):
    """The HDenseFormer_2D tree: each modality's bank of the 5-D stacked
    patch embed becomes a (32, 1, 16, 16) kernel; the transposed convs are
    flipped on both spatial axes; the other kernels transposed."""
    state = from_jax_params(params)
    model = _build(params)
    assert sorted(state) == sorted(model.state_dict())
    kernel = params["attns"]["patch_embed"]["kernel"]
    assert kernel.shape == (IN_CH, 16, 16, 1, 4 * NF)
    for m in range(IN_CH):
        np.testing.assert_array_equal(state[f"attns.{m}.patch_embed.weight"].numpy(),
                                      kernel[m].transpose(3, 2, 0, 1))
    up = params["upconv_1"]["kernel"]
    np.testing.assert_array_equal(state["upconv_1.weight"].numpy(),
                                  up[::-1, ::-1].transpose(2, 3, 0, 1))
    conv = params["block_1_1_left"]["conv"]["kernel"]
    np.testing.assert_array_equal(state["block_1_1_left.conv.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
