"""The port's training slice against the JAX package, on CPU, fp32.

Losses, optimizers and the LR schedule, in-step metrics, dropout, and one
whole train step of HDenseFormer (JAX's ``make_train_step`` body against
``train.loop.make_train_step``), each on the same seeded numpy inputs.
"""
import numpy as np
import pytest

# torch before jax's first use in this process, as tests/test_hdenseformer.py
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.metrics.batch import compute_dice as jcompute_dice  # noqa: E402
from hdenseformer_tpu.metrics.running import (  # noqa: E402
    RunningDice as JRunningDice,
    confusion_matrix_device as jconfusion,
)
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import _train_step_fn  # noqa: E402
from hdenseformer_tpu_torch.losses import losses as tlosses  # noqa: E402
from hdenseformer_tpu_torch.metrics.batch import compute_dice  # noqa: E402
from hdenseformer_tpu_torch.metrics.running import (  # noqa: E402
    AverageMeter,
    RunningDice,
    confusion_matrix_device,
)
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.models.layers import (  # noqa: E402
    dropout,
    dropout_keep,
    init_weights,
    self_attention,
)
from hdenseformer_tpu_torch.ops.mha import applies as mha_applies  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    TrainState,
    make_eval_step,
    make_train_step,
)
from hdenseformer_tpu_torch.utils.profiling import tracing  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params, load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402


def _onehot(labels, n_cls):
    return np.eye(n_cls, dtype=np.float32)[labels]


def _logits_and_target(seed, shape, n_cls=2):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, n_cls) * 3).astype(np.float32)
    return logits, _onehot(rng.randint(0, n_cls, shape), n_cls)


# --- (c) losses ---------------------------------------------------------------

LOSSES = {
    "focal_sum": (lambda m: m.focal_loss, {}),
    "focal_mean": (lambda m: m.focal_loss, {"reduction": "mean"}),
    "cross_entropy": (lambda m: m.cross_entropy_loss, {}),
    "cross_entropy_class_weight": (lambda m: m.cross_entropy_loss, {"weight": [0.3, 1.7]}),
}


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weight"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_its_gradient_match_jax(name, weighted):
    pick, kw = LOSSES[name]
    logits, target = _logits_and_target(1, (3, 6, 5, 4))
    sw = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    jfn = pick(jlosses)
    ref, ref_grad = jax.value_and_grad(
        lambda lg: jfn(lg, jnp.asarray(target), sample_weight=None if sw is None
                       else jnp.asarray(sw), **kw))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = pick(tlosses)(lt, torch.from_numpy(target),
                        sample_weight=None if sw is None else torch.from_numpy(sw), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_grad), rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref_grad).max()))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weight"])
@pytest.mark.parametrize("loss_fun", ["FocalLoss", "Cross_Entropy"])
def test_deep_supervision_loss_matches_jax(loss_fun, weighted):
    rng = np.random.RandomState(2)
    outs = [(rng.randn(2, s, s, s, 2) * 2).astype(np.float32) for s in (16, 8, 4, 2)]
    target = _onehot((rng.rand(2, 16, 16, 16) > 0.7).astype(np.int64), 2)
    sw = np.array([1.0, 0.0], np.float32) if weighted else None
    jfn = jlosses.get_loss(loss_fun, use_ds=True)
    ref, ref_grads = jax.value_and_grad(
        lambda o: jfn(o, jnp.asarray(target), sample_weight=None if sw is None
                      else jnp.asarray(sw)))([jnp.asarray(o) for o in outs])
    leaves = [torch.from_numpy(o).requires_grad_() for o in outs]
    tsw = None if sw is None else torch.from_numpy(sw)
    got = tlosses.get_loss(loss_fun, use_ds=True)(leaves, torch.from_numpy(target),
                                                  sample_weight=tsw)
    got.backward()
    # 2e-6, not 1e-6 (ROADMAP.md queue 3): on the unweighted focal sum over
    # 16,384 elements JAX's fp32 sum is 1.15e-6 off the float64 value, the
    # port's 6e-8
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=2e-6)
    for t, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(r).max()))


def test_get_loss_keeps_jax_names_and_raises_for_the_rest():
    logits, target = _logits_and_target(3, (2, 4, 4, 4))
    single = tlosses.get_loss("FocalLoss")
    assert float(single([torch.from_numpy(logits)], torch.from_numpy(target))) == pytest.approx(
        float(tlosses.focal_loss(torch.from_numpy(logits), torch.from_numpy(target))))
    # every JAX name is ported (values against JAX: tests/test_torch_objectives.py)
    assert sorted(tlosses.LOSS_REGISTRY) == sorted(jlosses.LOSS_REGISTRY)
    for name in jlosses.LOSS_REGISTRY:
        assert callable(tlosses.get_loss(name))
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.get_loss("nope")


# --- (e) optimizers and schedule ------------------------------------------------

SHAPES = {"w": (4, 3), "b": (3,), "k": (3, 3, 3, 2, 4), "s": (5,)}


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_matches_the_optax_chain(name):
    rng = np.random.RandomState(4)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(3)]
    lr, wd = 1e-3, 1e-2  # a decay large enough to show which tensors it reaches
    jst = jstate.TrainState.create(apply_fn=None, params={k: jnp.asarray(v)
                                                          for k, v in params.items()},
                                   tx=jstate.get_optimizer(name, lr, weight_decay=wd))
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tstate.get_optimizer(name, lr, weight_decay=wd, params=tparams.values())
    assert [len(g["params"]) for g in opt.param_groups] == [2, 2]  # decayed: w, k
    for g in grads:
        jst = jst.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jst.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_poly_lr_matches_jax():
    ours, ref = tstate.get_lr_scheduler("poly_lr", 1e-3, 10), jstate.get_lr_scheduler(
        "poly_lr", 1e-3, 10)
    assert [ours.step() for _ in range(13)] == [ref.step() for _ in range(13)]
    assert tstate.get_lr_scheduler(None, 1e-3) is None
    # the other four are ported (against JAX: tests/test_torch_objectives.py)
    for name in ("MultiStepLR", "CosineAnnealingLR", "CosineAnnealingWarmRestarts",
                 "ReduceLROnPlateau"):
        assert tstate.get_lr_scheduler(name, 1e-3).step() == 1e-3
    with pytest.raises(ValueError, match="unknown"):
        tstate.get_lr_scheduler("nope", 1e-3)


# --- (f) metrics -------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weight"])
@pytest.mark.parametrize("n_cls", [2, 3, 10])
def test_dice_and_confusion_matrix_match_jax_exactly(n_cls, weighted):
    rng = np.random.RandomState(n_cls)
    logits = rng.randn(3, 8, 6, 7, n_cls).astype(np.float32)
    labels = rng.randint(0, n_cls, (3, 8, 6, 7))
    labels[1] = 0  # a sample without foreground
    target = _onehot(labels, n_cls)
    sw = np.array([1.0, 1.0, 0.0], np.float32) if weighted else None
    jsw = None if sw is None else jnp.asarray(sw)
    tsw = None if sw is None else torch.from_numpy(sw)
    ref = jcompute_dice(jnp.asarray(logits), jnp.asarray(target), sample_weight=jsw)
    got = compute_dice(torch.from_numpy(logits), torch.from_numpy(target), sample_weight=tsw)
    assert float(got) == float(ref)
    pred = logits.argmax(-1)
    ref_cm = jconfusion(jnp.asarray(labels), jnp.asarray(pred), n_cls, sample_weight=jsw)
    got_cm = confusion_matrix_device(torch.from_numpy(labels), torch.from_numpy(pred), n_cls,
                                     sample_weight=tsw)
    np.testing.assert_array_equal(got_cm.numpy(), np.asarray(ref_cm))


def test_running_dice_and_average_meter_match_jax():
    rng = np.random.RandomState(5)
    ours, ref = RunningDice(range(3)), JRunningDice(range(3))
    for _ in range(3):
        gt, pr = rng.randint(0, 3, (4, 5, 6)), rng.randint(0, 3, (4, 5, 6))
        ours.update_matrix(gt, pr)
        ref.update_matrix(gt, pr)
        cm = confusion_matrix_device(torch.from_numpy(gt), torch.from_numpy(pr), 3)
        ours.update_from_matrix(cm)
        ref.update_from_matrix(np.asarray(cm))
    ours.update_matrix(np.zeros((2, 2)), np.ones((2, 2)))  # all background: skipped
    ref.update_matrix(np.zeros((2, 2)), np.ones((2, 2)))
    assert ours.compute_dice() == ref.compute_dice()
    meter = AverageMeter()
    for v, n in ((2.0, 1), (5.0, 3)):
        meter.update(v, n)
    assert (meter.val, meter.avg, meter.count) == (5.0, 4.25, 4)


# --- (h) dropout ----------------------------------------------------------------------

def test_dropout_keeps_one_minus_p_and_scales():
    p, n = 0.3, 100_000
    x = torch.ones(n)
    y = dropout(x, p, True, torch.Generator().manual_seed(0))
    kept = y != 0
    share = float(kept.float().mean())
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) <= 3 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))


def test_dropout_is_reproducible_and_off_in_eval():
    x = torch.randn(4, 50, 32, generator=torch.Generator().manual_seed(1))
    a = dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    c = dropout(x, 0.5, True, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert dropout(x, 0.5, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    assert torch.equal(dropout(x, 1.0, True, torch.Generator()), torch.zeros_like(x))
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, True, None)


def test_dropout_keep_is_the_mask_that_dropout_draws():
    """The attention's keep mask (``dropout_keep``) is dropout's own draw:
    the same mask from the same generator state, and the generator left in
    the same state."""
    shape, p = (2, 3, 9, 9), 0.1
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    keep = dropout_keep(shape, p, "cpu", ga)
    y = dropout(torch.ones(shape), p, True, gb)
    assert keep.dtype == torch.bool and torch.equal(keep, y != 0)
    assert torch.equal(ga.get_state(), gb.get_state())
    with pytest.raises(ValueError, match="Generator"):
        dropout_keep(shape, p, "cpu", None)


@pytest.mark.parametrize("device,dtype,width,fused", [
    ("cuda", torch.bfloat16, 64, True), ("cpu", torch.bfloat16, 64, False),
    ("cuda", torch.bfloat16, 32, False), ("cuda", torch.float32, 64, False),
])
def test_attention_takes_the_kernel_only_on_cuda_bf16_at_width_64(device, dtype, width, fused):
    """``self_attention``'s dispatch: the fused kernel for bf16 CUDA heads of
    64, the plain math everywhere else; on the CPU the plain path runs and
    counts its materialised scores."""
    assert mha_applies(device, dtype, width) is fused
    if device != "cpu":
        return
    b, n, heads = 2, 5, 2
    qkv = torch.randn(b, n, 3 * heads * width, generator=torch.Generator().manual_seed(0))
    with tracing() as recording:
        out = self_attention(qkv.to(dtype), heads, 0.1, True, torch.Generator().manual_seed(1))
    assert out.shape == (b, n, heads * width) and out.dtype == dtype
    assert recording.counters == {"attention.calls": 1,
                                  "attention.score_elements": b * heads * n * n,
                                  "dropout.drawn_elements": b * heads * n * n}


def test_model_dropout_needs_a_generator_in_training():
    net = HDenseFormer(2, 2, 4, (32, 32, 32), 4, device="cpu")
    assert not net.training  # built in eval mode, as flax's train=False default
    init_weights(net, torch.Generator().manual_seed(0))
    x = torch.randn(1, 32, 32, 32, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        eval_out = net(x)
        net.train()
        with pytest.raises(ValueError, match="Generator"):
            net(x)
        a = net(x, generator=torch.Generator().manual_seed(3))
        b = net(x, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.allclose(a[0], eval_out[0])


# --- (g) one train step against JAX -----------------------------------------------------

SIZE, DEPTH, NF, N_CLS, LR = (32, 32, 32), 4, 8, 2, 1e-3


@pytest.fixture(scope="module")
def step_pair():
    """One train step of HDenseFormer (nf 8, 32^3, depth 4, dropout 0, fine
    grid, batch 2 with weight [1, 0]) in JAX and in the port, same weights."""
    jmodel = JaxHDenseFormer(in_channels=2, n_cls=N_CLS, n_filters=NF, image_size=SIZE,
                             transformer_depth=DEPTH, dropout=0.0, remat=False, s2d=False)
    x0 = jnp.zeros((1,) + SIZE + (2,), jnp.float32)
    params = random_jax_params(jmodel, x0, np.random.RandomState(0))
    rng = np.random.RandomState(1)
    image = rng.randn(2, *SIZE, 2).astype(np.float32)
    labels = np.zeros((2, *SIZE), np.int64)
    labels[:, 8:20, 10:24, 6:18] = 1
    batch = {"image": image, "label": _onehot(labels, N_CLS),
             "weight": np.array([1.0, 0.0], np.float32)}

    criterion = jlosses.get_loss("FocalLoss", use_ds=True)
    state = jstate.TrainState.create(apply_fn=jmodel.apply, params=params,
                                     tx=jstate.get_optimizer("Adam", LR, weight_decay=1e-4))
    body = _train_step_fn(criterion, N_CLS)

    @jax.jit
    def grads_and_step(state, batch, key):
        def loss_fn(p):
            outs = state.apply_fn({"params": p}, batch["image"], train=True,
                                  rngs={"dropout": key})
            return criterion(outs, batch["label"], sample_weight=batch["weight"])

        grads = jax.grad(loss_fn)(state.params)
        new_state, metrics = body(state, batch, key)
        return grads, new_state.params, metrics

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads, jparams, jmetrics = jax.device_get(grads_and_step(state, jbatch,
                                                              jax.random.PRNGKey(0)))

    model = HDenseFormer(2, N_CLS, NF, SIZE, DEPTH, dropout=0.0, device="cpu")
    load_jax_params(model, params)
    opt = tstate.get_optimizer("Adam", LR, weight_decay=1e-4, params=model.parameters())
    step = make_train_step(tlosses.get_loss("FocalLoss", use_ds=True), N_CLS)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state_t, metrics = step(TrainState(model, opt), tbatch, None)
    return dict(jgrads=from_jax_params(jgrads), jparams=from_jax_params(jparams),
                params0=from_jax_params(params),
                jmetrics=jmetrics, state=state_t, metrics=metrics, batch=tbatch)


def test_train_step_loss_and_metrics_match_jax(step_pair):
    jm, m = step_pair["jmetrics"], step_pair["metrics"]
    assert step_pair["state"].step == 1 and step_pair["state"].model.training
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert float(m["dice"]) == float(jm["dice"])
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(jm["cm"]))
    assert int(m["cm"].sum()) == 32 ** 3  # the masked sample is left out


# Tensors held to looser bars than max|d| <= 1e-3 max|g_jax|, each logged in
# ROADMAP.md queue 3 with its observed difference:
# - the UpConvs' conv biases sit under an InstanceNorm without affine, so
#   their true gradient is zero and both frameworks return rounding noise
#   (observed max|g| 4e-8 of the largest gradient): held to 1e-6 of it;
# - block_3_2_right's conv weight (decoder level 3, 8^3 voxels a channel):
#   observed 1.8e-3 (its L2 difference 4.9e-4, as the other tensors'), a
#   few ReLU-mask flips under the frameworks' fp32 rounding, each weighing
#   more on the small grid: held to 2.5e-3.
ZERO_GRADIENT = ("deep_conv.conv.bias", "up1.conv.bias", "up2.conv.bias", "up3.conv.bias")
LOOSER = {"block_3_2_right.conv.weight": 2.5e-3}


def test_train_step_gradients_match_jax(step_pair):
    named = dict(step_pair["state"].model.named_parameters())
    assert sorted(named) == sorted(step_pair["jgrads"])
    top = max(float(g.abs().max()) for g in step_pair["jgrads"].values())
    for name, ref in step_pair["jgrads"].items():
        got = named[name].grad
        if name in ZERO_GRADIENT:
            assert max(float(ref.abs().max()), float(got.abs().max())) <= 1e-6 * top, name
            continue
        err = float((got - ref).abs().max())
        assert err <= LOOSER.get(name, 1e-3) * float(ref.abs().max()), (name, err)


def test_train_step_update_matches_jax(step_pair):
    # Adam's first step moves each parameter by about lr against the sign of
    # what it is given, the gradient plus the coupled decay. 1e-5 where that
    # is clear of the gradients' own bar (1e-3 of the tensor's max: sign flips
    # were observed up to 1.5e-4 of it, ROADMAP.md queue 3), 2 lr elsewhere
    # and in the tensors whose gradient is rounding noise
    named = dict(step_pair["state"].model.named_parameters())
    for name, ref in step_pair["jparams"].items():
        p0 = step_pair["params0"][name]
        g = (step_pair["jgrads"][name] + (1e-4 * p0 if p0.dim() > 1 else 0.0)).abs()
        clear = g > 1e-3 * float(g.max())
        d = (named[name].detach() - ref).abs()
        if name not in ZERO_GRADIENT:
            assert float(d[clear].max()) <= 1e-5, name
        assert float(d.max()) <= 2 * LR, name


def test_eval_step_runs_without_gradients(step_pair):
    state = step_pair["state"]
    out = make_eval_step(tlosses.get_loss("FocalLoss", use_ds=True), N_CLS)(
        state, step_pair["batch"])
    assert not state.model.training and not out["loss"].requires_grad
    assert torch.isfinite(out["loss"]) and out["cm"].shape == (N_CLS, N_CLS)
    assert int(out["cm"].sum()) == 32 ** 3
