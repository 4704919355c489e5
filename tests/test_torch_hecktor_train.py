"""One Hecktor20Top1 train step of the port against JAX's ``_train_step_fn``.

The port's step used to call every model with ``generator=``, which
Hecktor20Top1's ``forward`` did not take: the step raised ``TypeError``
and no real path ran the half-shift's backward. Now the model takes an
unused generator, as JAX applies every model with ``rngs=``. nf 8 at 16^3
(the size tests/test_torch_hecktor.py uses), level 1 packed (``s2d=None``),
FocalLoss without deep supervision (the config's rule for a net without
'DenseFormer' in its name), Adam with coupled L2, batch 2 with weight
[1, 0]; the bars of tests/test_torch_train.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models.hecktor20top1 import Hecktor20Top1 as JaxHecktor  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu.train.loop import _train_step_fn  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models.hecktor20top1 import Hecktor20Top1  # noqa: E402
from hdenseformer_tpu_torch.train import state as tstate  # noqa: E402
from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params, load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

SIZE, NF, N_CLS, LR = (16, 16, 16), 8, 2, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's cores,
    and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def step_pair():
    jmodel = JaxHecktor(in_channels=2, n_cls=N_CLS, n_filters=NF, s2d=None)
    params = random_jax_params(jmodel, jnp.zeros((1,) + SIZE + (2,), jnp.float32),
                               np.random.RandomState(0))
    rng = np.random.RandomState(1)
    labels = np.zeros((2, *SIZE), np.int64)
    labels[:, 4:10, 5:12, 3:9] = 1
    batch = {"image": rng.randn(2, *SIZE, 2).astype(np.float32),
             "label": np.eye(N_CLS, dtype=np.float32)[labels],
             "weight": np.array([1.0, 0.0], np.float32)}

    criterion = jlosses.get_loss("FocalLoss")
    state = jstate.TrainState.create(apply_fn=jmodel.apply, params=params,
                                     tx=jstate.get_optimizer("Adam", LR, weight_decay=1e-4))
    jparams, jmetrics = jax.device_get(jax.jit(_train_step_fn(criterion, N_CLS))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0)))
    jparams = jparams.params

    model = Hecktor20Top1(2, N_CLS, NF, SIZE, s2d=None, device="cpu")
    assert model.packed
    load_jax_params(model, params)
    opt = tstate.get_optimizer("Adam", LR, weight_decay=1e-4, params=model.parameters())
    step = make_train_step(get_loss("FocalLoss"), N_CLS)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # a generator, as the trainer passes every model: the call that raised
    state_t, metrics = step(TrainState(model, opt), tbatch, torch.Generator().manual_seed(0))
    return dict(jparams=from_jax_params(jparams), params0=from_jax_params(params),
                jmetrics=jmetrics, state=state_t, metrics=metrics)


def test_hecktor_step_loss_and_metrics_match_jax(step_pair):
    jm, m = step_pair["jmetrics"], step_pair["metrics"]
    assert step_pair["state"].step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert float(m["dice"]) == pytest.approx(float(jm["dice"]), abs=1e-6)
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(jm["cm"]))
    assert int(m["cm"].sum()) == 16 ** 3  # the masked sample is left out


def test_hecktor_step_update_matches_jax(step_pair):
    # tests/test_torch_train.py's bar: 1e-5 where the decayed gradient is
    # clear of the gradients' own bar (1e-3 of the tensor's largest), 2 lr
    # everywhere: Adam's first step moves a parameter by about lr against the
    # sign of what it is given, and where that is near 0 the sign may flip.
    # (The SE norms' gates on level 5's 1^3 grid get no gradient.)
    named = dict(step_pair["state"].model.named_parameters())
    assert sorted(named) == sorted(step_pair["jparams"])
    for name, ref in step_pair["jparams"].items():
        p0 = step_pair["params0"][name]
        g = (named[name].grad + (1e-4 * p0 if p0.dim() > 1 else 0.0)).abs()
        clear = g > 1e-3 * float(g.max())
        d = (named[name].detach() - ref).abs()
        if bool(clear.any()):
            assert float(d[clear].max()) <= 1e-5, name
        assert float(d.max()) <= 2 * LR, name


def test_hecktor_trains_after_serving_in_one_process():
    """The packed convs' cached gather index was built in the first caller's
    mode: after a serving call (inference mode) it was an inference tensor,
    and the next train step's backward could not save it."""
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.ops import s2d

    s2d._gather_index.cache_clear()
    model = Hecktor20Top1(2, N_CLS, NF, SIZE, s2d=None, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn(2, *SIZE, 2, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():  # as predict_volume serves
        model.eval()(x)
    label = torch.zeros(2, *SIZE, N_CLS)
    label[..., 0] = 1
    opt = tstate.get_optimizer("Adam", LR, params=model.parameters())
    _, out = make_train_step(get_loss("FocalLoss"), N_CLS)(TrainState(model, opt),
                                                           {"image": x, "label": label}, None)
    assert torch.isfinite(out["loss"])
    assert all(p.grad is not None for p in model.parameters())
