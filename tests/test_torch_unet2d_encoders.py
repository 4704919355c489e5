"""The 2-D baselines' encoders against JAX's, on CPU.

- unet on resnet34 and on resnet50: the eval forward, the train step and
  the aux head, held as tests/test_torch_unet2d.py holds the resnet18 nets
  (its helpers and bars);
- the ResNet stem's max pool (3x3, stride 2, a -inf pad of 1) on a ReLU
  output full of tied zeros: its value and its gradient against JAX's
  ``max_pool(jnp.pad(h, -inf), 3, 2)`` (``lax.reduce_window``, whose
  gradient is XLA's select-and-scatter), exactly: each window must route
  its gradient to the same element;
- ``load_torch_resnet_encoder`` against JAX's on a torchvision-format state
  dict (a plain torch ResNet-18 with torchvision's names, as
  tests/test_unet2d_pretrained.py builds it): the port's weights and
  running statistics equal what JAX's loader puts in its tree, exactly,
  also where conv1's 3 input channels are averaged into the model's 1; and
  the port's loaded encoder gives the torch model's features (1e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models.unet2d import Unet2D as JaxUnet2D  # noqa: E402
from hdenseformer_tpu.models.unet2d import (  # noqa: E402
    load_torch_resnet_encoder as jax_load_encoder,
)
from hdenseformer_tpu.ops.resize import max_pool as jax_max_pool  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models.unet2d import load_torch_resnet_encoder  # noqa: E402
from hdenseformer_tpu_torch.ops.resize import max_pool  # noqa: E402
from hdenseformer_tpu_torch.weights import (  # noqa: E402
    from_jax_batch_stats,
    from_jax_params,
    load_jax_params,
)
from test_torch_unet2d import (  # noqa: E402
    RUNS,
    build_pair,
    check_aux_head,
    check_eval_forward,
    check_train_step,
)
from test_unet2d_pretrained import TorchResNet18, _randomize_running_stats  # noqa: E402
from torch_port_util import random_jax_variables  # noqa: E402

NETS = [("unet", "resnet34"), ("unet", "resnet50")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=NETS, ids=["-".join(n) for n in NETS])
def pair(request):
    return build_pair(*request.param)


@pytest.mark.parametrize("run", RUNS)
def test_eval_forward_matches_jax(pair, run):
    check_eval_forward(pair, run)


@pytest.mark.parametrize("run", RUNS)
def test_train_step_matches_jax(pair, run):
    check_train_step(pair, run)


def test_aux_head_moves_by_the_coupled_decay(pair):
    check_aux_head(pair)


def test_stem_max_pool_routes_ties_as_jax():
    rng = np.random.RandomState(3)
    h = np.maximum(rng.randn(2, 17, 16, 5), 0).astype(np.float32)  # half the values tie at 0
    h[:, 4:11, 3:9] = 0.0  # whole windows of zeros
    h[0, 12, 12, 1] = h[0, 12, 13, 1] = h[0, 13, 12, 1] = 2.0  # a tie at the maximum
    dy = rng.randn(2, 9, 8, 5).astype(np.float32)

    def jax_pool(x):
        return jax_max_pool(jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)),
                                    constant_values=-jnp.inf), 3, 2)

    ref, vjp = jax.vjp(jax_pool, jnp.asarray(h))
    (ref_dx,) = vjp(jnp.asarray(dy))
    x = torch.from_numpy(h).requires_grad_()
    y = max_pool(x, 3, 2, padding=1)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref_dx))


@pytest.mark.parametrize("in_ch", [3, 1], ids=["rgb", "adapted_to_1"])
def test_load_torch_resnet_encoder_matches_jax(in_ch):
    torch.manual_seed(0)
    oracle = TorchResNet18(in_ch=3).eval()
    with torch.no_grad():
        _randomize_running_stats(oracle, np.random.RandomState(0))
    sd = oracle.state_dict()
    jmodel = JaxUnet2D("resnet18", 2, 1)
    variables = random_jax_variables(jmodel, jnp.zeros((1, 32, 32, in_ch)),
                                     np.random.RandomState(1))
    loaded = jax_load_encoder(variables, {k: v.numpy() for k, v in sd.items()})
    model = get_net("unet", in_ch, 2, (32, 32), encoder_name="resnet18", device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    assert load_torch_resnet_encoder(model, sd) is model
    want = from_jax_params(loaded["params"], model=model)
    want.update(from_jax_batch_stats(loaded["batch_stats"]))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert not torch.equal(got["encoder.conv1.weight"],
                           from_jax_params(variables["params"], model=model)[
                               "encoder.conv1.weight"])
    if in_ch == 3:  # the loaded encoder is the torch model
        x = np.random.RandomState(2).randn(1, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            feats = model.encoder(torch.from_numpy(x).permute(0, 2, 3, 1))
            ref = oracle.features(torch.from_numpy(x))
        for f, r in zip(feats, ref):
            np.testing.assert_allclose(f.permute(0, 3, 1, 2).numpy(), r.numpy(), rtol=1e-4,
                                       atol=1e-4)
