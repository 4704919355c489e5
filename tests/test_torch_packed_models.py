"""The port's packed levels against the JAX package's, whole models, on the CPU.

JAX's default (``s2d=None``) packs HDenseFormer's levels of at most 32
channels (levels 0-1 of ``_16``): over (H, W) in 3-D, at full rank in 2-D;
Hecktor20Top1 with ``s2d={1: True, 2: (2,)}`` packs level 1 at full rank and
level 2 over W. Random JAX parameters of the packed JAX model (its tree has
the fine model's names) are loaded by ``weights.load_jax_params``: the
weight bridge on a packed tree. Inputs are made from a numpy seed; fp32.

Bars. Logits: within 1e-5 of each head's largest magnitude (fp32 sums in
another order, XLA's convs against oneDNN's). Gradients of one loss (sum
over heads of <logits, r> for fixed random r): within 1e-3 of each tensor's
largest magnitude. Each bar is raised to 3x how far JAX's own result moves
under rounding alone: the larger of its move when the input moves by 1e-6
(relative), as tests/test_torch_daunet.py measures it, and the difference
between JAX's packed and fine layouts of the same weights. At these sizes
random weights leave the deepest InstanceNorms a few values each, and the
loss's gradients are sums of many terms of either sign: a nudge of 1e-6
moves JAX's own HDenseFormer_16 gradients at 32^3 by up to 1.2e-2 of a
tensor's largest magnitude, and its two layouts differ by up to 1.5e-2
(block_2_1_right.conv.weight), both far above 1e-3. The conv biases
under an InstanceNorm without affine (the UpConvs') have a true gradient of
zero, and what either framework returns there is rounding noise: they are
left out. The port's packed model also equals its own fine one on the same
weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models import hecktor20top1 as jh  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models import hecktor20top1 as th  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params, load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

IN_CH, N_CLS, DEPTH = 2, 2, 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ZERO_GRADIENT = ("deep_conv.conv.bias", "up1.conv.bias", "up2.conv.bias", "up3.conv.bias")


def _jax_runner(model, rs):
    """JAX's outputs and its gradient of sum_h <out_h, r_h> in the params
    (the port's names and layouts), as a function of (params, x)."""

    @jax.jit
    def run(p, x):
        def loss(p):
            out = model.apply({"params": p}, x)
            out = out if isinstance(out, (list, tuple)) else [out]
            return sum(jnp.sum(o * r) for o, r in zip(out, rs)), out

        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return out, grads

    def call(params, x):
        out, grads = jax.device_get(run(params, jnp.asarray(x)))
        return [np.asarray(o) for o in out], from_jax_params(grads)

    return call


def _jax_reference(packed, fine, params, x, rs):
    """JAX's packed outputs and gradients, and how far rounding alone moves
    each (see the module docstring): (outputs, grads, output spreads, grad
    spreads)."""
    run = _jax_runner(packed, rs)
    out, grads = run(params, x)
    moved = x * (1 + 1e-6 * np.random.RandomState(9).randn(*x.shape)).astype(np.float32)
    others = [run(params, moved), _jax_runner(fine, rs)(params, x)]
    spread = [max(float(np.abs(o - alt[0][i]).max()) for alt in others)
              for i, o in enumerate(out)]
    gspread = {n: max(float((g - alt[1][n]).abs().max()) for alt in others)
               for n, g in grads.items()}
    return out, grads, spread, gspread


def _port_grads(port, x, rs):
    out = port(torch.from_numpy(x))
    out = out if isinstance(out, (list, tuple)) else [out]
    sum((o * torch.from_numpy(np.asarray(r))).sum() for o, r in zip(out, rs)).backward()
    return [o.detach() for o in out], {n: p.grad for n, p in port.named_parameters()}


def _assert_outputs(got, ref, spread, rel=1e-5):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        atol = max(rel * float(np.abs(r).max()), 3 * spread[i])
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol)


def _assert_grads(got, want, spread, rel=1e-3):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        if name in ZERO_GRADIENT:
            continue
        ref = ref.numpy()
        atol = max(rel * float(np.abs(ref).max()), 3 * spread[name]) + 1e-12
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=0, atol=atol, err_msg=name)


HDF_CASES = {"3d_16_32cube": (32, 32, 32), "2d_16_64sq": (64, 64)}


@pytest.mark.parametrize("case", sorted(HDF_CASES))
def test_hdenseformer16_default_packing_matches_jax(case):
    size = HDF_CASES[case]
    jmodel, jfine = (JaxHDenseFormer(in_channels=IN_CH, n_cls=N_CLS, n_filters=16,
                                     image_size=size, transformer_depth=DEPTH, remat=False,
                                     s2d=s2d) for s2d in (None, False))
    x = np.random.RandomState(1).randn(2, *size, IN_CH).astype(np.float32)
    params = random_jax_params(jmodel, jnp.zeros((1,) + size + (IN_CH,)),
                               np.random.RandomState(0))
    name = "HDenseFormer_16" if len(size) == 3 else "HDenseFormer_2D_16"
    port = get_net(name, IN_CH, N_CLS, size, DEPTH, remat=False, device="cpu")
    assert port.packed == (((1, 2), (1, 2), None) if len(size) == 3 else ((0, 1), (0, 1), None))
    load_jax_params(port, params)
    rng = np.random.RandomState(2)
    rs = [rng.randn(2, *(s // 2 ** k for s in size), N_CLS).astype(np.float32)
          for k in range(4)]
    ref, grads, spread, gspread = _jax_reference(jmodel, jfine, params, x, rs)
    got, got_grads = _port_grads(port, x, rs)
    _assert_outputs(got, ref, spread)
    _assert_grads(got_grads, grads, gspread)
    # the same weights on the port's fine grid
    fine = get_net(name, IN_CH, N_CLS, size, DEPTH, remat=False, s2d=False, device="cpu")
    assert fine.packed == (None, None, None)
    load_jax_params(fine, params)
    with torch.inference_mode():
        _assert_outputs(fine(torch.from_numpy(x)), ref, spread)


def test_hdenseformer_packs_as_jax_decides():
    """JAX's ``lvl_dims`` on the port's image_size, and an input the model
    was not built to pack raises."""
    cases = [(None, 16, (32, 32, 32), ((1, 2), (1, 2), None)),
             (None, 32, (32, 32, 32), ((1, 2), None, None)),
             (None, 16, (30, 30, 30), ((1, 2), None, None)),  # level 1's 15 is odd
             (True, 16, (32, 32, 32), ((0, 1, 2),) * 3),
             ((0, 2), 32, (32, 32, 32), ((0, 1, 2), None, None)),  # level 2 is 128 channels
             ({1: (2,)}, 16, (32, 32, 32), (None, (2,), None)),
             (False, 16, (32, 32, 32), (None, None, None))]
    for s2d, nf, size, want in cases:
        net = HDenseFormer(IN_CH, N_CLS, nf, size, DEPTH, s2d=s2d, device="cpu")
        assert net.packed == want, (s2d, nf, size)
    net = HDenseFormer(IN_CH, N_CLS, 16, (32, 32, 32), DEPTH, device="cpu")
    with pytest.raises(ValueError, match="would pack"):
        net(torch.zeros(1, 30, 30, 30, IN_CH))


HK_SIZE, HK_NF, HK_S2D = (32, 32, 32), 8, {1: True, 2: (2,)}


def test_hecktor_level2_packing_matches_jax():
    """Bars: logits within 1e-3 of their scale, tests/test_torch_hecktor.py's
    (about 30 InstanceNorms without affine, each amplifying rounding by its
    1/sigma); gradients within 3e-2 of each tensor's largest magnitude. The
    SE gates' biases are ill-conditioned in fp32 on these weights: one
    sigmoid/tanh gate a (sample, channel) decides a whole level. The port's
    fine fp32 gradient of block_2_1_left.res_conv.norm.beta.conv1.bias moves
    by 1.6e-2 of its largest magnitude when the input moves by 1e-6, and JAX's
    fp32 one lies 2e-2 from the port's float64 run, where the port's packed
    fp32 one lies 5e-4 from it. A layout error is O(1).

    JAX's ``Hecktor20Top1`` reads ``s2d`` with ``isinstance(s2d, dict)``,
    which flax's frozen attribute fails: JAX runs this dict as ``s2d=True``
    (level 1 packed, level 2 fine). The port packs level 2 as the dict says;
    the two are the same function, compared here.
    """
    jmodel, jfine = (jh.Hecktor20Top1(in_channels=IN_CH, n_cls=N_CLS, n_filters=HK_NF, s2d=s2d)
                     for s2d in (HK_S2D, False))
    x = np.random.RandomState(1).randn(1, *HK_SIZE, IN_CH).astype(np.float32)
    params = random_jax_params(jmodel, jnp.zeros((1,) + HK_SIZE + (IN_CH,)),
                               np.random.RandomState(0))
    port = th.Hecktor20Top1(IN_CH, N_CLS, HK_NF, HK_SIZE, s2d=HK_S2D, device="cpu")
    assert port.packed and port.packed2 == (2,)
    load_jax_params(port, params)
    rs = [np.random.RandomState(2).randn(1, *HK_SIZE, N_CLS).astype(np.float32)]
    ref, grads, spread, gspread = _jax_reference(jmodel, jfine, params, x, rs)
    got, got_grads = _port_grads(port, x, rs)
    _assert_outputs(got, ref, spread, rel=1e-3)
    _assert_grads(got_grads, grads, gspread, rel=3e-2)
    fine = load_jax_params(th.Hecktor20Top1(IN_CH, N_CLS, HK_NF, HK_SIZE, s2d=False,
                                            device="cpu"), params)
    with torch.inference_mode():
        _assert_outputs([fine(torch.from_numpy(x))], ref, spread, rel=1e-3)
