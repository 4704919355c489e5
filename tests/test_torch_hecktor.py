"""Port Hecktor20Top1 and its packed layers against the JAX modules.

Random JAX parameters (shaped by tracing the flax ``init``) are carried into
the port by ``weights.from_jax_params``; both frameworks run the same numpy
inputs in fp32 on the CPU. The half-shift behind the port's packed convs is
the plain version here (a CPU tensor); tests/test_torch_cuda.py and
chip_smoke.py run the CUDA kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.models import hecktor20top1 as jh  # noqa: E402
from hdenseformer_tpu.models import layers as jl  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models import hecktor20top1 as th  # noqa: E402
from hdenseformer_tpu_torch.models import layers as tl  # noqa: E402
from hdenseformer_tpu_torch.ops.s2d import pack  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params, load_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

C = 4  # fine channels of the layer cases; packed inputs carry 8 * C
FINE = (2, 6, 4, 8)  # (N, D, H, W) of the fine grid
COARSE = (2, 3, 2, 4)

# name: (JAX module, port module, input shape, prefix for from_jax_params)
LAYER_CASES = {
    "conv3_packed": (lambda: jl.Conv(5, 3, 1, 1, packed=True),
                     lambda: tl.Conv(C, 5, 3, 1, 1, packed=True), COARSE + (8 * C,), ""),
    "conv7_packed": (lambda: jl.Conv(5, 7, 1, 3, packed=True),
                     lambda: tl.Conv(C, 5, 7, 1, 3, packed=True), COARSE + (8 * C,), ""),
    "conv1_packed": (lambda: jl.Conv(5, 1, packed=True),
                     lambda: tl.Conv(C, 5, 1, packed=True), COARSE + (8 * C,), ""),
    "conv_transpose_packed_out": (
        lambda: jl.ConvTranspose(5, 3, 2, 1, 1, packed_out=True),
        lambda: tl.ConvTranspose(C, 5, 3, 2, 1, 1, packed_out=True), COARSE + (C,), "upconv_1",
    ),
    "se_weights_packed": (lambda: jh.SEWeights(C, packed=True),
                          lambda: th.SEWeights(C, packed=True), COARSE + (8 * C,), ""),
    "se_norm_packed": (lambda: jh.FastSmoothSENorm(C, packed=True),
                       lambda: th.FastSmoothSENorm(C, packed=True), COARSE + (8 * C,), ""),
    "se_norm_fine": (lambda: jh.FastSmoothSENorm(C), lambda: th.FastSmoothSENorm(C),
                     FINE + (C,), ""),
    "res_se_norm_conv_packed_k7": (
        lambda: jh.RESseNormConv(6, kernel_size=7, padding=3, packed=True),
        lambda: th.RESseNormConv(C, 6, kernel_size=7, padding=3, packed=True),
        COARSE + (8 * C,), "",
    ),
    "res_se_norm_conv_packed_identity": (
        lambda: jh.RESseNormConv(C, packed=True),
        lambda: th.RESseNormConv(C, C, packed=True), COARSE + (8 * C,), "",
    ),
    "vision_up_packed_x2": (lambda: jh.VisionUp(3, 2, packed_out=True),
                            lambda: th.VisionUp(C, 3, 2, packed_out=True), COARSE + (C,), ""),
    "vision_up_packed_x4": (lambda: jh.VisionUp(3, 4, packed_out=True),
                            lambda: th.VisionUp(C, 3, 4, packed_out=True), (1, 2, 2, 3, C), ""),
    "vision_up_fine_x2": (lambda: jh.VisionUp(3, 2), lambda: th.VisionUp(C, 3, 2),
                          COARSE + (C,), ""),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(rng, case):
    make_jax, make_port, shape, prefix = LAYER_CASES[case]
    x = (rng.randn(*shape) + 0.5).astype(np.float32)
    module = make_jax()
    params = random_jax_params(module, jnp.asarray(x), rng)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    port = make_port()
    port.load_state_dict(from_jax_params(params, prefix=prefix), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == ref.shape
    # fp32 sums in another order; the SE norms divide by a standard deviation
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


SIZE, IN_CH, N_CLS, NF = (16, 16, 16), 2, 2, 8


@pytest.fixture(scope="module")
def jax_packed():
    """JAX Hecktor20Top1 (nf 8, packed level 1) at 16^3: params and logits."""
    model = jh.Hecktor20Top1(in_channels=IN_CH, n_cls=N_CLS, n_filters=NF, s2d=True)
    params = random_jax_params(model, jnp.zeros((1,) + SIZE + (IN_CH,), jnp.float32),
                               np.random.RandomState(0))
    x = np.random.RandomState(1).randn(2, *SIZE, IN_CH).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    return params, x, ref


@pytest.mark.parametrize("s2d", [True, False], ids=["packed", "fine"])
def test_hecktor_matches_jax_packed(jax_packed, s2d):
    """The port, packed and fine, against JAX's packed apply.

    Bar: 1e-3 of the logit scale, 20x tighter than JAX's own packed-vs-fine
    bar of 2e-2 (tests/test_packed_bn.py::test_hecktor_s2d_matches_fine).
    What remains is fp32 reduction-order noise, which each of the ~30
    InstanceNorms amplifies by its 1/sigma (that test's docstring); measured
    at ~8e-5 of the scale. A layout error is O(1).
    """
    params, x, ref = jax_packed
    port = th.Hecktor20Top1(IN_CH, N_CLS, NF, SIZE, s2d=s2d, device="cpu").eval()
    assert port.packed is s2d
    load_jax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, *SIZE, N_CLS) and got.dtype == torch.float32
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3 * scale)


def test_hecktor_bf16_near_fp32(jax_packed):
    params, x, _ = jax_packed
    outs = {}
    for dt in (None, torch.bfloat16):
        port = load_jax_params(th.Hecktor20Top1(IN_CH, N_CLS, NF, SIZE, dtype=dt,
                                                device="cpu"), params).eval()
        with torch.inference_mode():
            outs[dt] = port(torch.from_numpy(x))
    lo, hi = outs[torch.bfloat16], outs[None]
    assert lo.dtype == torch.float32 and torch.isfinite(lo).all()
    # Random weights at 16^3 put the deepest InstanceNorms over 1 and 8
    # voxels, which amplify bf16 rounding: JAX's own bf16 model agrees with
    # its fp32 argmax on 96.9 % of these voxels (max |dlogit| 0.56 of 2.3).
    # The bar asks as much of the port, less a margin for where it rounds.
    agree = float((lo.argmax(-1) == hi.argmax(-1)).float().mean())
    assert agree > 0.9, agree


def test_packed_and_fine_share_one_state_dict():
    a = th.Hecktor20Top1(IN_CH, N_CLS, NF, SIZE, s2d=True, device="cpu").state_dict()
    b = th.Hecktor20Top1(IN_CH, N_CLS, NF, SIZE, s2d=False, device="cpu").state_dict()
    assert list(a) == list(b) and all(a[k].shape == b[k].shape for k in a)
    assert a["block_1_1_left.conv1.conv.weight"].shape == (NF, IN_CH, 7, 7, 7)
    assert a["upconv_1.weight"].shape == (2 * NF, NF, 3, 3, 3)  # torch (in, out, k..)


def test_get_net_builds_hecktor_with_jax_packing_rule():
    net = get_net("hecktor20top1", 2, 2, (32, 32, 32), device="cpu")
    assert isinstance(net, th.Hecktor20Top1) and net.packed and not net.training
    assert net.conv1x1.weight.shape == (2, 32, 1, 1, 1)  # n_filters 32
    assert not get_net("hecktor20top1", 2, 2, (32, 32, 32), s2d=False, device="cpu").packed
    assert not get_net("hecktor20top1", 2, 2, (31, 31, 31), device="cpu").packed
    assert get_net("hecktor20top1", 2, 2, (32, 32, 32), s2d={1: True}, device="cpu").packed
    with pytest.raises(ValueError, match="even spatial dims"):
        get_net("hecktor20top1", 2, 2, (31, 31, 31), s2d=True, device="cpu")
    # the dict that also packs level 2 (once unported): JAX's parameter tree
    # of that configuration loads, every name and shape
    spec = {1: True, 2: (2,)}
    net2 = get_net("hecktor20top1", 2, 2, (32, 32, 32), s2d=spec, device="cpu")
    assert net2.packed and net2.packed2 == (2,)
    jmodel = jh.Hecktor20Top1(in_channels=2, n_cls=2, n_filters=32, s2d=spec)
    load_jax_params(net2, random_jax_params(jmodel, jnp.zeros((1, 32, 32, 32, 2)),
                                            np.random.RandomState(0)))
    # JAX drops level 2's packing where its grid is odd on the packed dims
    assert get_net("hecktor20top1", 2, 2, (20, 20, 18), s2d=spec, device="cpu").packed2 is None
    with pytest.raises(ValueError, match="even spatial dims"):
        net(torch.zeros(1, 6, 6, 5, 2))


def test_pack_of_input_is_what_the_stem_reads(rng):
    """The packed stem on pack(x) equals the fine stem followed by pack."""
    x = torch.from_numpy(rng.randn(1, 8, 6, 4, IN_CH).astype(np.float32))
    pk = th.RESseNormConv(IN_CH, NF, kernel_size=7, padding=3, packed=True)
    fine = th.RESseNormConv(IN_CH, NF, kernel_size=7, padding=3)
    tl.init_weights(pk, torch.Generator().manual_seed(0))
    fine.load_state_dict(pk.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(pk(pack(x)), pack(fine(x)), rtol=1e-5, atol=1e-5)
