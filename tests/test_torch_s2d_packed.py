"""The port's partial-rank s2d ops, the shift-free pair and the shifted
InstanceNorm against the JAX package's, on the CPU.

Every op runs at packed dims (2,), (1, 2), (0, 2) and full rank in 3-D, and
(1,) and full rank in 2-D, on inputs made from a numpy seed. Copies (pack,
the half-shift, the mask, the max-pool) and the kernel expansions must match
bit for bit; convolutions and norms are held to rtol = atol = 1e-5 in fp32
(sums of up to a few hundred products in another order). The shifted norm's
plain forward and backward (``instance_norm_relu_ref``/``_bwd_ref`` with
``shifted``, and the wrappers, which take them on a CPU tensor) are held to
``fused_norm.instance_norm_relu(shifted=...)`` and its VJP: fp32 within 1e-5
of each output's largest magnitude; bf16 within one bf16 step (2^-8
relative) of it, plus a step of the output's scale for values that round
across. The CUDA kernels are held to the same plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

# torch before jax's first use in this process, as tests/test_hdenseformer.py
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from hdenseformer_tpu.models import layers as jl  # noqa: E402
from hdenseformer_tpu.ops import fused_norm  # noqa: E402
from hdenseformer_tpu.ops import s2d as js  # noqa: E402
from hdenseformer_tpu_torch.models import layers as tl  # noqa: E402
from hdenseformer_tpu_torch.ops import instance_norm as ti  # noqa: E402
from hdenseformer_tpu_torch.ops import s2d as ts  # noqa: E402
from hdenseformer_tpu_torch.weights import from_jax_params  # noqa: E402
from torch_port_util import random_jax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# (spatial rank, packed dims): None is full rank
DIMS = [(3, (2,)), (3, (1, 2)), (3, (0, 2)), (3, None), (2, (1,)), (2, None)]
IDS = ["3d_w", "3d_hw", "3d_dw", "3d_full", "2d_w", "2d_full"]
C, CO = 3, 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _pd(nsp, dims):
    return tuple(range(nsp)) if dims is None else dims


def _coarse(nsp):
    return (3, 2, 4)[-nsp:]


def _fine(nsp, dims):
    """A fine grid that packs over dims: even there, odd elsewhere."""
    pd = _pd(nsp, dims)
    return tuple(2 * g if i in pd else g + 2 for i, g in enumerate(_coarse(nsp)))


def _weight(rng, k, cin, cout, nsp):
    """A JAX conv kernel (k.., in, out) and the port's (out, in, k..)."""
    w = (rng.uniform(-1, 1, (k,) * nsp + (cin, cout)) / np.sqrt(cin * k ** nsp))
    w = w.astype(np.float32)
    return w, from_jax_params({"kernel": w})["weight"]


def _packed_input(rng, nsp, dims, c=C):
    x = rng.randn(2, *_fine(nsp, dims), c).astype(np.float32)
    return x, np.asarray(js.pack(jnp.asarray(x), dims))


def _jax_layout(w, nsp):
    """JAX's (K.., in, out) expansion in the port's (out, in, K..) order."""
    return w.transpose(nsp + 1, nsp, *range(nsp))


@pytest.mark.parametrize("nsp,dims", DIMS, ids=IDS)
def test_copies_and_expansions_equal_jax_bitwise(rng, nsp, dims):
    x, xp = _packed_input(rng, nsp, dims)
    np.testing.assert_array_equal(ts.pack(_t(x), dims).numpy(), xp)
    np.testing.assert_array_equal(ts.unpack(_t(xp), dims).numpy(), x)
    xs = np.asarray(js.plain_to_shifted(jnp.asarray(xp), dims))
    np.testing.assert_array_equal(ts.plain_to_shifted(_t(xp), dims).numpy(), xs)
    np.testing.assert_array_equal(ts.apply_shifted_mask(_t(xs), dims).numpy(),
                                  np.asarray(js.apply_shifted_mask(jnp.asarray(xs), dims=dims)))
    pd = _pd(nsp, dims)
    sshape, f = xs.shape[1:-1], 2 ** len(pd)
    factors = js.shifted_mask_factors(sshape, xs.shape[-1], C, pd)
    for (i, got), (j, ref) in zip(ts.shifted_mask_factors(sshape, xs.shape[-1], C, pd),
                                  factors):
        assert i == j
        np.testing.assert_array_equal(got, ref.astype(bool))
    assert ts.shifted_count(sshape, pd) == fused_norm._count(jnp.asarray(xs), f, pd)
    np.testing.assert_array_equal(ts.max_pool_packed(_t(xp), dims).numpy(),
                                  np.asarray(js.max_pool_packed(jnp.asarray(xp), dims)))
    w, wt = _weight(rng, 3, C, CO, nsp)
    for port, jax_fn in ((ts.expand_kernel, js.expand_kernel),
                         (ts.expand_kernel_p2s, js.expand_kernel_p2s)):
        np.testing.assert_array_equal(port(wt, dims).numpy(),
                                      _jax_layout(np.asarray(jax_fn(jnp.asarray(w), dims)), nsp))
    wj = (rng.uniform(-1, 1, (3,) * nsp + (C, CO)) / np.sqrt(CO * 3 ** nsp)).astype(np.float32)
    wtt = from_jax_params({"kernel": wj}, prefix="upconv_1")["weight"]
    np.testing.assert_array_equal(
        ts.expand_kernel_transpose(wtt, dims).numpy(),
        _jax_layout(np.asarray(js.expand_kernel_transpose(jnp.asarray(wj), dims)), nsp))


@pytest.mark.parametrize("nsp,dims", DIMS, ids=IDS)
def test_packed_convs_equal_jax(rng, nsp, dims):
    _, xp = _packed_input(rng, nsp, dims)
    jx = jnp.asarray(xp)
    for k in (3, 7):
        w, wt = _weight(rng, k, C, CO, nsp)
        jw = jnp.asarray(w)
        cases = [(ts.convk_packed(_t(xp), wt, dims=dims), js.convk_packed(jx, jw, dims=dims)),
                 (ts.convk_packed_p2s(_t(xp), wt, dims=dims),
                  js.convk_packed_p2s(jx, jw, dims=dims)),
                 (ts.conv_s2_packed(_t(xp), wt, dims=dims), js.conv_s2_packed(jx, jw, dims=dims))]
        if k == 3:
            xs = js.plain_to_shifted(jx, dims)
            cases.append((ts.conv3_packed_s2p(_t(xs), wt, dims=dims),
                          js.conv3_packed_s2p(xs, jw, dims=dims)))
        for got, ref in cases:
            assert got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("nsp,dims", DIMS, ids=IDS)
def test_packed_transposes_upsample_and_group_norm_equal_jax(rng, nsp, dims):
    x = rng.randn(2, *_coarse(nsp), C).astype(np.float32)
    wj = (rng.uniform(-1, 1, (3,) * nsp + (C, CO)) / np.sqrt(CO * 3 ** nsp)).astype(np.float32)
    wt = from_jax_params({"kernel": wj}, prefix="upconv_1")["weight"]
    b = (0.2 * rng.randn(CO)).astype(np.float32)
    ref = js.conv_transpose_packed(jnp.asarray(x), jnp.asarray(wj), jnp.asarray(b), dims=dims)
    np.testing.assert_allclose(ts.conv_transpose_packed(_t(x), wt, _t(b), dims=dims).numpy(),
                               np.asarray(ref), **TOL)
    np.testing.assert_allclose(ts.upsample2x_packed(_t(x), dims).numpy(),
                               np.asarray(js.upsample2x_packed(jnp.asarray(x), dims)), **TOL)
    # GroupNorm(8) of 16 channels, plain and shifted, affine with ReLU
    _, xp = _packed_input(rng, nsp, dims, c=16)
    xs = np.asarray(js.plain_to_shifted(jnp.asarray(3 * xp + 1), dims))
    g = (1 + 0.2 * rng.randn(16)).astype(np.float32)
    bb = (0.2 * rng.randn(16)).astype(np.float32)
    for inp, shifted in ((xp, False), (xs, True)):
        ref = js.group_norm_relu_packed(jnp.asarray(inp), jnp.asarray(g), jnp.asarray(bb),
                                        dims=dims, shifted=shifted)
        got = ts.group_norm_relu_packed(_t(inp), _t(g), _t(bb), dims=dims, shifted=shifted)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_conv_transpose2_and_dot_f32out_equal_jax(rng):
    x = rng.randn(2, 3, 2, 4, 6).astype(np.float32)
    wj = rng.uniform(-0.3, 0.3, (2, 2, 2, 6, 5)).astype(np.float32)
    wt = from_jax_params({"kernel": wj}, prefix="upconv_1")["weight"]
    b = (0.2 * rng.randn(5)).astype(np.float32)
    ref = js.conv_transpose2_packed(jnp.asarray(x), jnp.asarray(wj), jnp.asarray(b))
    got = ts.conv_transpose2_packed(_t(x), wt, _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    fine = F.conv_transpose3d(_t(x).movedim(-1, 1), wt, _t(b), 2).movedim(1, -1)
    np.testing.assert_allclose(got.numpy(), ts.pack(fine).numpy(), **TOL)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wj[0, 0, 0], jnp.bfloat16)
    port = ts.dot_f32out(_t(x).bfloat16(), _t(wj[0, 0, 0]).bfloat16())
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(js.dot_f32out(xb, wb)), **TOL)
    with pytest.raises(ValueError, match="every dim"):
        ts.conv_transpose2_packed(_t(x), wt, dims=(2,))


@pytest.mark.parametrize("nsp,dims", DIMS, ids=IDS)
def test_shift_free_pair_equals_two_fine_basic_convs(rng, nsp, dims):
    """p2s conv -> shifted norm -> s2p conv, packed, against the same two
    BasicConvs on the fine grid (and JAX's packed pair)."""
    x, xp = _packed_input(rng, nsp, dims)
    fine = [tl.BasicConv(C, 4, ndim=nsp), tl.BasicConv(4, 4, ndim=nsp)]
    packed = [tl.BasicConv(C, 4, ndim=nsp, packed=True, packed_dims=dims, shift="out"),
              tl.BasicConv(4, 4, ndim=nsp, packed=True, packed_dims=dims, shift="in")]
    jmods = [jl.BasicConv(4, packed=True, packed_dims=dims, shift="out"),
             jl.BasicConv(4, packed=True, packed_dims=dims, shift="in")]
    h, jh = _t(xp), jnp.asarray(xp)
    with torch.no_grad():
        y = _t(x)
        for f, p, j in zip(fine, packed, jmods):
            params = random_jax_params(j, jh, rng)
            jh = j.apply({"params": params}, jh)
            for m in (f, p):
                m.load_state_dict(from_jax_params(params), strict=True)
            h, y = p(h), f(y)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(ts.unpack(h, dims).numpy(), y.numpy(), **TOL)


def _bf16_close(got, ref):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=2 ** -8,
                               atol=2 ** -8 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nsp,dims", DIMS, ids=IDS)
def test_shifted_norm_and_vjp_equal_fused_norm(rng, nsp, dims, dtype):
    """Plain forward and backward (refs and CPU wrappers) against
    ``fused_norm`` with ``shifted``, affine with ReLU and plain without."""
    pd = _pd(nsp, dims)
    f = 2 ** len(pd)
    s = (3, 4, 5)[-nsp:]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    x = jnp.asarray(3 * rng.randn(2, *s, f * C) + 1, jdt)
    dy = jnp.asarray(rng.randn(2, *s, f * C), jdt)
    xt, dyt = _t(np.asarray(x, np.float32)).to(tdt), _t(np.asarray(dy, np.float32)).to(tdt)
    for affine, relu in ((True, True), (False, False)):
        sc = jnp.asarray(1 + 0.3 * rng.randn(C), jnp.float32) if affine else None
        bi = jnp.asarray(0.3 * rng.randn(C), jnp.float32) if affine else None
        y, vjp = jax.vjp(lambda x_, s_, b_: fused_norm.instance_norm_relu(
            x_, s_, b_, 1e-5, relu, f, pd), x, sc, bi)
        dx, ds, db = vjp(dy)
        sct = None if sc is None else _t(sc)
        bit = None if bi is None else _t(bi)
        got_y, stats = ti.instance_norm_relu_fwd(xt, sct, bit, 1e-5, relu, shifted=pd)
        ref_y = ti.instance_norm_relu_ref(xt, sct, bit, 1e-5, relu, shifted=pd)
        got = ti.instance_norm_relu_bwd(dyt, xt, stats, sct, bit, relu, shifted=pd)
        mean, inv = ti.absolute_stats(xt, stats, pd)
        ref = ti.instance_norm_relu_bwd_ref(dyt, xt, mean, inv, sct, bit, relu, shifted=pd)
        assert got_y.dtype == tdt and got_y.shape == xt.shape and got[0].shape == xt.shape
        # pad slots are 0 in y and dx, whatever x and dy hold there
        mask = ts.apply_shifted_mask(torch.ones(xt.shape), pd) == 0
        assert mask.any() and not got_y[mask].any() and not got[0][mask].any()
        pairs = [(got_y, y), (ref_y, y), (got[0], dx), (ref[0], dx)]
        if affine:
            pairs += [(got[1], ds), (got[2], db), (ref[1], ds), (ref[2], db)]
        for port, want in pairs:
            want = np.asarray(want, np.float32)
            port = port.float().numpy()
            if dtype == "float32" or port.shape == (C,):
                scale = float(np.abs(want).max())
                np.testing.assert_allclose(port, want, rtol=1e-5, atol=1e-5 * scale)
            else:
                _bf16_close(port, want)


def test_shifted_norm_layer_and_guards(rng):
    x = _t(3 * rng.randn(1, 3, 4, 5, 4 * C) + 1)
    m = tl.InstanceNorm(C, packed=True, packed_dims=(1, 2), shifted=True, fuse_relu=True)
    tl.init_weights(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(m(x), ti.instance_norm_relu_ref(
            x, m.weight, m.bias, 1e-5, True, shifted=(1, 2)), rtol=0, atol=0)
    counts = ti.instance_norm_relu_shifted.launches, ti.instance_norm_relu_shifted_bwd.launches
    y = ti.instance_norm_relu_shifted(x.requires_grad_(), (1, 2))
    y.sum().backward()
    # a CPU call never counts as a kernel launch
    assert (ti.instance_norm_relu_shifted.launches,
            ti.instance_norm_relu_shifted_bwd.launches) == counts
    with pytest.raises(ValueError, match="packed-shifted"):
        ti.shift_of(torch.zeros(1, 3, 1, 5, 4 * C), (1, 2))  # one cell: row 0 a pad
    with pytest.raises(ValueError, match="shifted InstanceNorm is packed"):
        tl.InstanceNorm(C, shifted=True)
    with pytest.raises(ValueError, match="packed_shift needs packed"):
        tl.Conv(C, C, 3, 1, 1, packed_shift="out")
    with pytest.raises(ValueError, match="packed conv"):
        tl.Conv(C, C, 3, 2, 1, packed=True, packed_shift="out")
    with pytest.raises(ValueError, match="unsupported device"):
        ti.instance_norm_relu_fwd(torch.zeros(1, 3, 4, 5, 4 * C, device="meta"),
                                  shifted=(1, 2))
