"""Port s2d half-shift and packed ops against the JAX package's.

The same numpy inputs and weights (weights converted by
``weights.from_jax_params``) go through the JAX function and its port. The
shift and the pack are copies, so they must agree bit for bit. The packed
convolutions, pools, upsample, concatenation and InstanceNorm are held to
rtol = atol = 1e-5: fp32 sums of up to a few hundred products taken in
another order (XLA's convolution against oneDNN's), and the same against the
port's own fine-grid op followed by ``pack``. The CUDA kernel behind
``shift_pack`` is held to its plain version in tests/test_torch_cuda.py and
chip_smoke.py; here a CPU tensor takes the plain version.
"""
import numpy as np
import pytest

# torch before jax's first use in this process, as tests/test_hdenseformer.py
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from hdenseformer_tpu.models import layers as jl  # noqa: E402
from hdenseformer_tpu.ops import s2d as js  # noqa: E402
from hdenseformer_tpu.ops.shift_pack import shift_pack_xla, shift_unpack_xla  # noqa: E402
from hdenseformer_tpu_torch.models import layers as tl  # noqa: E402
from hdenseformer_tpu_torch.ops import s2d as ts  # noqa: E402
from hdenseformer_tpu_torch.ops.resize import max_pool, upsample_linear  # noqa: E402
from hdenseformer_tpu_torch.ops.shift_pack import (  # noqa: E402
    shift_pack,
    shift_pack_ref,
    shift_unpack,
    shift_unpack_ref,
)
from hdenseformer_tpu_torch.weights import from_jax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid(nsp):
    return (5, 4, 7)[-nsp:]  # odd and even dims


# --- the half-shift ------------------------------------------------------


@pytest.mark.parametrize("fc", [16, 64, 256])
@pytest.mark.parametrize("nsp", [2, 3])
def test_shift_refs_equal_jax_bitwise(rng, nsp, fc):
    x = rng.randn(2, *_grid(nsp), fc).astype(np.float32)
    ref = np.asarray(shift_pack_xla(jnp.asarray(x)))
    got = shift_pack_ref(_t(x)).numpy()
    assert got.shape == (2, *(g + 1 for g in _grid(nsp)), fc)
    np.testing.assert_array_equal(got, ref)
    dy = rng.randn(*ref.shape).astype(np.float32)
    np.testing.assert_array_equal(shift_unpack_ref(_t(dy)).numpy(),
                                  np.asarray(shift_unpack_xla(jnp.asarray(dy))))


@pytest.mark.parametrize("nsp", [2, 3])
def test_shift_unpack_is_the_transpose(rng, nsp):
    """<S x, y> == <x, S^T y> (float64: the two sums hold the same products)."""
    x = torch.from_numpy(rng.randn(1, *_grid(nsp), 2 ** nsp * 3))
    sx = shift_pack_ref(x)
    y = torch.from_numpy(rng.randn(*sx.shape))
    torch.testing.assert_close(torch.vdot(sx.flatten(), y.flatten()),
                               torch.vdot(x.flatten(), shift_unpack_ref(y).flatten()),
                               rtol=1e-12, atol=0)


def test_shift_pack_autograd_on_cpu(rng):
    # as tests/test_shift_pack.py: the gradient is the transpose, and equals
    # autodiff through the plain slices
    x = torch.from_numpy(rng.randn(1, 4, 5, 6, 64).astype(np.float32)).requires_grad_()
    torch.sin(shift_pack(x)).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    torch.sin(shift_pack_ref(x2)).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=0, atol=0)
    dy = torch.cos(shift_pack_ref(x.detach()))
    torch.testing.assert_close(x.grad, shift_unpack_ref(dy), rtol=0, atol=0)


def test_shift_wrappers_on_cpu_and_other_devices(rng):
    x = torch.from_numpy(rng.randn(2, 3, 4, 5, 16).astype(np.float32))
    counts = shift_pack.launches, shift_unpack.launches
    torch.testing.assert_close(shift_pack(x), shift_pack_ref(x), rtol=0, atol=0)
    y = shift_pack_ref(x)
    torch.testing.assert_close(shift_unpack(y), shift_unpack_ref(y), rtol=0, atol=0)
    # a CPU call never counts as a kernel launch
    assert (shift_pack.launches, shift_unpack.launches) == counts
    meta = torch.empty(1, 2, 2, 2, 8, device="meta")
    for fn in (shift_pack, shift_unpack):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta)
    with pytest.raises(ValueError, match="spatial dims"):
        shift_pack_ref(torch.zeros(1, 4, 8))


# --- pack and the kernel expansions ---------------------------------------


@pytest.mark.parametrize("dims", [None, (2,), (0, 2)])
def test_pack_unpack_equal_jax_bitwise(rng, dims):
    x = rng.randn(2, 6, 4, 8, 3).astype(np.float32)
    ref = np.asarray(js.pack(jnp.asarray(x), dims))
    got = ts.pack(_t(x), dims)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ts.unpack(got, dims).numpy(), x)


def _conv_weight(rng, k, cin, cout, nsp=3):
    """A JAX conv kernel (k.., in, out) and the port's (out, in, k..)."""
    w = (rng.uniform(-1, 1, (k,) * nsp + (cin, cout)) / np.sqrt(cin * k ** nsp))
    w = w.astype(np.float32)
    return w, from_jax_params({"kernel": w})["weight"]


def _transpose_weight(rng, cin, cout):
    """A JAX ConvTranspose kernel (the flipped equivalent conv) and torch's."""
    w = (rng.uniform(-1, 1, (3, 3, 3, cin, cout)) / np.sqrt(cout * 27)).astype(np.float32)
    return w, from_jax_params({"kernel": w}, prefix="upconv_1")["weight"]


def test_expansions_equal_jax_bitwise(rng):
    w, wt = _conv_weight(rng, 3, 4, 6)
    ref = np.asarray(js.expand_kernel(jnp.asarray(w)))  # (2, 2, 2, f*in, f*out)
    np.testing.assert_array_equal(ts.expand_kernel(wt).numpy(), ref.transpose(4, 3, 0, 1, 2))
    w, wt = _transpose_weight(rng, 5, 3)
    ref = np.asarray(js.expand_kernel_transpose(jnp.asarray(w)))  # (2, 2, 2, in, f*out)
    np.testing.assert_array_equal(ts.expand_kernel_transpose(wt).numpy(),
                                  ref.transpose(4, 3, 0, 1, 2))


# --- the packed ops: JAX, and the port's fine op + pack --------------------

C, CO, G = 3, 5, (3, 2, 4)  # coarse grid of a (6, 4, 8) fine grid


def _case_conv(rng, k):
    x = rng.randn(2, *(2 * g for g in G), C).astype(np.float32)
    w, wt = _conv_weight(rng, k, C, CO)
    b = (0.2 * rng.randn(CO)).astype(np.float32)
    xp = np.asarray(js.pack(jnp.asarray(x)))
    if k == 1:
        jax_out = js.conv1_packed(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(b))
        port = ts.conv1_packed(_t(xp), wt, _t(b))
    else:
        conv = js.conv3_packed if k == 3 else js.convk_packed
        jax_out = conv(jnp.asarray(xp), jnp.asarray(w)) + jnp.tile(jnp.asarray(b), 8)
        port = (ts.conv3_packed if k == 3 else ts.convk_packed)(_t(xp), wt, _t(b))
    fine = F.conv3d(_t(x).movedim(-1, 1), wt, _t(b), 1, k // 2).movedim(1, -1)
    return jax_out, port, ts.pack(fine)


def _case_conv_transpose(rng):
    x = rng.randn(2, *G, C).astype(np.float32)
    w, wt = _transpose_weight(rng, C, CO)
    b = (0.2 * rng.randn(CO)).astype(np.float32)
    jax_out = js.conv_transpose_packed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    port = ts.conv_transpose_packed(_t(x), wt, _t(b))
    fine = F.conv_transpose3d(_t(x).movedim(-1, 1), wt, _t(b), 2, 1, 1).movedim(1, -1)
    return jax_out, port, ts.pack(fine)


def _case_max_pool(rng):
    x = rng.randn(2, *(2 * g for g in G), C).astype(np.float32)
    xp = ts.pack(_t(x))
    return js.max_pool_packed(jnp.asarray(xp.numpy())), ts.max_pool_packed(xp), max_pool(_t(x))


def _case_upsample(rng):
    x = rng.randn(2, *G, C).astype(np.float32)
    return (js.upsample2x_packed(jnp.asarray(x)), ts.upsample2x_packed(_t(x)),
            ts.pack(upsample_linear(_t(x), 2)))


def _case_concat(rng):
    a = rng.randn(2, *(2 * g for g in G), C).astype(np.float32)
    b = rng.randn(2, *(2 * g for g in G), CO).astype(np.float32)
    ap, bp = ts.pack(_t(a)), ts.pack(_t(b))
    jax_out = js.concat_packed([jnp.asarray(ap.numpy()), jnp.asarray(bp.numpy())])
    return jax_out, ts.concat_packed([ap, bp]), ts.pack(torch.cat([_t(a), _t(b)], dim=-1))


def _case_instance_norm(rng, affine):
    x = (3 * rng.randn(2, *(2 * g for g in G), C) + 1).astype(np.float32)
    xp = np.asarray(js.pack(jnp.asarray(x)))
    jmod = jl.InstanceNorm(affine=affine, fuse_relu=affine, packed=True)
    params = {}
    if affine:
        params = {"scale": (1 + 0.2 * rng.randn(C)).astype(np.float32),
                  "bias": (0.2 * rng.randn(C)).astype(np.float32)}
    jax_out = jmod.apply({"params": params}, jnp.asarray(xp))
    mods = [tl.InstanceNorm(C, affine=affine, fuse_relu=affine, packed=packed)
            for packed in (True, False)]
    for m in mods:
        m.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        return jax_out, mods[0](_t(xp)), ts.pack(mods[1](_t(x)))


PACKED_CASES = {
    "conv3_packed": lambda rng: _case_conv(rng, 3),
    "convk_packed_k7": lambda rng: _case_conv(rng, 7),
    "conv1_packed": lambda rng: _case_conv(rng, 1),
    "conv_transpose_packed": _case_conv_transpose,
    "max_pool_packed": _case_max_pool,
    "upsample2x_packed": _case_upsample,
    "concat_packed": _case_concat,
    "instance_norm_packed": lambda rng: _case_instance_norm(rng, False),
    "instance_norm_packed_affine_relu": lambda rng: _case_instance_norm(rng, True),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_op_matches_jax_and_fine(rng, case):
    jax_out, port, fine_packed = PACKED_CASES[case](rng)
    jax_out = np.asarray(jax_out)
    assert port.shape == jax_out.shape == fine_packed.shape
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), jax_out, **TOL)
    np.testing.assert_allclose(port.numpy(), fine_packed.numpy(), **TOL)


def test_packed_ops_take_2d(rng):
    x = torch.from_numpy(rng.randn(2, 6, 8, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 3, 3, 3).astype(np.float32) * 0.2)
    got = ts.conv3_packed(ts.pack(x), w)
    ref = F.conv2d(x.movedim(-1, 1), w, None, 1, 1).movedim(1, -1)
    torch.testing.assert_close(got, ts.pack(ref), **TOL)


def test_partial_rank_is_not_ported(rng):
    """Partial-rank packing (once unported, now JAX's): the packed conv and
    max-pool over (2,) and (0, 1) equal JAX's; the guards that remain raise."""
    x = rng.randn(1, 4, 6, 8, 6).astype(np.float32)
    w, wt = _conv_weight(rng, 3, 3, 4)
    for dims in ((2,), (0, 1)):
        xp = np.asarray(js.pack(jnp.asarray(x[..., :3]), dims))
        ref = np.asarray(js.conv3_packed(jnp.asarray(xp), jnp.asarray(w), dims=dims))
        np.testing.assert_allclose(ts.conv3_packed(_t(xp), wt, dims=dims).numpy(), ref, **TOL)
        np.testing.assert_array_equal(ts.max_pool_packed(_t(xp), dims).numpy(),
                                      np.asarray(js.max_pool_packed(jnp.asarray(xp), dims)))
    with pytest.raises(ValueError, match="odd"):
        ts.convk_packed(ts.pack(torch.zeros(1, 4, 4, 4, 3)), torch.zeros(3, 3, 4, 4, 4))
    with pytest.raises(ValueError, match="packed conv"):
        tl.Conv(3, 3, 3, 1, 0, packed=True)
    with pytest.raises(ValueError, match="k3 s2 p1 op1"):
        tl.ConvTranspose(3, 3, 2, 2, 0, 0, packed_out=True, packed_dims=(2,))
