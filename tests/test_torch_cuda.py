"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it runs where JAX is not installed; on the machine with
the card run it without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

fp32 comparisons turn TF32 off in cuDNN and cuBLAS, since a float32
convolution otherwise runs in TF32 on the card.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.ops.dense_attention import (  # noqa: E402
    attention_ref,
    dense_attention,
)
from hdenseformer_tpu_torch.ops.instance_norm import (  # noqa: E402
    absolute_stats,
    instance_norm_relu,
    instance_norm_relu_bwd,
    instance_norm_relu_bwd_ref,
    instance_norm_relu_fwd,
    instance_norm_relu_ref,
)
from hdenseformer_tpu_torch.ops.shift_pack import (  # noqa: E402
    shift_pack,
    shift_pack_ref,
    shift_unpack,
    shift_unpack_ref,
)

pytestmark = pytest.mark.needs_cuda

# the conv biases under an InstanceNorm without affine: true gradient zero
ZERO_GRADIENT = ("deep_conv.conv.bias", "up1.conv.bias", "up2.conv.bias", "up3.conv.bias")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 729, 4), torch.float32), ((2, 8, 729, 4), torch.bfloat16),
    ((1, 2, 130, 4), torch.float32), ((2, 8, 100, 8), torch.float32),
])
def test_attention_kernel_matches_fp32_math(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    got = dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    ref = attention_ref(q.float(), k.float(), v.float())
    # fp32: summation order and exp2; bf16: one rounding of the output
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-8, atol=1e-5)
    torch.testing.assert_close(got.float(), ref, **tol)


def test_attention_kernel_takes_the_qkv_split(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(3, 729, 96, generator=g, device=cuda)
    q, k, v = (t.view(3, 729, 8, 4).transpose(1, 2) for t in qkv.split(32, dim=-1))
    torch.testing.assert_close(dense_attention(q, k, v), attention_ref(q, k, v),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,dtype,affine,relu", [
    ((2, 1000, 32), torch.float32, True, True),
    ((2, 1000, 32), torch.float32, False, True),
    ((1, 300, 16), torch.float32, True, False),
    ((1, 5000, 300), torch.float32, True, True),  # two channel tiles
    ((2, 9, 9, 9, 256), torch.bfloat16, True, True),
])
def test_instance_norm_kernel_matches_plain(cuda, shape, dtype, affine, relu):
    g = torch.Generator(device=cuda).manual_seed(2)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * 3 + 1).to(dtype)
    scale = torch.rand(c, generator=g, device=cuda) if affine else None
    bias = torch.randn(c, generator=g, device=cuda) if affine else None
    got = instance_norm_relu(x, scale, bias, relu=relu)
    ref = instance_norm_relu_ref(x, scale, bias, relu=relu)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    # fp32: summation order; bf16: at most one output rounding step apart
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-6)
    torch.testing.assert_close(got, ref, **tol)
    assert torch.equal(got, instance_norm_relu(x, scale, bias, relu=relu))  # no atomics


def _attention_inputs(cuda, n, d, dtype, layout, seed):
    """q, k, v of (2, 2, n, d): contiguous, the head views of one qkv
    projection, or rows d + 1 elements apart (too odd for vector loads)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if layout == "contiguous":
        return [torch.randn((2, 2, n, d), generator=g, device=cuda).to(dtype) for _ in range(3)]
    if layout == "odd_stride":
        return [torch.randn((2, 2, n, d + 1), generator=g, device=cuda).to(dtype)[..., :d]
                for _ in range(3)]
    qkv = torch.randn((2, n, 3 * 2 * d), generator=g, device=cuda).to(dtype)
    return [t.view(2, n, 2, d).transpose(1, 2) for t in qkv.split(2 * d, dim=-1)]


@pytest.mark.parametrize("layout", ["contiguous", "qkv_split", "odd_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("n", [1, 17, 130, 729])
def test_attention_kernel_shapes_and_layouts(cuda, n, d, dtype, layout):
    q, k, v = _attention_inputs(cuda, n, d, dtype, layout, seed=10 + n + d)
    got = dense_attention(q, k, v)
    again = dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    ref = attention_ref(q.float(), k.float(), v.float())
    # fp32: summation order and exp2; bf16: one rounding of the output
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-8, atol=1e-5)
    torch.testing.assert_close(got.float(), ref, **tol)
    assert torch.equal(got, again)  # fixed merge order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_large_logits(cuda, dtype):
    # scores in the hundreds, a nearly one-hot softmax: no exp2 overflows and
    # no row sum underflows. (At scores in the thousands, an fp32 rounding of
    # a score alone moves p by 1e-4, the fp32 tolerance.)
    g = torch.Generator(device=cuda).manual_seed(40)
    q, k, v = (torch.randn((2, 2, 729, 4), generator=g, device=cuda) for _ in range(3))
    q, k, v = (q * 8).to(dtype), (k * 8).to(dtype), v.to(dtype)
    got = dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    ref = attention_ref(q.float(), k.float(), v.float())
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-8, atol=1e-5)
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.parametrize("height", [3.0, 8.0, 40.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_late_peak(cuda, dtype, height):
    # Keys 650 and 670 (chunks 40 and 41, one in each key split) score far
    # above every key before them. The bf16 sweep's running max starts at
    # the first chunk's: at height 3 p reaches about 2^24 against it (kept,
    # no rescale); at 8 about 2^80 and at 40 past fp32's range, so the max
    # must move up and rescale the sums first.
    g = torch.Generator(device=cuda).manual_seed(50)
    q, k, v = (torch.randn((2, 2, 729, 4), generator=g, device=cuda) for _ in range(3))
    q = q + 4
    k[:, :, 650] = height
    k[:, :, 670] = height * 0.9
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    ref = attention_ref(q.float(), k.float(), v.float())
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-8, atol=1e-5)
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 16, 32, 256])
def test_instance_norm_kernel_ragged_rows(cuda, c, dtype, affine, relu):
    # S = 4099 rows: no chunk size divides it, so the last chunk is ragged
    g = torch.Generator(device=cuda).manual_seed(20 + c)
    x = (torch.randn((3, 4099, c), generator=g, device=cuda) * 3 + 1).to(dtype)
    scale = torch.rand(c, generator=g, device=cuda) if affine else None
    bias = torch.randn(c, generator=g, device=cuda) if affine else None
    got = instance_norm_relu(x, scale, bias, relu=relu)
    ref = instance_norm_relu_ref(x, scale, bias, relu=relu)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    # fp32: summation order; bf16: at most one output rounding step apart
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-6)
    torch.testing.assert_close(got, ref, **tol)
    assert torch.equal(got, instance_norm_relu(x, scale, bias, relu=relu))  # no atomics


def test_instance_norm_kernel_mean_far_from_zero(cuda):
    # The precision guard of the shifted sums: 1000 + N(0, 1) in fp32, where
    # the one-pass E[x^2] - mean^2 loses the variance. The norm does not
    # change under a shift, so the plain version runs on x - 1000 (exact in
    # fp32 here): on x itself it would round its own mean near 1000 to a
    # 6e-5 step, more than this tolerance allows.
    g = torch.Generator(device=cuda).manual_seed(30)
    x = 1000 + torch.randn((2, 4096, 32), generator=g, device=cuda)
    scale = torch.rand(32, generator=g, device=cuda)
    bias = torch.randn(32, generator=g, device=cuda)
    got = instance_norm_relu(x, scale, bias)
    ref = instance_norm_relu_ref(x - 1000, scale, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 64, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        instance_norm_relu(x.transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        instance_norm_relu(x.half())
    q = torch.randn(1, 2, 16, 5, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        dense_attention(q, q, q)


def test_model_goes_through_the_kernels(cuda):
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    nets = [
        get_net("HDenseFormer_16", 2, 2, (32, 32, 32), transformer_depth=4,
                use_kernels=use, device=cuda)
        for use in (True, False)
    ]
    init_weights(nets[0], torch.Generator().manual_seed(0))
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.randn(2, 32, 32, 32, 2, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    dense_attention.launches = instance_norm_relu.launches = 0
    with torch.inference_mode():
        got = nets[0](x)
        counts = dense_attention.launches, instance_norm_relu.launches
        ref = nets[1](x)
    torch.cuda.synchronize()
    assert counts == (2 * 4, 18)
    for g_, r in zip(got, ref):
        torch.testing.assert_close(g_, r, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fc", [16, 256])
@pytest.mark.parametrize("grid", [(5, 6, 7), (3, 1, 4), (9, 6)])
def test_shift_kernels_equal_plain_bitwise(cuda, grid, fc, dtype):
    if len(grid) == 2 and fc == 16:
        fc = 12  # C = 3: odd-sized blocks, 2-byte (bf16) or 4-byte (fp32) vectors
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, *grid, fc), generator=g, device=cuda).to(dtype)
    got = shift_pack(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, *(s + 1 for s in grid), fc)
    assert torch.equal(got, shift_pack_ref(x))
    dy = torch.randn(got.shape, generator=g, device=cuda).to(dtype)
    back = shift_unpack(dy)
    torch.cuda.synchronize()
    assert torch.equal(back, shift_unpack_ref(dy))


def test_shift_kernel_gradient_through_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((1, 4, 5, 6, 64), generator=g, device=cuda, requires_grad=True)
    shift_pack.launches = shift_unpack.launches = 0
    torch.sin(shift_pack(x)).sum().backward()
    assert (shift_pack.launches, shift_unpack.launches) == (1, 1)
    dy = torch.cos(shift_pack_ref(x.detach()))
    assert torch.equal(x.grad, shift_unpack_ref(dy))


def test_shift_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 4, 4, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        shift_pack(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        shift_pack(x.transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of 8"):
        shift_pack(x[..., :12].contiguous())
    with pytest.raises(ValueError, match="spatial dims"):
        shift_unpack(torch.randn(1, 4, 16, device=cuda))


def test_hecktor_goes_through_the_kernels(cuda):
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    nets = {
        (s2d, use): get_net("hecktor20top1", 2, 2, (32, 32, 32), s2d=s2d,
                            use_kernels=use, device=cuda)
        for s2d, use in ((True, True), (True, False), (False, True))
    }
    init_weights(nets[True, True], torch.Generator().manual_seed(0))
    for net in nets.values():
        net.load_state_dict(nets[True, True].state_dict())
    x = torch.randn(2, 32, 32, 32, 2, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    shift_pack.launches = instance_norm_relu.launches = 0
    with torch.inference_mode():
        got = nets[True, True](x)
        counts = shift_pack.launches, instance_norm_relu.launches
        plain = nets[True, False](x)
        fine = nets[False, True](x)
    torch.cuda.synchronize()
    # 4 packed k3/k7 convs and 30 SE norms a forward
    assert counts == (4, 30)
    # fp32, TF32 off: the kernels change no value; packed against fine is
    # fp32 reduction order amplified by the norms (JAX's bar, 2e-2 of the scale)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, fine, rtol=0, atol=2e-2 * float(fine.abs().max()))


def _norm_backward_case(cuda, shape, dtype, affine, relu, seed, mean=1.0, spread=3.0):
    """x, dy, scale, bias and the forward kernel's stats for one case."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * spread + mean).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    scale = bias = None
    if affine:
        # signs of both kinds, and one zero scale (the g == 0 branch of the mask)
        scale = torch.randn(c, generator=g, device=cuda)
        scale[0] = 0.0
        bias = torch.randn(c, generator=g, device=cuda)
    _, stats = instance_norm_relu_fwd(x, scale, bias, relu=relu)
    return x, dy, scale, bias, stats


def assert_norm_grads_close(got, ref, dtype):
    """The InstanceNorm backward's bars. dx per (n, c): fp32 1e-4 of
    max|dx_ref|; bf16 two bf16 steps of |dx_ref| plus 1e-3 of max|dx_ref|
    (summation order, then one rounding each side). dscale and dbias: 1e-4
    of the tensor's max|ref|."""
    dx, dscale, dbias = got
    dx_ref, dscale_ref, dbias_ref = ref
    n, c = dx.shape[0], dx.shape[-1]
    d = (dx.float() - dx_ref.float()).reshape(n, -1, c).abs()
    r = dx_ref.float().reshape(n, -1, c).abs()
    peak = r.amax(1, keepdim=True)
    if dtype == torch.float32:
        bar = 1e-4 * peak
    else:
        bar = 2 * 2.0**-7 * r + 1e-3 * peak
    assert bool((d <= bar).all()), float((d / bar.clamp_min(1e-30)).max())
    for a, b in ((dscale, dscale_ref), (dbias, dbias_ref)):
        assert (a is None) == (b is None)
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 32, 64, 128, 256])
def test_instance_norm_backward_kernel_matches_plain(cuda, c, dtype, affine, relu):
    # S = 4099 rows: the last chunk is ragged
    x, dy, scale, bias, stats = _norm_backward_case(cuda, (3, 4099, c), dtype, affine, relu,
                                                    seed=60 + c)
    instance_norm_relu_bwd.launches = 0
    got = instance_norm_relu_bwd(dy, x, stats, scale, bias, relu)
    again = instance_norm_relu_bwd(dy, x, stats, scale, bias, relu)
    torch.cuda.synchronize()
    assert instance_norm_relu_bwd.launches == 2
    assert got[0].dtype == dtype and got[0].shape == x.shape
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, relu)
    assert_norm_grads_close(got, ref, dtype)
    assert torch.equal(got[0], again[0])  # no atomics


@pytest.mark.parametrize("shape", [(2, 9, 9, 9, 256), (1, 72, 72, 72, 32), (1, 72, 72, 72, 64),
                                   (1, 36, 36, 36, 128), (1, 18, 18, 18, 256), (2, 5, 6, 7, 6),
                                   # more (sample, channel tile) pairs than the grid holds
                                   # blocks: each block owns several
                                   (300, 4, 4, 4, 32), (40, 3, 3, 3, 512),
                                   # Hecktor20Top1's level 5 and vision-head norms
                                   (2, 9, 9, 9, 512), (2, 18, 18, 18, 32),
                                   # odd C > 32: 2-byte vectors, a tile of 32 threads
                                   (2, 4099, 33), (1, 5000, 301)])
def test_instance_norm_backward_kernel_shapes(cuda, shape):
    x, dy, scale, bias, stats = _norm_backward_case(cuda, shape, torch.bfloat16, True, True,
                                                    seed=70)
    got = instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
    again = instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, True)
    torch.cuda.synchronize()
    assert_norm_grads_close(got, ref, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # a fixed merge order


def test_instance_norm_backward_is_one_launch(cuda):
    """The backward is one cooperative kernel a call, dscale and dbias
    included, its grid the blocks the card holds at once (or its items)."""
    from torch.autograd import DeviceType

    from hdenseformer_tpu_torch.ops._build import load_library
    from hdenseformer_tpu_torch.ops.instance_norm import _bwd_residency, bwd_plan

    x, dy, scale, bias, stats = _norm_backward_case(cuda, (1, 36, 36, 36, 128),
                                                    torch.bfloat16, True, True, seed=71)
    plan = bwd_plan(x, dy)
    sms, blocks = _bwd_residency(load_library(), x.device, x.dtype, plan.vec_bytes)
    assert sms == torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks >= 1 and plan.grid == min(plan.items, sms * blocks)
    instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert names and all("bwd_persistent_kernel" in n for n in names), names
    assert len(names) == 1


def _bwd_plan_as(plan, s, tv, parts, grid):
    """``plan`` with another tile (tv threads), part count and grid."""
    tiles = -(-plan.vectors_per_row // tv)
    units = -(-s // (256 // tv))
    n = plan.tsum_floats // (2 * plan.vectors_per_row * plan.cv)
    return dataclasses.replace(
        plan, row_threads=tv, channel_tile=tv * plan.cv, rows_per_unit=256 // tv, tiles=tiles,
        units=units, parts=parts, items=n * tiles * parts, grid=grid,
        part_floats=2 * n * plan.vectors_per_row * plan.cv * parts)


# (threads a tile, parts, grid) at (1, 72^3, 64) bf16: 16-byte vectors, so
# 4 threads are a 64-byte tile (two tiles), 8 the whole row. The first is the
# plan of a sweep that once ended in an illegal address: two items a block.
@pytest.mark.parametrize("tv,parts,grid", [(4, 264, 264), (4, 132, 264), (8, 264, 264),
                                           (8, 1, 1), (4, 5832, 132), (8, 11664, 264)])
def test_instance_norm_backward_kernel_plans(cuda, tv, parts, grid):
    """Other launch plans than the card's own at one shape: every row once,
    the same gradients, bitwise reruns."""
    from hdenseformer_tpu_torch.ops.instance_norm import bwd_plan, launch_bwd

    shape = (1, 72, 72, 72, 64)
    x, dy, scale, bias, stats = _norm_backward_case(cuda, shape, torch.bfloat16, True, True,
                                                    seed=72)
    plan = _bwd_plan_as(bwd_plan(x, dy), 72**3, tv, parts, grid)
    assert plan.vec_bytes == 16 and plan.grid <= plan.items
    got = launch_bwd(plan, torch.empty_like(x), dy, x, stats, scale, bias, True)
    again = launch_bwd(plan, torch.empty_like(x), dy, x, stats, scale, bias, True)
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, True)
    torch.cuda.synchronize()
    assert_norm_grads_close(got, ref, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_instance_norm_backward_refuses_a_plan_it_cannot_run(cuda):
    """Scratch shorter than the plan's partials, or a grid the card cannot
    hold at once, is refused before anything runs; the next call is clean."""
    from hdenseformer_tpu_torch.ops.instance_norm import bwd_plan, launch_bwd

    x, dy, scale, bias, stats = _norm_backward_case(cuda, (1, 72, 72, 72, 64),
                                                    torch.bfloat16, True, True, seed=73)
    plan = bwd_plan(x, dy)
    short = dataclasses.replace(plan, part_floats=plan.part_floats - 2)
    wide = _bwd_plan_as(plan, 72**3, 4, 5832, 11664)  # ~44 blocks a multiprocessor
    for bad in (short, wide):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch_bwd(bad, torch.empty_like(x), dy, x, stats, scale, bias, True)
    got = instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
    (x.float() * 2).sum()  # a PyTorch launch after the refusals
    torch.cuda.synchronize()
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, True)
    assert_norm_grads_close(got, ref, torch.bfloat16)


def test_hecktor_remat_step_on_the_card(cuda):
    """Hecktor20Top1 (n_filters 32, 32^3, packed) with remat on and off, fp32
    through the kernels, cuDNN deterministic: equal loss, gradients within
    1e-4 of each tensor's max, and the launches the model's code gives: the
    recompute runs the 27 norms and 4 half-shifts of the checkpointed blocks
    again, the backward once. The bar: the max-pool and trilinear backwards
    add with atomics, so any two runs' fp32 gradients differ in their
    rounding, which the SE norms of five levels amplify (1.1e-5 of a conv
    weight's max measured on the H100)."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        g = torch.Generator(device=cuda).manual_seed(12)
        x = torch.randn(2, 32, 32, 32, 2, generator=g, device=cuda)
        label = torch.zeros(2, 32, 32, 32, 2, device=cuda)
        label[..., 0] = 1
        label[:, 8:20, 10:22, 6:18] = torch.tensor([0.0, 1.0], device=cuda)
        runs = {}
        for remat in (False, True):
            net = get_net("hecktor20top1", 2, 2, (32, 32, 32), remat=remat, device=cuda).train()
            init_weights(net, torch.Generator().manual_seed(0))
            shift_pack.launches = shift_unpack.launches = 0
            instance_norm_relu.launches = instance_norm_relu_bwd.launches = 0
            loss = get_loss("FocalLoss")(net(x), label)
            loss.backward()
            torch.cuda.synchronize()
            runs[remat] = (float(loss.detach()), {n: p.grad for n, p in net.named_parameters()},
                           (instance_norm_relu.launches, shift_pack.launches,
                            instance_norm_relu_bwd.launches, shift_unpack.launches))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    (loss0, grads0, counts0), (loss1, grads1, counts1) = runs[False], runs[True]
    assert counts0 == (30, 4, 30, 3) and counts1 == (57, 8, 30, 3)
    assert loss1 == loss0
    for name, ref in grads0.items():
        assert float((grads1[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


def test_instance_norm_backward_kernel_mean_far_from_zero(cuda):
    # 1000 + N(0, 1) in fp32: the kernel works relative to the forward's
    # shift, the plain version in the absolute frame given the same statistics
    x, dy, scale, bias, stats = _norm_backward_case(cuda, (2, 4096, 32), torch.float32, True,
                                                    True, seed=80, mean=1000.0, spread=1.0)
    got = instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, True)
    torch.cuda.synchronize()
    assert_norm_grads_close(got, ref, torch.float32)


@pytest.mark.parametrize("affine", [True, False])
def test_instance_norm_gradient_through_autograd(cuda, affine):
    # the autograd function against autograd of the plain forward, fp32
    g = torch.Generator(device=cuda).manual_seed(90)
    x = torch.randn((2, 6, 7, 8, 32), generator=g, device=cuda) * 2 + 1
    w = torch.randn(x.shape, generator=g, device=cuda)
    scale = (torch.rand(32, generator=g, device=cuda) + 0.5) if affine else None
    bias = torch.randn(32, generator=g, device=cuda) if affine else None
    grads = {}
    for fn in (instance_norm_relu, instance_norm_relu_ref):
        xr, sr, br = (None if t is None else t.clone().requires_grad_() for t in (x, scale, bias))
        instance_norm_relu.launches = instance_norm_relu_bwd.launches = 0
        (fn(xr, sr, br) * w).sum().backward()
        grads[fn] = ([t.grad for t in (xr, sr, br) if t is not None],
                     (instance_norm_relu.launches, instance_norm_relu_bwd.launches))
    (got, counts), (ref, plain_counts) = grads[instance_norm_relu], grads[instance_norm_relu_ref]
    assert counts == (1, 1) and plain_counts == (0, 0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_attention_gradient_through_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(91)
    qkv = torch.randn(2, 729, 96, generator=g, device=cuda, requires_grad=True)
    w = torch.randn(2, 8, 729, 4, generator=g, device=cuda)
    grads = []
    for fn in (dense_attention, attention_ref):
        q, k, v = (t.view(2, 729, 8, 4).transpose(1, 2) for t in qkv.split(32, dim=-1))
        dense_attention.launches = 0
        (gq,) = torch.autograd.grad((fn(q, k, v) * w).sum(), qkv)
        grads.append((gq, dense_attention.launches))
    assert grads[0][1] == 1 and grads[1][1] == 0
    # the backward is the plain math's on both paths: equal up to summation order
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-5)


def test_model_gradients_through_the_kernels(cuda):
    """The fault this guards: the kernels' outputs had no grad_fn, so a
    backward through the kernel path dropped every gradient upstream of a
    norm or an attention. fp32, TF32 off, dropout on from one seed.

    Two correct ReLU networks' gradients differ wherever rounding moves an
    activation across zero, so the bar is the plain path's own difference
    when its input moves by 1e-6: per-tensor max|d| / max|g_plain|, worst
    and median over the tensors that have a gradient, within 3x that run's.
    The conv biases under a norm without affine (ZERO_GRADIENT) get only
    rounding noise: their max|g| within 10x the plain and moved runs'."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    nets = [
        get_net("HDenseFormer_16", 2, 2, (32, 32, 32), transformer_depth=4,
                use_kernels=use, remat=False, device=cuda).train()
        for use in (True, False, False)
    ]
    init_weights(nets[0], torch.Generator().manual_seed(0))
    for net in nets[1:]:
        net.load_state_dict(nets[0].state_dict())
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 32, 32, 32, 2, generator=g, device=cuda)
    moved = x * (1 + 1e-6 * torch.randn(x.shape, generator=g, device=cuda))
    label = torch.zeros(2, 32, 32, 32, 2, device=cuda)
    label[..., 0] = 1
    label[:, 8:20, 10:22, 6:18] = torch.tensor([0.0, 1.0], device=cuda)
    criterion = get_loss("FocalLoss", use_ds=True)
    losses, counts = [], []
    for net, inp in zip(nets, (x, x, moved)):
        dense_attention.launches = instance_norm_relu.launches = 0
        instance_norm_relu_bwd.launches = 0
        loss = criterion(net(inp, generator=torch.Generator(device=cuda).manual_seed(4)), label)
        loss.backward()
        losses.append(float(loss.detach()))
        counts.append((dense_attention.launches, instance_norm_relu.launches,
                       instance_norm_relu_bwd.launches))
    torch.cuda.synchronize()
    assert counts == [(8, 18, 18), (0, 0, 0), (0, 0, 0)]
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    grads = [dict(net.named_parameters()) for net in nets]
    assert set(ZERO_GRADIENT) <= set(grads[0])
    ratios = {"kernels": [], "moved": []}
    for name, p in grads[0].items():
        ref = grads[1][name].grad
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        if name in ZERO_GRADIENT:
            continue
        for key, other in (("kernels", p.grad), ("moved", grads[2][name].grad)):
            ratios[key].append(float((other - ref).abs().max() / ref.abs().max()))
    got, noise = sorted(ratios["kernels"]), sorted(ratios["moved"])
    assert got[-1] <= 3 * noise[-1] and got[len(got) // 2] <= 3 * noise[len(noise) // 2]
    zero = [max(float(g[n].grad.abs().max()) for n in ZERO_GRADIENT) for g in grads]
    assert zero[0] <= 10 * max(zero[1:]), zero


def test_train_step_does_not_wait_for_the_card(cuda):
    """make_train_step keeps the loss, dice and confusion matrix on the card
    and never waits for it: a step runs under sync debug mode "error"."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step
    from hdenseformer_tpu_torch.train.state import get_optimizer

    net = get_net("HDenseFormer_16", 2, 2, (32, 32, 32), transformer_depth=4, device=cuda,
                  dtype=torch.bfloat16)
    init_weights(net, torch.Generator().manual_seed(0))
    state = TrainState(net, get_optimizer("Adam", 1e-3, weight_decay=1e-4,
                                          params=net.parameters()))
    step = make_train_step(get_loss("FocalLoss", use_ds=True), 2)
    g = torch.Generator(device=cuda).manual_seed(6)
    label = torch.zeros(2, 32, 32, 32, 2, device=cuda)
    label[..., 0] = 1
    label[:, 8:20, 10:22, 6:18] = torch.tensor([0.0, 1.0], device=cuda)
    batch = {"image": torch.randn(2, 32, 32, 32, 2, generator=g, device=cuda), "label": label,
             "weight": torch.tensor([1.0, 0.0], device=cuda)}
    step(state, batch, g)  # the first step builds the kernels and cuDNN's plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = step(state, batch, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 2 and bool(torch.isfinite(out["loss"]))
    assert int(out["cm"].sum()) == 32 ** 3


def test_remat_step_equals_the_plain_step_on_the_card(cuda):
    """remat=True against remat=False: HDenseFormer_32 at 64^3, depth 4, fp32
    through the kernels, cuDNN deterministic, one dropout seed. The loss is
    equal, every gradient within 1e-5 of its tensor's max (the trilinear
    upsampling's backward adds with atomics; the ZERO_GRADIENT biases within
    1e-5 of the largest gradient), and the generator ends in the
    same state: the recompute drew the forward's masks. Under remat every
    forward kernel runs twice (the recompute), the backward once."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        g = torch.Generator(device=cuda).manual_seed(5)
        x = torch.randn(1, 64, 64, 64, 2, generator=g, device=cuda)
        label = torch.zeros(1, 64, 64, 64, 2, device=cuda)
        label[..., 0] = 1
        label[:, 20:40, 24:44, 16:36] = torch.tensor([0.0, 1.0], device=cuda)
        runs = {}
        for remat in (False, True):
            net = get_net("HDenseFormer_32", 2, 2, (64, 64, 64), transformer_depth=4,
                          remat=remat, device=cuda).train()
            init_weights(net, torch.Generator().manual_seed(0))
            gen = torch.Generator(device=cuda).manual_seed(9)
            dense_attention.launches = instance_norm_relu.launches = 0
            instance_norm_relu_bwd.launches = 0
            loss = get_loss("FocalLoss", use_ds=True)(net(x, generator=gen), label)
            loss.backward()
            torch.cuda.synchronize()
            runs[remat] = (float(loss.detach()), {n: p.grad for n, p in net.named_parameters()},
                           gen.get_state(), (dense_attention.launches,
                                             instance_norm_relu.launches,
                                             instance_norm_relu_bwd.launches))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    (loss0, grads0, state0, counts0), (loss1, grads1, state1, counts1) = runs[False], runs[True]
    assert counts0 == (8, 18, 18) and counts1 == (16, 36, 18)
    assert loss1 == loss0 and torch.equal(state1, state0)
    top = max(float(g.abs().max()) for g in grads0.values())
    for name, ref in grads0.items():
        # the ZERO_GRADIENT biases get rounding noise: held against the largest
        scale = top if name in ZERO_GRADIENT else float(ref.abs().max())
        assert float((grads1[name] - ref).abs().max()) <= 1e-5 * scale, name


def _raw_case(shape, seed=0):
    """A raw CT+PET batch (B, *spatial, 2) and its class volume, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    image = torch.randn(*shape, 2, generator=g)
    image[..., 0] = image[..., 0] * 800 + 100
    image[..., 1] = image[..., 1].abs() * 5 + 1
    label = torch.zeros(shape)
    c = [s // 2 for s in shape[1:]]
    label[:, c[0] - 8:c[0] + 8, c[1] - 6:c[1] + 9, c[2] - 7:c[2] + 7] = 1
    return image, label


def test_device_augmentation_on_the_card_matches_the_cpu(cuda):
    """The same draw applied on the card and on the CPU: image within 1e-5
    (absolute, and relative), labels equal but where a soft value rounds
    across 0.5 (at most 1e-4 of the voxels)."""
    from hdenseformer_tpu_torch.data import augment_device as ta

    image, label = _raw_case((2, 40, 38, 36))
    draw = ta.draw_batch_3d(torch.Generator().manual_seed(3), image.shape, (32, 32, 32))
    got_i, got_l = ta.apply_batch_3d(image.to(cuda), label.to(cuda), draw.to(cuda), 2)
    ref_i, ref_l = ta.apply_batch_3d(image, label, draw, 2)
    torch.testing.assert_close(got_i.cpu(), ref_i, rtol=1e-5, atol=1e-5)
    assert float((got_l.cpu() != ref_l).any(-1).float().mean()) <= 1e-4


def test_augmented_train_step_has_no_host_sync(cuda):
    """The step with on-device augmentation (crop origins drawn on the card,
    the crop a gather) never waits for the card."""
    from hdenseformer_tpu_torch.data.augment_device import augment_batch_3d
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step
    from hdenseformer_tpu_torch.train.state import get_optimizer

    net = get_net("HDenseFormer_32", 2, 2, (32, 32, 32), transformer_depth=2, device=cuda)
    init_weights(net, torch.Generator().manual_seed(0))
    state = TrainState(net, get_optimizer("Adam", 1e-3, weight_decay=1e-4,
                                          params=net.parameters()))
    step = make_train_step(get_loss("FocalLoss", use_ds=True), 2, augment_fn=lambda g, i, l:
                           augment_batch_3d(g, i, l, (32, 32, 32), num_classes=2))
    image, label = _raw_case((2, 40, 38, 36))
    batch = {"image": image.to(cuda), "label": label.to(cuda),
             "weight": torch.tensor([1.0, 0.0], device=cuda)}
    gens = [torch.Generator(device=cuda).manual_seed(s) for s in (1, 2)]
    step(state, batch, *gens)  # the first step builds the kernels and cuDNN's plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = step(state, batch, *gens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 2 and bool(torch.isfinite(out["loss"]))
    assert int(out["cm"].sum()) == 32 ** 3


def _unetr_pair(cuda):
    """UNETR at 32^3 (12 layers, hidden 48, 4 heads, mlp 96, feature size 8),
    through the kernels and through the plain versions, one set of weights."""
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.models.unetr import UNETR

    small = dict(feature_size=8, hidden_size=48, mlp_dim=96, num_heads=4)
    nets = [UNETR(2, 2, (32, 32, 32), use_kernels=use, device=cuda, **small)
            for use in (True, False, False)]
    init_weights(nets[0], torch.Generator().manual_seed(0))
    for net in nets[1:]:
        net.load_state_dict(nets[0].state_dict())
    return nets


def test_unetr_forward_goes_through_the_kernels(cuda):
    """UNETR's 15 InstanceNorms (affine, ReLU off) through the kernel, fp32,
    TF32 off: the kernel changes no value beyond summation order (the same
    bar as Hecktor20Top1's kernel path, 1e-4)."""
    net, plain, _ = _unetr_pair(cuda)
    x = torch.randn(2, 32, 32, 32, 2, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    instance_norm_relu.launches = instance_norm_relu_bwd.launches = 0
    with torch.inference_mode():
        got = net.eval()(x)
        launches = instance_norm_relu.launches
        ref = plain.eval()(x)
    torch.cuda.synchronize()
    assert launches == 15 and instance_norm_relu.launches == 15
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_unetr_train_step_goes_through_the_kernels(cuda):
    """One train step of UNETR through the kernels against the plain
    versions: 15 forward and 15 backward launches, the loss within 1e-5,
    every gradient within 3x the plain path's own difference on the input
    moved by 1e-6 (worst and median tensor, as
    test_model_gradients_through_the_kernels holds HDenseFormer's)."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step
    from hdenseformer_tpu_torch.train.state import get_optimizer

    nets = _unetr_pair(cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 32, 32, 32, 2, generator=g, device=cuda)
    label = torch.zeros(2, 32, 32, 32, 2, device=cuda)
    label[..., 0] = 1
    label[:, 8:20, 10:22, 6:18] = torch.tensor([0.0, 1.0], device=cuda)
    inputs = (x, x, x * (1 + 1e-6 * torch.randn(x.shape, generator=g, device=cuda)))
    step = make_train_step(get_loss("FocalLoss", use_ds=False), 2)
    losses, counts = [], []
    for net, inp in zip(nets, inputs):
        opt = get_optimizer("Adam", 1e-3, weight_decay=1e-4, params=net.parameters())
        instance_norm_relu.launches = instance_norm_relu_bwd.launches = 0
        _, out = step(TrainState(net, opt), {"image": inp, "label": label}, None)
        losses.append(float(out["loss"]))
        counts.append((instance_norm_relu.launches, instance_norm_relu_bwd.launches))
    assert counts == [(15, 15), (0, 0), (0, 0)]
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    grads = [dict(net.named_parameters()) for net in nets]
    ratios = {"kernels": [], "moved": []}
    for name, p in grads[0].items():
        ref = grads[1][name].grad
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        for key, other in (("kernels", p.grad), ("moved", grads[2][name].grad)):
            ratios[key].append(float((other - ref).abs().max() / ref.abs().max()))
    got, noise = sorted(ratios["kernels"]), sorted(ratios["moved"])
    assert got[-1] <= 3 * noise[-1] and got[len(got) // 2] <= 3 * noise[len(noise) // 2]


# HDenseFormer_2D_32 at PI-CAI22 (384^2, batch 24): one modality path's
# attention and each InstanceNorm shape, (S, C, affine)
ATTN_2D = (24, 8, 576, 4)
IN_2D = [(384 ** 2, 32, True), (192 ** 2, 64, True), (96 ** 2, 128, True), (48 ** 2, 256, True),
         (24 ** 2, 256, False), (48 ** 2, 128, False), (96 ** 2, 64, False),
         (192 ** 2, 32, False)]


def test_attention_kernel_at_the_2d_shape(cuda):
    g = torch.Generator(device=cuda).manual_seed(90)
    q, k, v = (torch.randn(ATTN_2D, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    got = dense_attention(q, k, v)
    ref = attention_ref(q.float(), k.float(), v.float())
    # bf16: one rounding of the output (test_attention_kernel_matches_fp32_math)
    torch.testing.assert_close(got.float(), ref, rtol=2**-8, atol=1e-5)
    assert torch.equal(got, dense_attention(q, k, v))


@pytest.mark.parametrize("s,c,affine", IN_2D)
def test_instance_norm_kernels_at_the_2d_shapes(cuda, s, c, affine):
    """Forward (one bf16 step of the plain version) and backward (the bars of
    assert_norm_grads_close) at batch 24, reruns bitwise."""
    x, dy, scale, bias, stats = _norm_backward_case(cuda, (24, s, c), torch.bfloat16, affine,
                                                    True, seed=91)
    got = instance_norm_relu(x, scale, bias)
    torch.testing.assert_close(got, instance_norm_relu_ref(x, scale, bias), rtol=2**-7, atol=1e-6)
    assert torch.equal(got, instance_norm_relu(x, scale, bias))
    grads = instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats), scale, bias, True)
    assert_norm_grads_close(grads, ref, torch.bfloat16)
    again = instance_norm_relu_bwd(dy, x, stats, scale, bias, True)
    assert all(a is None or torch.equal(a, b) for a, b in zip(grads, again))


def test_hdenseformer_2d_step_goes_through_the_kernels(cuda):
    """One train step of HDenseFormer_2D_16 (64^2, depth 4, 3 modalities,
    get_net's remat, dropout 0.5 from one seed), fp32 with TF32 off, through
    the kernels and through the plain versions: 2 x 12 attention, 36 + 18
    InstanceNorm launches; loss within 1e-5; gradients within 3x the plain
    path's own difference on the input moved by 1e-6 (worst and median
    tensor, as test_unetr_train_step_goes_through_the_kernels)."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step
    from hdenseformer_tpu_torch.train.state import get_optimizer

    nets = [get_net("HDenseFormer_2D_16", 3, 2, (64, 64), transformer_depth=4, use_kernels=use,
                    device=cuda) for use in (True, False, False)]
    init_weights(nets[0], torch.Generator().manual_seed(0))
    for net in nets[1:]:
        net.load_state_dict(nets[0].state_dict())
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 64, 64, 3, generator=g, device=cuda)
    label = torch.zeros(2, 64, 64, 2, device=cuda)
    label[..., 0] = 1
    label[:, 16:40, 20:44] = torch.tensor([0.0, 1.0], device=cuda)
    inputs = (x, x, x * (1 + 1e-6 * torch.randn(x.shape, generator=g, device=cuda)))
    step = make_train_step(get_loss("FocalLoss", use_ds=True), 2)
    losses, counts = [], []
    for net, inp in zip(nets, inputs):
        opt = get_optimizer("Adam", 1e-3, weight_decay=1e-4, params=net.parameters())
        dense_attention.launches = instance_norm_relu.launches = 0
        instance_norm_relu_bwd.launches = 0
        _, out = step(TrainState(net, opt), {"image": inp, "label": label},
                      torch.Generator(device=cuda).manual_seed(5))
        losses.append(float(out["loss"]))
        counts.append((dense_attention.launches, instance_norm_relu.launches,
                       instance_norm_relu_bwd.launches))
    assert counts == [(24, 36, 18), (0, 0, 0), (0, 0, 0)]
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    grads = [dict(net.named_parameters()) for net in nets]
    ratios = {"kernels": [], "moved": []}
    for name, p in grads[0].items():
        if name in ZERO_GRADIENT:
            continue
        ref = grads[1][name].grad
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        for key, other in (("kernels", p.grad), ("moved", grads[2][name].grad)):
            ratios[key].append(float((other - ref).abs().max() / ref.abs().max()))
    got, noise = sorted(ratios["kernels"]), sorted(ratios["moved"])
    assert got[-1] <= 3 * noise[-1] and got[len(got) // 2] <= 3 * noise[len(noise) // 2]
