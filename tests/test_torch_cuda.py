"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it runs where JAX is not installed; on the machine with
the card run it without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

fp32 comparisons turn TF32 off in cuDNN and cuBLAS, since a float32
convolution otherwise runs in TF32 on the card.
"""
import dataclasses
import json
import os

import numpy as np
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
    instance_norm_relu_shifted,
    instance_norm_relu_shifted_bwd,
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
NORM_WRAPPERS = (instance_norm_relu, instance_norm_relu_bwd, instance_norm_relu_shifted,
                 instance_norm_relu_shifted_bwd)


def reset_norm_counts() -> None:
    for fn in NORM_WRAPPERS:
        fn.launches = 0


def norm_counts() -> tuple:
    """InstanceNorm launches: forward, backward, shifted forward, shifted backward."""
    return tuple(fn.launches for fn in NORM_WRAPPERS)


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
    instance_norm_relu_shifted.launches = 0
    with torch.inference_mode():
        got = nets[0](x)
        counts = (dense_attention.launches, instance_norm_relu.launches,
                  instance_norm_relu_shifted.launches)
        ref = nets[1](x)
    torch.cuda.synchronize()
    # s2d=None packs levels 0-1 over (H, W): each level's first BasicConv,
    # left and right, is the shifted norm's
    assert counts == (2 * 4, 14, 4)
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


@pytest.mark.parametrize("size,s2d", [(32, True), (64, True), (64, {1: True, 2: (2,)})])
def test_hecktor_goes_through_the_kernels(cuda, size, s2d):
    """Hecktor20Top1 (n_filters 32, batch 2, fp32) packed through the kernels,
    packed through the plain versions and fine through the kernels; also at
    64^3 and with level 2 packed over W as well (its partial-rank convs shift
    without the kernel, so the launches are the default's)."""
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    nets = {
        (packed, use): get_net("hecktor20top1", 2, 2, (size,) * 3, s2d=s2d if packed else False,
                               use_kernels=use, device=cuda)
        for packed, use in ((True, True), (True, False), (False, True))
    }
    assert nets[True, True].packed2 == ((2,) if isinstance(s2d, dict) else None)
    init_weights(nets[True, True], torch.Generator().manual_seed(0))
    for net in nets.values():
        net.load_state_dict(nets[True, True].state_dict())
    x = torch.randn(2, size, size, size, 2, generator=torch.Generator(device=cuda).manual_seed(3),
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


# the launches of one forward at 144^3 through the kernels, each model at its preset
# (get_net's defaults: packed levels, HDenseFormer's depth 24): (attention, InstanceNorm,
# shifted InstanceNorm, half-shift, fused attention at head width 64)
PRESET_FORWARD = {"HDenseFormer_32": (48, 16, 2, 0, 0), "hecktor20top1": (0, 30, 0, 4, 0),
                  "TransBTS": (0, 0, 0, 1, 4), "unetr": (0, 15, 0, 0, 12)}


@pytest.mark.parametrize("name", sorted(PRESET_FORWARD))
def test_forward_at_the_preset_size_goes_through_the_kernels(cuda, name):
    """Each model that launches a kernel, at the Hecktor21 preset's full width
    and 144^3 patch, bf16, batch 1: its eval forward through the kernels
    against the plain versions (``use_kernels=False``, which launches none)
    from the same weights. bf16 rounds each path differently, so the bars
    are on the argmax: 99 % of the voxels, and 99.9 % of those whose plain
    top-two margin exceeds 0.1 (a tenth of the logits' order; the paths'
    differences are far below it). TransBTS's BatchNorm statistics stay
    where they were."""
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.ops.mha import mha

    wrappers = (dense_attention, instance_norm_relu, instance_norm_relu_shifted, shift_pack, mha)
    nets = [get_net(name, 2, 2, (144,) * 3, dtype=torch.bfloat16, use_kernels=use, device=cuda)
            for use in (True, False)]
    init_weights(nets[0], torch.Generator().manual_seed(0))
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.randn(1, 144, 144, 144, 2, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    buffers = {n: b.clone() for n, b in nets[0].named_buffers()}
    outs, counts = [], []
    with torch.inference_mode():
        for net in nets:
            for fn in wrappers:
                fn.launches = 0
            out = net(x)
            outs.append(out[0] if isinstance(out, (list, tuple)) else out)
            counts.append(tuple(fn.launches for fn in wrappers))
    torch.cuda.synchronize()
    assert counts == [PRESET_FORWARD[name], (0,) * 5]
    assert all(torch.equal(b, buffers[n]) for n, b in nets[0].named_buffers())
    got, ref = outs
    assert got.shape == ref.shape == (1, 144, 144, 144, 2) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())
    top = ref.topk(2, dim=-1).values
    decided = top[..., 0] - top[..., 1] > 0.1
    same = got.argmax(-1) == ref.argmax(-1)
    assert float(same.float().mean()) >= 0.99
    assert float(same[decided].float().mean()) >= 0.999, float(decided.float().mean())


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


def _qkv_views(cuda, b, h, n, d, dtype, seed):
    """q, k, v as the model gives them: head views of one qkv projection, and
    a gradient for the output."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = (t.view(b, n, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1))
    return q, k, v, torch.randn(b, h, n, d, generator=g, device=cuda).to(dtype)


def _attention_grads(fn, q, k, v, dout):
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(fn(*xs), xs, dout)


def _attention_grads_f64(q, k, v, dout):
    d = q.shape[-1]

    def f64(q, k, v):
        return torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1) @ v

    return _attention_grads(f64, *(t.double() for t in (q, k, v, dout)))


def _grad_errors(grads, exact):
    """Each of dQ, dK, dV: largest error over the largest exact value, mean
    error over the mean exact value."""
    errs = []
    for got, ref in zip(grads, exact):
        diff = (got.double() - ref).abs()
        errs.append((float(diff.max() / ref.abs().max()), float(diff.mean() / ref.abs().mean())))
    return errs


@pytest.mark.parametrize("shape,dtype", [
    ((24, 8, 576, 4), torch.bfloat16), ((2, 8, 729, 4), torch.bfloat16),
    ((2, 8, 130, 4), torch.float32), ((2, 8, 130, 4), torch.bfloat16),
    ((2, 8, 130, 8), torch.float32), ((2, 8, 130, 8), torch.bfloat16),
], ids=["2d-step", "3d-step", "n130-d4-fp32", "n130-d4-bf16", "n130-d8-fp32", "n130-d8-bf16"])
def test_attention_backward_is_as_precise_as_the_plain_math(cuda, shape, dtype):
    """The backward kernels' dQ, dK and dV against float64 math on the same
    inputs (strided head views of one qkv), beside the plain path's own
    error: each within twice it, by the largest and by the mean. One backward
    launch a backward, and none for the plain path."""
    q, k, v, dout = _qkv_views(cuda, *shape, dtype, seed=92)
    dense_attention.backward_launches = 0
    got = _attention_grads(dense_attention, q, k, v, dout)
    torch.cuda.synchronize()
    assert dense_attention.backward_launches == 1
    plain = _attention_grads(attention_ref, q, k, v, dout)
    assert dense_attention.backward_launches == 1
    exact = _attention_grads_f64(q, k, v, dout)
    assert all(g.dtype == dtype and g.shape == q.shape and bool(torch.isfinite(g).all())
               for g in got)
    for name, e, p in zip(("dq", "dk", "dv"), _grad_errors(got, exact),
                          _grad_errors(plain, exact)):
        assert e[0] <= 2 * p[0] and e[1] <= 2 * p[1], (name, e, p)


def test_attention_gradient_through_autograd(cuda):
    """The gradient of the qkv projection through the kernels (fp32, the
    serving shape's 729 tokens): one forward and one backward launch, within
    twice the plain path's error against float64 (the kernels recompute P
    from the saved log-sum-exp, so the paths no longer agree up to summation
    order alone)."""
    g = torch.Generator(device=cuda).manual_seed(91)
    qkv = torch.randn(2, 729, 96, generator=g, device=cuda, requires_grad=True)
    w = torch.randn(2, 8, 729, 4, generator=g, device=cuda)
    grads = []
    for fn in (dense_attention, attention_ref):
        q, k, v = (t.view(2, 729, 8, 4).transpose(1, 2) for t in qkv.split(32, dim=-1))
        dense_attention.launches = dense_attention.backward_launches = 0
        (gq,) = torch.autograd.grad((fn(q, k, v) * w).sum(), qkv)
        grads.append((gq, dense_attention.launches, dense_attention.backward_launches))
    assert grads[0][1:] == (1, 1) and grads[1][1:] == (0, 0)
    x = qkv.detach().double().requires_grad_()
    q, k, v = (t.view(2, 729, 8, 4).transpose(1, 2) for t in x.split(32, dim=-1))
    probs = torch.softmax(q @ k.transpose(-1, -2) * 0.5, dim=-1)
    (exact,) = torch.autograd.grad(((probs @ v) * w.double()).sum(), x)
    got, plain = _grad_errors([grads[0][0], grads[1][0]], [exact, exact])
    assert got[0] <= 2 * plain[0] and got[1] <= 2 * plain[1], (got, plain)


def test_attention_backward_is_bitwise_deterministic(cuda):
    """Two backwards on the same inputs give the same bits: no atomics, and
    the splits' sums meet in a fixed order (the 3-D step's 8 splits)."""
    q, k, v, dout = _qkv_views(cuda, 2, 8, 729, 4, torch.bfloat16, seed=93)
    runs = [_attention_grads(dense_attention, q, k, v, dout) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_attention_backward_captured_equals_eager(cuda):
    """The forward and backward kernels captured in a CUDA graph and replayed
    on new inputs copied into the static ones: the eager call's bits; the
    capture counts its one backward launch, a replay none."""
    q, k, v, dout = _qkv_views(cuda, 24, 8, 576, 4, torch.bfloat16, seed=94)
    static = [t.clone() for t in (q, k, v, dout)]
    dense_attention.backward_launches = 0
    graph, outs = _capture(lambda: _attention_grads(dense_attention, *static))
    captured = dense_attention.backward_launches
    fresh = _qkv_views(cuda, 24, 8, 576, 4, torch.bfloat16, seed=95)
    for s_, x in zip(static, fresh):
        s_.copy_(x)
    graph.replay()
    torch.cuda.synchronize()
    assert dense_attention.backward_launches == captured
    for got, ref in zip(outs, _attention_grads(dense_attention, *fresh)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_serving_attention_writes_nothing_for_a_backward(cuda, monkeypatch):
    """Under inference_mode (serving) and without grad, the forward kernel is
    called with null O and log-sum-exp pointers, as before the backward
    kernels; a forward that will be differentiated passes both (bf16: O in
    fp32; fp32: O is the output itself, so only the log-sum-exp)."""
    from hdenseformer_tpu_torch.ops import dense_attention as ops

    lib = ops.load_library()
    seen = []

    class Recording:
        def __getattr__(self, name):
            return getattr(lib, name)

        def hdf_dense_attention(self, q, k, v, o, o32, lse, *rest):
            seen.append((o32 is not None, lse is not None))
            return lib.hdf_dense_attention(q, k, v, o, o32, lse, *rest)

    monkeypatch.setattr(ops, "load_library", Recording)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _ = _qkv_views(cuda, 8, 8, 729, 4, dtype, seed=96)
        with torch.inference_mode():
            dense_attention(q, k, v)
        with torch.no_grad():
            dense_attention(*(t.detach().requires_grad_() for t in (q, k, v)))
        dense_attention(*(t.detach().requires_grad_() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert seen == [(False, False), (False, False), (True, True),
                    (False, False), (False, False), (False, True)]


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
        reset_norm_counts()
        dense_attention.launches = 0
        loss = criterion(net(inp, generator=torch.Generator(device=cuda).manual_seed(4)), label)
        loss.backward()
        losses.append(float(loss.detach()))
        counts.append((dense_attention.launches,) + norm_counts())
    torch.cuda.synchronize()
    assert counts == [(8, 14, 14, 4, 4), (0,) * 5, (0,) * 5]
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
            dense_attention.launches = 0
            reset_norm_counts()
            loss = get_loss("FocalLoss", use_ds=True)(net(x, generator=gen), label)
            loss.backward()
            torch.cuda.synchronize()
            runs[remat] = (float(loss.detach()), {n: p.grad for n, p in net.named_parameters()},
                           gen.get_state(), (dense_attention.launches,) + norm_counts())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    (loss0, grads0, state0, counts0), (loss1, grads1, state1, counts1) = runs[False], runs[True]
    # level 0 packed over (H, W): block_1_1_left and block_1_1_right shifted
    assert counts0 == (8, 16, 16, 2, 2) and counts1 == (16, 32, 16, 4, 2)
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
    the kernels and through the plain versions: 2 x 12 attention forward and
    12 backward, 36 + 18 InstanceNorm launches; loss within 1e-5; gradients
    within 3x the plain path's own difference on the input moved by 1e-6
    (worst and median tensor, as
    test_unetr_train_step_goes_through_the_kernels)."""
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
        dense_attention.launches = dense_attention.backward_launches = 0
        reset_norm_counts()
        _, out = step(TrainState(net, opt), {"image": inp, "label": label},
                      torch.Generator(device=cuda).manual_seed(5))
        losses.append(float(out["loss"]))
        counts.append((dense_attention.launches, dense_attention.backward_launches)
                      + norm_counts())
    # levels 0-1 packed at full rank: 4 of the 18 norms shifted, each twice
    # with the recompute; one attention backward a layer of each modality
    assert counts == [(24, 12, 28, 14, 8, 4), (0,) * 6, (0,) * 6]
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


@pytest.mark.parametrize("name,channels,shape,backwards", [
    ("HDenseFormer_32", 2, (32, 32, 32), 48), ("HDenseFormer_2D_32", 3, (64, 64), 72),
], ids=["3d", "2d"])
def test_preset_depth_step_launches_one_attention_backward_a_layer(cuda, name, channels, shape,
                                                                     backwards):
    """One bf16 train step of each HDenseFormer at its presets' depth (24)
    and modalities (Hecktor21's 2, PI-CAI22's 3), on a small patch (the
    counts do not depend on it): one attention backward kernel launch a
    transformer layer of each modality path, 48 a 3-D step and 72 a 2-D
    step, and the forward twice a layer (get_net's remat recomputes it)."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step
    from hdenseformer_tpu_torch.train.state import get_optimizer

    net = get_net(name, channels, 2, shape, dtype=torch.bfloat16, device=cuda)
    init_weights(net, torch.Generator().manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2, *shape, channels, generator=g, device=cuda)
    label = torch.zeros(2, *shape, 2, device=cuda)
    label[..., 0] = 1
    step = make_train_step(get_loss("FocalLoss", use_ds=True), 2)
    opt = get_optimizer("Adam", 1e-3, weight_decay=1e-4, params=net.parameters())
    dense_attention.launches = dense_attention.backward_launches = 0
    _, out = step(TrainState(net, opt), {"image": x, "label": label},
                  torch.Generator(device=cuda).manual_seed(5))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out["loss"]))
    assert (dense_attention.launches, dense_attention.backward_launches) == (2 * backwards,
                                                                            backwards)


# --- the shifted InstanceNorm (packed-shifted input, pad slots masked) -----


def _shifted_case(cuda, n, sshape, dims, c, dtype, affine, relu, seed, garbage="normal"):
    """A packed-shifted x whose pad slots hold garbage, dy, scale, bias. The
    garbage is large ("normal": N(0, 1e4^2) in x, N(0, 1e3^2) in dy as
    everywhere) or not finite ("nonfinite": NaN, +Inf and -Inf in turn, in x
    and dy), which would turn any sum it reached into NaN or Inf."""
    from hdenseformer_tpu_torch.ops.s2d import apply_shifted_mask

    g = torch.Generator(device=cuda).manual_seed(seed)
    f = 2 ** len(dims)
    x = torch.randn((n, *sshape, f * c), generator=g, device=cuda) * 3 + 1
    valid = apply_shifted_mask(torch.ones_like(x), dims) > 0
    dy = torch.randn(x.shape, generator=g, device=cuda) * 1e3  # large at pads too
    junk = 1e4 * torch.randn(x.shape, generator=g, device=cuda)
    if garbage == "nonfinite":
        turn = torch.arange(x.numel(), device=cuda).reshape(x.shape) % 3
        junk = torch.tensor([float("nan"), float("inf"), -float("inf")], device=cuda)[turn]
        dy = torch.where(valid, dy, junk.roll(1))
    x = torch.where(valid, x, junk).to(dtype)
    dy = dy.to(dtype)
    scale = bias = None
    if affine:
        scale = torch.randn(c, generator=g, device=cuda)
        scale[0] = 0.0
        bias = torch.randn(c, generator=g, device=cuda)
    return x, dy, scale, bias


# (n, cells, packed dims, C). Beside the first six: an extent of 2 along a
# packed dim (its every slot a pad slot of some parity block), three packed
# dims (f = 8), C = 1, 2, 4, 8 (bf16 vectors of 2, 4, 8 and 16 bytes), and
# shapes of many chunks and of several units an item in the backward, where
# each thread's walk takes many steps
SHIFTED_CASES = [((2, (5, 6, 7), (1, 2), 16)), ((1, (4, 9, 5), (2,), 64)),
                 ((2, (3, 5, 6), (0, 2), 32)), ((1, (5, 4, 6), (0, 1, 2), 2)),
                 ((3, (9, 10), (0, 1), 32)), ((1, (33, 17), (1,), 256)),
                 ((2, (2, 5, 6), (0, 2), 8)), ((1, (3, 2, 2), (1, 2), 4)),
                 ((1, (4, 3, 5), (0, 1, 2), 8)), ((2, (7, 9), (0, 1), 2)),
                 ((1, (6, 5, 7), (0, 1, 2), 1)), ((2, (40, 37, 21), (1, 2), 32)),
                 ((3, (129, 65), (0, 1), 16))]


@pytest.mark.parametrize("garbage", ["normal", "nonfinite"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(SHIFTED_CASES)))
def test_shifted_instance_norm_kernels_match_plain(cuda, case, dtype, affine, relu, garbage):
    """Forward (the bars of test_instance_norm_kernel_ragged_rows) and
    backward (assert_norm_grads_close, given the same statistics) of the
    shifted mode against its plain versions; 0 at every pad slot, whatever
    x and dy hold there (NaN and Inf included: the statistics, dscale and
    dbias stay finite); reruns bitwise; one launch each, counted under the
    shifted wrappers."""
    n, sshape, dims, c = SHIFTED_CASES[case]
    x, dy, scale, bias = _shifted_case(cuda, n, sshape, dims, c, dtype, affine, relu, 90 + case,
                                       garbage)
    reset_norm_counts()
    y, stats = instance_norm_relu_fwd(x, scale, bias, relu=relu, shifted=dims)
    got = instance_norm_relu_bwd(dy, x, stats, scale, bias, relu, shifted=dims)
    again = instance_norm_relu_bwd(dy, x, stats, scale, bias, relu, shifted=dims)
    torch.cuda.synchronize()
    assert norm_counts() == (0, 0, 1, 2)
    ref_y = instance_norm_relu_ref(x, scale, bias, relu=relu, shifted=dims)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-6)
    torch.testing.assert_close(y, ref_y, **tol)
    ref = instance_norm_relu_bwd_ref(dy, x, *absolute_stats(x, stats, dims), scale, bias, relu,
                                     shifted=dims)
    f = 2 ** len(dims)
    view = lambda t: t.reshape(n, -1, c)  # noqa: E731
    assert_norm_grads_close((view(got[0]),) + got[1:], (view(ref[0]),) + ref[1:], dtype)
    from hdenseformer_tpu_torch.ops.s2d import apply_shifted_mask

    pads = apply_shifted_mask(torch.ones(x.shape, device=cuda), dims) == 0
    assert pads.any() and not y[pads].any() and not got[0][pads].any()
    assert torch.isfinite(stats).all() and torch.isfinite(y).all()
    assert all(t is None or torch.isfinite(t).all() for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    assert y.shape == x.shape and f * c == x.shape[-1]


def test_shifted_instance_norm_kernel_mean_far_from_zero(cuda):
    """The centred sums' guard in the shifted mode: 1000 + N(0, 1) at the
    valid slots (the shift x0, row 0, is one of them), garbage at the pads.
    The plain version runs on x - 1000 at the valid slots, exact in fp32
    there, as test_instance_norm_kernel_mean_far_from_zero's."""
    from hdenseformer_tpu_torch.ops.s2d import apply_shifted_mask

    x, _, scale, bias = _shifted_case(cuda, 2, (6, 9, 9), (1, 2), 32, torch.float32, True,
                                      True, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    valid = apply_shifted_mask(torch.ones(x.shape, device=cuda), (1, 2)) > 0
    far = torch.where(valid, 1000 + torch.randn(x.shape, generator=g, device=cuda), x)
    got = instance_norm_relu(far, scale, bias, shifted=(1, 2))
    ref = instance_norm_relu_ref(torch.where(valid, far - 1000, x), scale, bias, shifted=(1, 2))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_packed_models_go_through_the_shifted_kernels(cuda):
    """HDenseFormer_2D_16 (levels 0-1 packed at full rank) through the
    kernels against the plain versions in fp32: the same logits to 1e-4, and
    the launches the code gives (4 of its 18 norms shifted)."""
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    nets = [get_net("HDenseFormer_2D_16", 3, 2, (64, 64), transformer_depth=4, use_kernels=use,
                    device=cuda) for use in (True, False)]
    init_weights(nets[0], torch.Generator().manual_seed(0))
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    reset_norm_counts()
    with torch.inference_mode():
        got = nets[0](x)
        counts = norm_counts()
        ref = nets[1](x)
    torch.cuda.synchronize()
    assert counts == (14, 0, 4, 0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# --- the captured train step (make_multi_train_step) -----------------------------------


def _multi_step_case(cuda, k: int):
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.train.loop import TrainState
    from hdenseformer_tpu_torch.train.state import get_optimizer, make_capturable

    def state():
        net = get_net("HDenseFormer_16", 2, 2, (32, 32, 32), transformer_depth=4,
                      remat=False, device=cuda)
        init_weights(net, torch.Generator().manual_seed(0))
        opt = get_optimizer("Adam", 1e-3, weight_decay=1e-4, params=net.parameters())
        return TrainState(net, make_capturable(opt, cuda))

    g = torch.Generator(device=cuda).manual_seed(4)
    label = torch.zeros(k, 2, 32, 32, 32, 2, device=cuda)
    label[..., 0] = 1
    label[:, :, 8:20, 10:22, 6:18] = torch.tensor([0.0, 1.0], device=cuda)
    batches = {"image": torch.randn(k, 2, 32, 32, 32, 2, generator=g, device=cuda),
               "label": label}
    return state, batches, get_loss("FocalLoss", use_ds=True)


def test_captured_steps_equal_eager_steps(cuda):
    """K = 3 steps of HDenseFormer_16 (32^3, depth 4, fp32, dropout 0.5)
    captured as a CUDA graph and replayed, against 3 eager steps seeded as
    the trainer seeds them, both with the capturable Adam; cuDNN
    deterministic. The first step's loss within 1e-6 relative (the same
    arithmetic), the later ones within 1e-4 (cuBLAS may split a product
    otherwise under capture, and Adam amplifies it: observed 4.5e-5 at step
    3, the one-step bar of tests/test_torch_train.py); the parameters
    within 2 lr a step (Adam moves a parameter by about lr whatever its
    gradient's size, so a rounding-level gradient near zero can flip an
    update, and at this size a rounding step moves the gradients by up to a
    percent of a tensor's largest: JAX's bar for its scan,
    tests/test_multi_step.py). The wrappers count one step's launches, at
    capture."""
    from hdenseformer_tpu_torch.ops.dense_attention import dense_attention as attention
    from hdenseformer_tpu_torch.train.loop import (
        make_multi_train_step,
        make_train_step,
        step_seed,
    )

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        make_state, batches, crit = _multi_step_case(cuda, 3)
        captured, eager = make_state(), make_state()
        multi = make_multi_train_step(crit, 2)
        multi.warmup(captured, batches)
        reset_norm_counts()
        attention.launches = 0
        captured, out = multi(captured, batches, 11)
        assert attention.launches == 4 * 2 and norm_counts()[:2] != (0, 0)
        step, gen, losses = make_train_step(crit, 2), torch.Generator(device=cuda), []
        for i in range(3):
            gen.manual_seed(step_seed(11, eager.step))
            eager, m = step(eager, {n: v[i] for n, v in batches.items()}, gen)
            losses.append(float(m["loss"]))
    finally:
        torch.backends.cudnn.deterministic = old
    assert captured.step == eager.step == 3
    torch.testing.assert_close(out["loss"][0].item(), losses[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(out["loss"].cpu(), torch.tensor(losses), rtol=1e-4, atol=0)
    for (n, p), q in zip(captured.model.named_parameters(), eager.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=3 * 2e-3, msg=n)


def test_captured_step_follows_the_learning_rate(cuda):
    """set_learning_rate between calls reaches the replayed step: a rate of
    0 leaves every parameter where it was (the capturable Adam reads its
    rate from the card)."""
    from hdenseformer_tpu_torch.train.loop import make_multi_train_step
    from hdenseformer_tpu_torch.train.state import set_learning_rate

    make_state, batches, crit = _multi_step_case(cuda, 2)
    state = make_state()
    multi = make_multi_train_step(crit, 2)
    state, _ = multi(state, batches, 0)
    before = [p.detach().clone() for p in state.model.parameters()]
    set_learning_rate(state.optimizer, 0.0)
    state, out = multi(state, batches, 0)
    assert bool(torch.isfinite(out["loss"]).all())
    assert all(torch.equal(p, q) for p, q in zip(state.model.parameters(), before))


def _capture(fn):
    """``fn()`` captured as a CUDA graph after a warm-up run; returns
    (graph, the captured outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _grads_of(op, *inputs):
    def run():
        xs = [x.detach().requires_grad_() for x in inputs]
        y = op(*xs)
        gy = torch.ones_like(y)
        return (y,) + torch.autograd.grad(y, xs, gy)
    return run


@pytest.mark.parametrize("kernel", ["dense_attention", "instance_norm_relu",
                                    "instance_norm_relu_shifted", "shift_pack"])
def test_kernel_wrappers_capture_forward_and_backward(cuda, kernel):
    """Each kernel wrapper, forward and backward (the InstanceNorm backward
    is the cooperative launch), captured as a CUDA graph and replayed on new
    inputs copied into the static ones: the same outputs as eager calls."""
    g = torch.Generator(device=cuda).manual_seed(9)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    scale = torch.rand(32, generator=g, device=cuda)
    bias = torch.randn(32, generator=g, device=cuda)
    op, inputs = {
        "dense_attention": (dense_attention, [rand(2, 8, 130, 4) for _ in range(3)]),
        "instance_norm_relu": (lambda x: instance_norm_relu(x, scale, bias), [rand(2, 4096, 32)]),
        "instance_norm_relu_shifted": (
            lambda x: instance_norm_relu_shifted(x, (1, 2), scale, bias),
            [rand(2, 8, 9, 9, 128)]),
        "shift_pack": (shift_pack, [rand(2, 6, 5, 7, 64)]),
    }[kernel]
    static = [x.clone() for x in inputs]
    graph, outs = _capture(_grads_of(op, *static))
    fresh = [torch.randn(x.shape, generator=g, device=cuda).to(x.dtype) for x in inputs]
    for s, x in zip(static, fresh):
        s.copy_(x)
    graph.replay()
    want = _grads_of(op, *fresh)()
    torch.cuda.synchronize()
    for got, ref in zip(outs, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_transbts_plain_build_launches_no_kernel(cuda):
    """get_net("TransBTS", use_kernels=False) at 32^3 (levels 0-1 packed):
    a train forward and backward launch no kernel of the port; with the
    kernels, its packed InitConv launches the half-shift once."""
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    launches = {}
    for use in (False, True):
        net = get_net("TransBTS", 2, 2, (32, 32, 32), use_kernels=use, device=cuda)
        init_weights(net, torch.Generator().manual_seed(0))
        net.train()
        reset_norm_counts()
        dense_attention.launches = shift_pack.launches = shift_unpack.launches = 0
        x = torch.randn(2, 32, 32, 32, 2, device=cuda)
        net(x, generator=torch.Generator(device=cuda).manual_seed(1)).square().mean().backward()
        torch.cuda.synchronize()
        launches[use] = (dense_attention.launches, shift_pack.launches, shift_unpack.launches,
                         norm_counts())
    assert launches[False] == (0, 0, 0, (0, 0, 0, 0))
    assert launches[True][1] == 1


# --- the trainer's captured steps and serving graphs (utils/graphs.py) -------------------

# every name of get_net at a small size, as tests/test_torch_use_kernels.py
# builds them: 3-D at 32^3 (the DAUNet family and TransBTS at 16^3), 2-D at
# 32^2, the smp-style baselines at 64^2 on resnet18
CAPTURE_NETS = [("HDenseFormer_32", (32,) * 3, None), ("HDenseFormer_16", (32,) * 3, None),
                ("HDenseFormer_2D_32", (32, 32), None), ("HDenseFormer_2D_16", (32, 32), None),
                ("hecktor20top1", (32,) * 3, None), ("unet_3d", (16,) * 3, None),
                ("da_unet", (16,) * 3, None), ("se_unet", (16,) * 3, None),
                ("da_se_unet", (16,) * 3, None), ("res_da_se_unet", (16,) * 3, None),
                ("TransBTS", (16,) * 3, None), ("unetr", (32,) * 3, None),
                ("unet", (64, 64), "resnet18"), ("unet++", (64, 64), "resnet18"),
                ("deeplabv3+", (64, 64), "resnet18")]
CAPTURE_LR = 1e-3


def _capture_case(cuda, name, shape, encoder, batch: int = 2, optimizer: str = "Adam"):
    """(make_state, batches of 2 steps, the preset's loss): get_net's
    defaults (remat on), fp32, ``optimizer`` (Adam) with coupled L2; the
    Hecktor21 and PI-CAI22 presets' FocalLoss, deep supervision for
    HDenseFormer."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.train.loop import TrainState
    from hdenseformer_tpu_torch.train.state import get_optimizer

    def make_state():
        net = get_net(name, 2, 2, shape, transformer_depth=4, encoder_name=encoder,
                      device=cuda)
        init_weights(net, torch.Generator().manual_seed(0))
        return TrainState(net, get_optimizer(optimizer, CAPTURE_LR, weight_decay=1e-4,
                                             params=net.parameters()))

    g = torch.Generator(device=cuda).manual_seed(4)
    inner = tuple(slice(s // 4, 3 * s // 4) for s in shape)
    batches = []
    for i in range(2):
        label = torch.zeros((batch,) + shape + (2,), device=cuda)
        label[..., 0] = 1
        label[(slice(None),) + inner] = torch.tensor([0.0, 1.0], device=cuda)
        image = torch.randn((batch,) + shape + (2,), generator=g, device=cuda)
        image[(slice(None),) + inner + (0,)] += 2.0
        batches.append({"image": image, "label": label,
                        "weight": torch.tensor([1.0] * (batch - i) + [0.0] * i, device=cuda)})
    return make_state, batches, get_loss("FocalLoss", use_ds="DenseFormer" in name)


@pytest.fixture
def deterministic_cudnn():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = old


@pytest.mark.parametrize("name,shape,encoder", CAPTURE_NETS)
def test_captured_train_and_eval_steps_equal_eager(cuda, deterministic_cudnn, name, shape,
                                                   encoder):
    """Two train steps of every model of get_net captured as one CUDA graph
    (``CapturedTrainStep``, the trainer's step: the second batch's last
    sample masked by weight 0) against two eager steps from the same
    weights, batches and seeds: the first loss within 1e-6 relative (the
    same arithmetic), the second within 1e-4 or 3x the spread of eager steps
    on the input moved by one fp32 rounding step (Adam turns rounding into
    whole-lr moves, and a BatchNorm bottleneck
    that normalises two values a channel amplifies them), the parameters
    within 2 lr a step, and a BatchNorm model's running statistics moved by
    the captured steps (at least half as far as by the eager ones) and
    within 1e-3 of that distance or 3x the moved input's spread of them.
    Then the captured eval step against the eager one on the trained state,
    within 1e-6."""
    _hold_captured_against_eager(cuda, name, shape, encoder, "Adam")


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW", "SGD"])
def test_captured_steps_equal_eager_for_each_optimizer(cuda, deterministic_cudnn, optimizer):
    """Each optimizer of get_optimizer in the trainer's captured step
    (``make_capturable``: Adam's and AdamW's capturable update, SGD's fused
    one, each reading its rate on the card), HDenseFormer_16 with remat,
    held to the bars of ``test_captured_train_and_eval_steps_equal_eager``."""
    _hold_captured_against_eager(cuda, "HDenseFormer_16", (32,) * 3, None, optimizer)


def _hold_captured_against_eager(cuda, name, shape, encoder, optimizer, mesh=None):
    """The bars above; under ``mesh`` every step and eval of the three runs
    runs inside it."""
    import contextlib

    from hdenseformer_tpu_torch.train.loop import (
        CapturedEvalStep,
        CapturedTrainStep,
        make_eval_step,
        make_train_step,
        seed_generators,
    )
    from hdenseformer_tpu_torch.utils.graphs import GraphCache

    make_state, batches, crit = _capture_case(cuda, name, shape, encoder, optimizer=optimizer)
    g = torch.Generator(device=cuda).manual_seed(5)
    moved = [dict(b, image=b["image"] * (1 + 2.0 ** -23 * torch.randn(
        b["image"].shape, generator=g, device=cuda))) for b in batches]
    runs = {}
    for run, captured, data in (("captured", True, batches), ("eager", False, batches),
                                ("moved", False, moved)):
        state, graphs = make_state(), GraphCache()
        initial = {n: b.detach().clone() for n, b in state.model.named_buffers()
                   if b.is_floating_point()}
        step = CapturedTrainStep(crit, 2, graphs=graphs) if captured else make_train_step(crit, 2)
        gens, losses = (torch.Generator(device=cuda), None), []
        with mesh or contextlib.nullcontext():
            for batch in data:
                seed_generators(gens, 7, state.step)
                state, out = step(state, batch, *gens)
                losses.append(out["loss"])
            evaluate = CapturedEvalStep(crit, 2, graphs) if captured else make_eval_step(crit, 2)
            runs[run] = dict(state=state, losses=torch.stack(losses).tolist(), initial=initial,
                             graphs=graphs, eval=evaluate(state, batches[0]),
                             eager_eval=make_eval_step(crit, 2)(state, batches[0]),
                             buffers=dict(state.model.named_buffers()))
    cap, eager, mov = runs["captured"], runs["eager"], runs["moved"]
    assert cap["graphs"].captured == 2 and cap["state"].step == eager["state"].step == 2
    torch.testing.assert_close(cap["losses"][0], eager["losses"][0], rtol=1e-6, atol=0)
    spread = abs(mov["losses"][1] - eager["losses"][1]) / abs(eager["losses"][1])
    torch.testing.assert_close(cap["losses"][1], eager["losses"][1],
                               rtol=max(1e-4, 3 * spread), atol=0)
    for (n, p), q in zip(cap["state"].model.named_parameters(),
                         eager["state"].model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=2 * 2 * CAPTURE_LR, msg=n)
    for n, b in cap["buffers"].items():
        if n in cap["initial"]:
            ref, start = eager["buffers"][n], eager["initial"][n]
            moved_by = float((ref - start).norm())
            assert float((b - start).norm()) >= 0.5 * moved_by, (n, moved_by)
            bar = max(1e-3 * moved_by, 3 * float((mov["buffers"][n] - ref).norm()))
            assert float((b - ref).norm()) <= bar, (n, moved_by, bar)
    for n, v in cap["eval"].items():
        torch.testing.assert_close(v, cap["eager_eval"][n], rtol=1e-6, atol=0, msg=n)


@pytest.mark.parametrize("loss", ["Cross_Entropy", "TopKLoss", "DiceLoss", "CEPlusDice",
                                  "FLPlusDice"])
def test_class_weighted_losses_capture(cuda, deterministic_cudnn, loss):
    """Each loss of get_loss that takes a ``class_weight`` (its vector made
    on the card once, not copied from the host at each step) in a captured
    train step of unet_3d at 16^3: the first loss equal to the eager step's
    within 1e-6."""
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.train.loop import CapturedTrainStep, make_train_step

    make_state, batches, _ = _capture_case(cuda, "unet_3d", (16,) * 3, None)
    crit = get_loss(loss, class_weight=[0.25, 1.0], topk=10)
    got = [CapturedTrainStep(crit, 2)(make_state(), batches[1], torch.Generator(device=cuda)),
           make_train_step(crit, 2)(make_state(), batches[1], torch.Generator(device=cuda))]
    torch.testing.assert_close(got[0][1]["loss"], got[1][1]["loss"], rtol=1e-6, atol=0)


def _grads(net, x, generator) -> dict:
    """A remat forward and backward in training: the loss and every gradient."""
    net.train()
    for p in net.parameters():
        p.grad = None
    outs = net(x, generator=generator)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    loss = sum(o.float().square().mean() for o in outs)
    loss.backward()
    return {"loss": loss.detach(), **{n: p.grad for n, p in net.named_parameters()
                                      if p.grad is not None}}


@pytest.mark.parametrize("name", ["HDenseFormer_16", "hecktor20top1"])
def test_remat_under_capture_draws_the_forward_masks(cuda, deterministic_cudnn, name):
    """A remat forward and backward (HDenseFormer_16 with dropout 0.5 in its
    checkpointed attention blocks; Hecktor20Top1's 22 checkpointed blocks)
    captured once and replayed with two dropout seeds, against the eager
    remat pass seeded alike: the loss and every gradient within 1e-4 of the
    gradient's largest magnitude (fp32 rounding summed over the network: up
    to 1.1e-5 observed, Hecktor20Top1's bottleneck weights), where a
    recompute that drew other masks than the forward moves HDenseFormer's
    by O(1) of it (the eager pass of another seed moves the loss by more
    than 1e-3). The generator ends where the eager pass leaves it."""
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.utils.graphs import CapturedCall

    net = get_net(name, 2, 2, (32,) * 3, transformer_depth=4, device=cuda)
    init_weights(net, torch.Generator().manual_seed(0))
    assert net.remat
    x = torch.randn(2, 32, 32, 32, 2, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    gen = torch.Generator(device=cuda)
    call = CapturedCall(lambda s: _grads(net, s["x"], gen), {"x": x}, (gen,))
    if name == "HDenseFormer_16":
        assert call.rng is not None and len(call.rng.offsets) == 2  # one per modality path
    for seed in (11, 12):
        gen.manual_seed(seed)
        got = call.replay({"x": x})
        ref_gen = torch.Generator(device=cuda).manual_seed(seed)
        want = _grads(net, x, ref_gen)
        assert gen.get_offset() == ref_gen.get_offset()
        other = _grads(net, x, torch.Generator(device=cuda).manual_seed(seed + 10))
        for n, v in want.items():
            if n in ZERO_GRADIENT:  # a true gradient of zero: rounding noise either way
                continue
            scale = float(v.abs().max()) or 1.0
            err = float((got[n] - v).abs().max())
            assert err <= 1e-4 * scale, (seed, n, err, scale)
        if name == "HDenseFormer_16":
            assert float((other["loss"] - want["loss"]).abs()) > 1e-3 * float(want["loss"])


def test_captured_predict_volume_equals_eager(cuda):
    """``predict_volume``'s whole call captured as one graph of the lattice
    cell (the default on a card) against ``capture=False``: HDenseFormer_16
    (32^3 patches, depth 4) on two 2 x 48 x 40 x 44 volumes, window batch 4
    (the last batch padded): the labels equal on every voxel (the same
    kernels on the same inputs); the second volume replays the model's one
    graph."""
    from hdenseformer_tpu_torch.infer import sliding
    from hdenseformer_tpu_torch.utils.graphs import model_graphs

    net = _serving_net(cuda)
    rng = torch.Generator().manual_seed(2)
    volumes = [torch.randn(2, 48, 40, 44, generator=rng).numpy() for _ in range(2)]
    for image in volumes:
        got = sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4)
        want = sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4,
                                      capture=False)
        assert got.shape == want.shape == image.shape[1:]
        assert (got == want).all()
    assert model_graphs(net).captured == 1


def _serving_net(cuda):
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights

    net = get_net("HDenseFormer_16", 2, 2, (32,) * 3, transformer_depth=4, device=cuda)
    init_weights(net, torch.Generator().manual_seed(0))
    return net


def test_serving_graph_reads_zeros_in_the_pad_after_a_larger_volume(cuda):
    """The stale-pad trap on the card: 44 x 40 x 20 after 48 x 48 x 32 (one
    lattice cell: 48 x 48 x 32, 4 windows), whose windows read the 12 pad
    slices that the larger volume (values around 3) filled in the graph's
    buffers: each equal to ``capture=False`` on every voxel, one graph."""
    from hdenseformer_tpu_torch.infer import sliding
    from hdenseformer_tpu_torch.utils.graphs import model_graphs

    net = _serving_net(cuda)
    rng = torch.Generator().manual_seed(3)
    big = 3.0 + torch.randn(2, 48, 48, 32, generator=rng).numpy()
    short = torch.randn(2, 44, 40, 20, generator=rng).numpy()
    for image in (big, short):
        got = sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4)
        want = sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4,
                                      capture=False)
        assert got.shape == image.shape[1:] and (got == want).all()
    assert model_graphs(net).captured == 1


def test_serving_graph_is_one_launch_a_call(cuda):
    """A warm captured ``predict_volume`` call issues one graph launch and no
    kernel launch (the volume, origins and weights copied in, the labels
    out); the eager call launches its kernels one by one."""
    from torch.profiler import ProfilerActivity, profile

    from hdenseformer_tpu_torch.infer import sliding

    net = _serving_net(cuda)
    image = torch.randn(2, 48, 40, 44, generator=torch.Generator().manual_seed(2)).numpy()
    counts = {}
    for capture in (True, False):
        sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4,
                               capture=capture)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4,
                                   capture=capture)
        events = {e.key: e.count for e in prof.key_averages()}
        counts[capture] = (events.get("cudaGraphLaunch", 0),
                           sum(n for k, n in events.items() if "LaunchKernel" in k
                               or "LaunchCooperativeKernel" in k))
    assert counts[True] == (1, 0), counts
    assert counts[False][0] == 0 and counts[False][1] > 100, counts


def test_captured_window_forward_follows_rebound_parameters(cuda):
    """A model whose parameters are rebound after its first captured call
    (``load_state_dict(assign=True)``, the head's class-1 bias moved by 2,
    the old tensors still alive, so that a stale graph would read them) is
    captured anew: the accumulator of ``accumulate_windows`` (one replay of
    the whole-call graph) equals the eager one of the new weights within
    1e-4, and differs from the old one by more than 0.05; the model holds
    one graph, the new one."""
    from hdenseformer_tpu_torch.infer import sliding
    from hdenseformer_tpu_torch.utils.graphs import model_graphs

    net = _serving_net(cuda).eval()
    volume = torch.randn(48, 48, 48, 2, generator=torch.Generator(device=cuda).manual_seed(2),
                         device=cuda)
    origins = sliding._origins_array(sliding.cal_steps((48,) * 3, (32,) * 3, (16,) * 3))
    args = (volume, origins, np.ones(len(origins), np.float32), (32,) * 3, 2, None, 4)
    with torch.inference_mode():
        old = sliding.accumulate_windows(net, *args)
        kept = net.state_dict()
        new = {n: v.clone() for n, v in kept.items()}
        new["head.bias"][1] += 2.0
        net.load_state_dict(new, assign=True)
        got = sliding.accumulate_windows(net, *args)
        want = sliding.accumulate_windows(net, *args, capture=False)
    assert float((got - want).abs().max()) <= 1e-4
    assert float((old - want).abs().max()) > 0.05
    assert model_graphs(net).captured == 1 and len(kept)


def test_captured_predict_case_2d_equals_eager(cuda):
    """``predict_case_2d``'s chunk captured as one graph (the default on a
    card) against ``capture=False``: HDenseFormer_2D_16 (32^2, depth 4) on a
    3 x 30 x 40 x 44 volume in chunks of 24 slices, the last one padded with
    zeros: the labels equal on every voxel, one graph for both chunks."""
    from hdenseformer_tpu_torch.infer.slices import predict_case_2d
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.utils.graphs import model_graphs

    net = get_net("HDenseFormer_2D_16", 3, 2, (32, 32), transformer_depth=4, device=cuda)
    init_weights(net, torch.Generator().manual_seed(0))
    image = torch.randn(3, 30, 40, 44, generator=torch.Generator().manual_seed(2)).numpy()
    got = predict_case_2d(net, image, (32, 32))
    want = predict_case_2d(net, image, (32, 32), capture=False)
    assert got.shape == want.shape == (30, 40, 44) and (got == want).all()
    assert model_graphs(net).captured == 1


# --- the trainer (train/loop.py SemanticSeg) ----------------------------------------------

# tests/test_torch_trainer.py's run: HDenseFormer_16 at 32^3 patches of 40^3 cases, depth 4,
# fp32, remat, dropout 0.5, batch 2
TRAINER_KNOBS = dict(net_name="HDenseFormer_16", channels=2, num_classes=2, roi_number=None,
                     input_shape=(32,) * 3, patch_size=(32,) * 3, step_size=(16,) * 3,
                     batch_size=2, num_workers=2, lr=1e-3, weight_decay=1e-4, use_fp16=False,
                     transformer_depth=4, transform_3d=[1, 2, 4, 5, 6], seed=3)
TRAINER_SETUP = dict(optimizer="Adam", loss_fun="FocalLoss", use_ds=True, lr_scheduler=None)


def _npy_reader(path: str, key: str) -> np.ndarray:
    """A volume of a case directory of ``<key>.npy`` files (a missing one
    raises KeyError, as the trainer's readers do)."""
    f = os.path.join(path, key + ".npy")
    if not os.path.exists(f):
        raise KeyError(key)
    return np.load(f).astype(np.float32)


def _npy_cases(root, n: int, shape=(40, 40, 40)) -> list:
    """tests/fixtures.py's synthetic CT+PET cases (int16-range noise, a ball
    as the label) as ``.npy`` case directories: the card's machine may have
    no h5py."""
    paths = []
    for i in range(n):
        rng = np.random.RandomState(i)
        image = rng.randint(-1024, 2000, size=(2,) + shape).astype(np.int16)
        centre = [rng.randint(s // 4, 3 * s // 4) for s in shape]
        grids = np.ogrid[tuple(slice(0, s) for s in shape)]
        ball = sum((g - c) ** 2 for g, c in zip(grids, centre)) <= (min(shape) // 6) ** 2
        path = os.path.join(root, f"sample{i}_case")
        os.makedirs(path)
        np.save(os.path.join(path, "ct.npy"), image)
        np.save(os.path.join(path, "seg.npy"), ball.astype(np.uint8))
        paths.append(path)
    return paths


def _graphs_by_epoch(log_dir: str) -> list:
    """(train, val) graphs captured in each epoch, from the run's metrics.jsonl."""
    seen = {}
    with open(os.path.join(log_dir, "fold1", "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["tag"].endswith("/graphs_captured"):
                seen.setdefault(r["step"], {})[r["tag"].split("/")[1]] = int(r["value"])
    return [(seen[e]["train"], seen[e]["val"]) for e in sorted(seen)]


@pytest.mark.parametrize("device_augment", [False, True])
def test_trainer_trains_resumes_and_serves_on_the_card(cuda, deterministic_cudnn, tmp_path,
                                                      device_augment):
    """``SemanticSeg``'s journey on the card with its steps captured (the
    default), at TRAINER_KNOBS on 3 training cases and 1 validation case
    (2 steps an epoch): two epochs straight, each step shape captured in the
    first epoch and replayed in the second; then a run resumed from the
    first epoch's checkpoint for the second epoch, which starts at its epoch
    and step and ends where the straight run ended, to the bars of
    ``test_captured_steps_equal_eager_steps`` (the epoch's loss within 1e-4,
    the parameters within 2 lr a step: the backward's atomics round
    differently in the two runs and Adam turns that into whole-lr moves);
    then ``inference_slidingwindow`` of the validation case, captured
    against ``capture=False``: equal labels on every voxel. With
    ``device_augment`` the loader ships raw cases and the captured step
    augments them on the card."""
    from hdenseformer_tpu_torch.train.loop import SemanticSeg

    class NpySemanticSeg(SemanticSeg):
        reader = staticmethod(_npy_reader)

    paths = _npy_cases(str(tmp_path / "cases"), 4)
    train, val = paths[:3], paths[3:]

    def run(name, **knobs):
        seg = NpySemanticSeg(**dict(TRAINER_KNOBS, n_epoch=2, device=cuda,
                                    device_augment=device_augment, **knobs))
        hist = seg.trainer(train, val, 1, output_dir=str(tmp_path / name / "ckpt"),
                           log_dir=str(tmp_path / name / "log"), **TRAINER_SETUP)
        assert all(np.isfinite(hist[k]).all() for k in ("train_loss", "val_loss")), hist
        return seg, hist

    straight, hist = run("straight")
    graphs = _graphs_by_epoch(str(tmp_path / "straight" / "log"))
    assert graphs[0][0] >= 1 and graphs[0][1] >= 1 and graphs[1] == (0, 0), graphs
    ckpts = os.listdir(tmp_path / "straight" / "ckpt" / "fold1")
    first = [f for f in ckpts if f.startswith("epoch=0-")]
    assert len(first) == 1 and len(ckpts) <= 3, ckpts
    resumed, hist2 = run("resumed", pre_trained=True, ckpt_point=True,
                         weight_path=str(tmp_path / "straight" / "ckpt" / "fold1" / first[0]))
    assert resumed.start_epoch == 1 and resumed.state.step == straight.state.step == 4
    assert hist2["train_loss"] == pytest.approx(hist["train_loss"][1:], rel=1e-4)
    for (name, p), q in zip(straight.state.model.named_parameters(),
                            resumed.state.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=2 * 2 * TRAINER_KNOBS["lr"], msg=name)

    labels = {}
    for capture in (True, False):
        resumed.capture = capture
        out = resumed.inference_slidingwindow(val, str(tmp_path / f"seg-{capture}"))
        labels[capture] = np.load(out[0])
    assert labels[True].shape == (40, 40, 40) and set(np.unique(labels[True])) <= {0, 1}
    assert (labels[True] == labels[False]).all()


def _world_of_one(backend: str, monkeypatch):
    """A process group of one rank in this process (``tcp://`` on a free
    local port) and its mesh on the card with ``always_reduce``."""
    import socket

    import torch.distributed as dist

    from hdenseformer_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    return make_mesh(1, "cuda:0", always_reduce=True)


def test_mesh_capture_under_gloo_on_a_card_raises(cuda, monkeypatch):
    """gloo's collectives run through the host: under a gloo mesh on the
    card, ``predict_volume`` and the captured train and eval steps raise an
    error that names ``capture=False``, before any work; ``capture=False``
    serves, and the labels equal those without a mesh."""
    import torch.distributed as dist

    from hdenseformer_tpu_torch.infer import sliding
    from hdenseformer_tpu_torch.losses import get_loss
    from hdenseformer_tpu_torch.train.loop import CapturedEvalStep, CapturedTrainStep, TrainState
    from hdenseformer_tpu_torch.train.state import get_optimizer

    net = _serving_net(cuda)
    image = torch.randn(2, 48, 40, 44, generator=torch.Generator().manual_seed(2)).numpy()
    mesh = _world_of_one("gloo", monkeypatch)
    try:
        state = TrainState(net, get_optimizer("Adam", 1e-3, params=net.parameters()))
        crit = get_loss("FocalLoss", use_ds=True)
        batch = {"image": torch.zeros(1, 32, 32, 32, 2, device=cuda),
                 "label": torch.zeros(1, 32, 32, 32, 2, device=cuda)}
        with mesh:
            with pytest.raises(RuntimeError, match="capture=False"):
                CapturedTrainStep(crit, 2)(state, batch, torch.Generator(device=cuda))
            with pytest.raises(RuntimeError, match="capture=False"):
                CapturedEvalStep(crit, 2)(state, batch)
        with pytest.raises(RuntimeError, match="capture=False"):
            sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4, mesh=mesh)
        assert not state.optimizer.state
        got = sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4,
                                     mesh=mesh, capture=False)
    finally:
        dist.destroy_process_group()
    want = sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4,
                                  capture=False)
    assert (got == want).all()


@pytest.mark.parametrize("name,shape", [("HDenseFormer_16", (32,) * 3), ("da_unet", (16,) * 3)])
def test_mesh_capture_nccl_steps_equal_eager(cuda, deterministic_cudnn, monkeypatch, name,
                                            shape):
    """NCCL at world 1 with ``always_reduce`` (the collectives run, each the
    identity): the captured train and eval steps, their global sums
    (forward and backward, BatchNorm's statistics for da_unet) and the
    gradients' all-reduce inside the graph, against the eager steps on the
    same mesh, at ``test_captured_train_and_eval_steps_equal_eager``'s bars."""
    import torch.distributed as dist

    mesh = _world_of_one("nccl", monkeypatch)
    try:
        _hold_captured_against_eager(cuda, name, shape, None, "Adam", mesh=mesh)
    finally:
        dist.destroy_process_group()


def test_mesh_capture_nccl_predict_volume_equals_eager(cuda, monkeypatch):
    """``predict_volume(mesh=...)`` under NCCL at world 1 with
    ``always_reduce``: the accumulator's all-reduce inside the graph; the
    labels equal ``capture=False``'s on the same mesh and those without a
    mesh on every voxel."""
    import torch.distributed as dist

    from hdenseformer_tpu_torch.infer import sliding

    net = _serving_net(cuda)
    image = torch.randn(2, 48, 40, 44, generator=torch.Generator().manual_seed(2)).numpy()
    mesh = _world_of_one("nccl", monkeypatch)
    try:
        got = [sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4,
                                      mesh=mesh, capture=capture) for capture in (True, False)]
    finally:
        dist.destroy_process_group()
    want = sliding.predict_volume(net, image, (32,) * 3, (16,) * 3, 2, window_batch=4)
    assert all((g == want).all() for g in got)


def test_capture_outlives_dead_graphs_in_reference_cycles(cuda):
    """A captured call that dies in a reference cycle keeps its CUDA graph
    until Python's cyclic collector runs; were the collector to destroy it
    while another call captures, that capture would be invalidated. A
    second call whose body runs the collector (as an allocation may)
    captures and replays: ``CapturedCall.capture`` collects first."""
    import gc
    import weakref

    from hdenseformer_tpu_torch.utils.graphs import CapturedCall

    x = torch.arange(1024.0, device=cuda)
    old = CapturedCall(lambda s: {"y": s["x"] * 2}, {"x": x})
    old.replay({"x": x})

    def body(s):
        gc.collect()
        return {"y": s["x"] + 1}

    call = CapturedCall(body, {"x": x})
    cycle = [old]
    cycle.append(cycle)  # the only reference to the old call, in a cycle
    dead = weakref.ref(old)
    del old, cycle
    out = call.replay({"x": x})
    assert dead() is None and call.graph is not None and torch.equal(out["y"], x + 1)


def test_refused_capture_raises(cuda):
    """A body that reads a value on the host cannot be captured: the capture
    raises (there is no eager fallback)."""
    from hdenseformer_tpu_torch.utils.graphs import CapturedCall

    x = torch.ones(4, device=cuda)
    call = CapturedCall(lambda s: {"y": s["x"] * float(s["x"].sum())}, {"x": x})
    with pytest.raises(RuntimeError):
        call.replay({"x": x})


# --- the fused attention at head width 64 (ops/mha.py, csrc/mha64.cu) ---------------------

def _mha_exact(qkv, heads, keep, p, dout):
    """O and the gradient of qkv in float64 by the formulas, one (b, h) at a
    time: the exact values that the kernel and the plain math each round."""
    b, n, _ = qkv.shape
    x = qkv.double().reshape(b, n, 3, heads, 64)
    do = dout.double().reshape(b, n, heads, 64)
    out = torch.empty(b, n, heads, 64, dtype=torch.float64, device=qkv.device)
    grad = torch.empty(b, n, 3, heads, 64, dtype=torch.float64, device=qkv.device)
    scale = 64 ** -0.5
    for i in range(b):
        for h in range(heads):
            q, k, v = x[i, :, 0, h], x[i, :, 1, h], x[i, :, 2, h]
            probs = torch.softmax(q @ k.T * scale, dim=-1)
            m = keep[i, h].double() / (1 - p) if keep is not None else 1.0
            kept = probs * m
            out[i, :, h] = kept @ v
            g = do[i, :, h]
            dp = (g @ v.T) * m
            ds = probs * (dp - (probs * dp).sum(-1, keepdim=True))
            grad[i, :, 0, h] = ds @ k * scale
            grad[i, :, 1, h] = ds.T @ q * scale
            grad[i, :, 2, h] = kept.T @ g
            del probs, kept, dp, ds
    return out.reshape(b, n, -1), grad.reshape(b, n, -1)


def _mha_errors(out, grad, exact_out, exact_grad, heads):
    """Max and mean error of O, dQ, dK, dV, each over its exact values'
    largest / mean magnitude."""
    b, n = out.shape[:2]
    parts = {"o": (out, exact_out)}
    for j, name in enumerate(("dq", "dk", "dv")):
        parts[name] = (grad.reshape(b, n, 3, -1)[:, :, j], exact_grad.reshape(b, n, 3, -1)[:, :, j])
    errs = {}
    for name, (got, ref) in parts.items():
        diff = (got.double() - ref).abs()
        errs[name] = (float(diff.max() / ref.abs().max()), float(diff.mean() / ref.abs().mean()))
    return errs


def _mha_inputs(cuda, b, heads, n, p, train, seed=0):
    from hdenseformer_tpu_torch.models.layers import dropout_keep

    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * 64, generator=g, device=cuda).to(torch.bfloat16)
    dout = torch.randn(b, n, heads * 64, generator=g, device=cuda).to(torch.bfloat16)
    keep = dropout_keep((b, heads, n, n), p, cuda, g) if train and p > 0 else None
    return qkv, dout, keep


def _out_and_grad(fn, qkv, dout):
    x = qkv.detach().requires_grad_()
    out = fn(x)
    (dx,) = torch.autograd.grad(out, x, dout)
    return out.detach(), dx


@pytest.mark.parametrize("b,heads,n,p,train", [
    (2, 8, 5832, 0.1, True), (2, 8, 5832, 0.1, False), (2, 12, 216, 0.0, True),
    (1, 2, 1000, 0.1, True), (1, 2, 130, 0.1, True),
], ids=["transbts-train", "transbts-eval", "unetr", "n1000", "n130-ragged"])
def test_mha_kernel_is_as_precise_as_the_plain_math(cuda, b, heads, n, p, train):
    """Forward and backward of the fused kernel against float64 formulas on
    the same bf16 inputs and keep mask, beside the plain math's own error
    (fp32 scores and softmax, bf16 P.V as the port runs it on the CPU): each
    of O, dQ, dK and dV within twice the plain path's error, by the largest
    and by the mean. TransBTS's shape in training and in eval; UNETR's 216
    tokens of 12 heads; 1000 tokens (a ragged last tile); 130 (N % 8 != 0,
    the mask read a byte at a time)."""
    from hdenseformer_tpu_torch.ops.mha import attention_ref, mha

    qkv, dout, keep = _mha_inputs(cuda, b, heads, n, p, train)
    mha.launches = mha.backward_launches = 0
    out, grad = _out_and_grad(lambda x: mha(x, heads, keep, p), qkv, dout)
    torch.cuda.synchronize()
    assert (mha.launches, mha.backward_launches) == (1, 1)
    ref_out, ref_grad = _out_and_grad(lambda x: attention_ref(x, heads, keep, p), qkv, dout)
    exact = _mha_exact(qkv, heads, keep, p, dout)
    got = _mha_errors(out, grad, *exact, heads)
    plain = _mha_errors(ref_out, ref_grad, *exact, heads)
    assert bool(torch.isfinite(out).all() and torch.isfinite(grad).all())
    for name in got:
        for i in range(2):
            assert got[name][i] <= 2 * plain[name][i], (name, got, plain)


def test_mha_draws_the_plain_paths_mask(cuda):
    """self_attention in training through the kernel and through the plain
    math, from one generator state: the generator ends in the same state
    (the same draws), and the outputs agree to the bf16 rounding of P."""
    from hdenseformer_tpu_torch.models.layers import self_attention
    from hdenseformer_tpu_torch.utils.profiling import tracing

    qkv = torch.randn(2, 216, 3 * 8 * 64, generator=torch.Generator(device=cuda).manual_seed(2),
                      device=cuda).to(torch.bfloat16)
    outs, states, counters = [], [], []
    for use in (True, False):
        g = torch.Generator(device=cuda).manual_seed(7)
        with tracing() as rec:
            outs.append(self_attention(qkv, 8, 0.1, True, g, use_kernels=use))
        states.append(g.get_state())
        counters.append(rec.counters)
    assert torch.equal(states[0], states[1])
    n_scores = 2 * 8 * 216 * 216
    assert counters[0] == {"attention.calls": 1, "attention.fused_calls": 1,
                           "dropout.drawn_elements": n_scores}
    assert counters[1] == {"attention.calls": 1, "attention.score_elements": n_scores,
                           "dropout.drawn_elements": n_scores}
    torch.testing.assert_close(outs[0].float(), outs[1].float(), rtol=2 ** -7, atol=2e-2)


def test_mha_backward_is_bitwise_deterministic(cuda):
    """Two forward and backward calls on the same inputs: the same bits (no
    atomics; the dQ and dK/dV passes each sum in a fixed order)."""
    from hdenseformer_tpu_torch.ops.mha import mha

    qkv, dout, keep = _mha_inputs(cuda, 2, 8, 1000, 0.1, True, seed=3)
    runs = [_out_and_grad(lambda x: mha(x, 8, keep, 0.1), qkv, dout) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_mha_captured_equals_eager(cuda):
    """Forward and backward captured as a CUDA graph and replayed on new
    inputs copied into the static ones: the eager call's bits."""
    from hdenseformer_tpu_torch.ops.mha import mha

    qkv, dout, keep = _mha_inputs(cuda, 2, 8, 216, 0.1, True, seed=4)
    static = [qkv.clone(), dout.clone()]

    def run():
        return _out_and_grad(lambda x: mha(x, 8, keep, 0.1), static[0], static[1])

    graph, outs = _capture(run)
    fresh, fresh_dout, _ = _mha_inputs(cuda, 2, 8, 216, 0.1, False, seed=5)
    static[0].copy_(fresh)
    static[1].copy_(fresh_dout)
    graph.replay()
    want = _out_and_grad(lambda x: mha(x, 8, keep, 0.1), fresh, fresh_dout)
    torch.cuda.synchronize()
    for got, ref in zip(outs, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["fp32", "width 32", "cpu", "misaligned", "keep shape",
                                  "keep dtype", "keep strided"])
def test_mha_wrapper_rejects_what_the_kernel_does_not_take(cuda, case):
    from hdenseformer_tpu_torch.ops.mha import mha

    qkv = torch.zeros(2, 16, 3 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    keep = torch.ones(2, 2, 16, 16, device=cuda, dtype=torch.bool)
    x, heads, k = {
        "fp32": (qkv.float(), 2, None),
        "width 32": (qkv, 4, None),
        "cpu": (qkv.cpu(), 2, None),
        "misaligned": (torch.zeros(2, 16, 3 * 128 + 1, device=cuda,
                                   dtype=torch.bfloat16)[..., 1:], 2, None),
        "keep shape": (qkv, 2, keep[:, :1]),
        "keep dtype": (qkv, 2, keep.to(torch.uint8)),
        "keep strided": (qkv, 2, keep.transpose(2, 3)),
    }[case]
    with pytest.raises(ValueError):
        mha(x, heads, k, 0.1)


def test_transbts_training_forward_takes_the_kernel(cuda):
    """A bf16 TransBTS training forward at 32^3 (64 tokens, 8 heads of 64):
    its 4 attention calls go through the kernel (``attention.fused_calls``
    4, no materialised scores), and it draws as many dropout elements as the
    plain build from the same generator, ending in the same state."""
    from hdenseformer_tpu_torch.models import get_net
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.ops.mha import mha
    from hdenseformer_tpu_torch.utils.profiling import tracing

    counters, states = {}, {}
    for use in (True, False):
        net = get_net("TransBTS", 2, 2, (32, 32, 32), dtype=torch.bfloat16, use_kernels=use,
                      device=cuda)
        init_weights(net, torch.Generator().manual_seed(0))
        net.train()
        x = torch.randn(2, 32, 32, 32, 2, generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
        g = torch.Generator(device=cuda).manual_seed(2)
        mha.launches = 0
        with tracing() as rec, torch.no_grad():
            net(x, generator=g)
        torch.cuda.synchronize()
        counters[use], states[use] = dict(rec.counters, launches=mha.launches), g.get_state()
    assert counters[True]["attention.fused_calls"] == counters[True]["launches"] == 4
    assert counters[True].get("attention.score_elements", 0) == 0
    assert counters[False]["launches"] == 0 and "attention.fused_calls" not in counters[False]
    assert counters[True]["dropout.drawn_elements"] == counters[False]["dropout.drawn_elements"]
    assert torch.equal(states[True], states[False])
