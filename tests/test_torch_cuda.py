"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it runs where JAX is not installed; on the machine with
the card run it without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

fp32 comparisons turn TF32 off in cuDNN and cuBLAS, since a float32
convolution otherwise runs in TF32 on the card.
"""
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.ops.dense_attention import (  # noqa: E402
    attention_ref,
    dense_attention,
)
from hdenseformer_tpu_torch.ops.instance_norm import (  # noqa: E402
    instance_norm_relu,
    instance_norm_relu_ref,
)
from hdenseformer_tpu_torch.ops.shift_pack import (  # noqa: E402
    shift_pack,
    shift_pack_ref,
    shift_unpack,
    shift_unpack_ref,
)

pytestmark = pytest.mark.needs_cuda


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
