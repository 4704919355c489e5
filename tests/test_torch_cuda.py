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
