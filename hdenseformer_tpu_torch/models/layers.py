"""Building blocks of the port, fine grid.

Counterpart of ``hdenseformer_tpu/models/layers.py``. As there, every module
takes and returns channels-last ``(N, *spatial, C)`` tensors, keeps fp32
parameters, and computes in ``dtype`` (None: the input's dtype), with
normalization statistics in fp32.

Inside, ``x.movedim(-1, 1)`` is a free NCHW / NCDHW view whose memory is
``torch.channels_last`` / ``torch.channels_last_3d``. Conv weights are cast
into that memory format too, so cuDNN's convolutions return it whatever
their input, and the conv output viewed back as ``(N, *spatial, C)`` is
contiguous: the layout the InstanceNorm kernel takes. The convolutions are
2-D or 3-D by ``ndim`` (the spatial rank; 3 unless given), which sets the
weight's rank.

Parameters are created uninitialised, as flax modules hold none until
``init``: fill them with ``init_weights(model, generator)`` (torch's default
initialisation, drawn on the CPU so that a seed gives the same weights on
every device) or load them with ``weights.load_jax_params``.

The space-to-depth packed arguments run at full rank (``ops/s2d.py``):
``Conv(packed=True)`` for odd kernels and for k1, ``ConvTranspose(
packed_out=True)`` for k3 s2 p1 op1, and ``InstanceNorm(packed=True)``,
which is what Hecktor20Top1's level 1 runs. Not ported here: partial-rank
packing (``packed_dims`` naming fewer dims raises), the shift-free conv pair
(``packed_shift``/``shift``, HDenseFormer's packed level 0), the packed
BatchNorm and GroupNorm (ROADMAP.md queue 1 item 4), 1-D convolutions.

``BatchNorm`` and ``GroupNorm`` hold the parameters that JAX keeps one
module deeper, under ``BatchNorm_0`` and ``GroupNorm_0``;
``weights.from_jax_params`` drops that level.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hdenseformer_tpu_torch.ops.instance_norm import (
    instance_norm_relu,
    instance_norm_relu_ref,
)
from hdenseformer_tpu_torch.ops.resize import upsample_linear
from hdenseformer_tpu_torch.ops.s2d import conv1_packed, conv_transpose_packed, convk_packed

# the memory format of a conv weight of rank 4 / 5, channels last
_CL = {4: torch.channels_last, 5: torch.channels_last_3d}
_CONV = {4: F.conv2d, 5: F.conv3d}
_CONV_T = {4: F.conv_transpose2d, 5: F.conv_transpose3d}
EPS = 1e-5  # torch's norms' default, as in the JAX modules
MOMENTUM = 0.1  # torch's BatchNorm momentum (flax's 0.9)


def _uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


class Conv(nn.Module):
    """Channels-last Conv2d / Conv3d (``ndim``) with torch's (out, in, *k) weight.

    ``dilation`` is JAX ``Conv``'s (``rhs_dilation``): the dilated layers
    of the 2-D ResNet encoders and DeepLabV3+'s ASPP.

    The JAX patch embed (``as_matmul=True``) is this conv with kernel =
    stride = 16 and no padding: the same function. ``out_f32`` (the
    deep-supervision heads) computes in fp32 on the upcast activation with
    the weight rounded to ``dtype``, as the JAX heads multiply bf16 operands
    with fp32 accumulation; the logits are never rounded to bf16.

    ``packed=True`` takes and returns the s2d packed-plain layout (the same
    weight): an odd kernel with SAME padding runs ``ops.s2d.convk_packed``
    (the half-shift through the kernel wrapper, or its plain version when
    ``use_kernels`` is False), k1 runs ``conv1_packed``, which returns fp32
    as JAX's does.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, out_f32: bool = False,
                 packed: bool = False, packed_dims=None, use_kernels: bool = True,
                 dilation: int = 1, ndim: int = 3, device=None):
        super().__init__()
        k = kernel_size
        if packed and (stride != 1 or k % 2 != 1 or padding != k // 2 or out_f32
                       or dilation != 1 or ndim != 3):
            raise ValueError(
                f"a packed conv is 3-D, SAME and stride 1 with an odd, undilated kernel: got "
                f"k{k}, stride {stride}, padding {padding}, dilation {dilation}, ndim {ndim}, "
                f"out_f32 {out_f32}"
            )
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype, self.out_f32 = dtype, out_f32
        self.packed, self.packed_dims, self.use_kernels = packed, packed_dims, use_kernels
        self.weight = nn.Parameter(torch.empty(features, in_features, *(k,) * ndim,
                                               device=device))
        self.bias = (
            nn.Parameter(torch.empty(features, device=device)) if use_bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if self.packed:
            if self.weight.shape[-1] == 1:
                return conv1_packed(x, self.weight, self.bias, self.packed_dims)
            return convk_packed(x, self.weight, self.bias, dt, self.packed_dims,
                                self.use_kernels)
        w = self.weight.to(dt, memory_format=_CL[self.weight.dim()])
        conv = _CONV[self.weight.dim()]
        if self.out_f32:
            y = conv(x.float().movedim(-1, 1), w.float(), self.bias, self.stride, self.padding,
                     self.dilation)
        else:
            b = None if self.bias is None else self.bias.to(dt)
            y = conv(x.to(dt).movedim(-1, 1), w, b, self.stride, self.padding, self.dilation)
        return y.movedim(1, -1)


class ConvTranspose(nn.Module):
    """Channels-last ConvTranspose2d / 3d (``ndim``) with torch's (in, out, *k)
    weight.

    The JAX module stores the spatially flipped equivalent-conv kernel
    (*k, in, out); ``weights.from_jax_params`` flips it back.
    ``packed_out=True`` (k3, s2, p1, op1 only) emits the s2d packed-plain
    layout of the upsampled grid (``ops.s2d.conv_transpose_packed``).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 packed_out: bool = False, ndim: int = 3, device=None):
        super().__init__()
        k = kernel_size
        if packed_out and ((k, stride, padding, output_padding) != (3, 2, 1, 1) or ndim != 3):
            raise ValueError(
                "a packed-output ConvTranspose is 3-D, k3 s2 p1 op1, got "
                f"k{k} s{stride} p{padding} op{output_padding} ndim {ndim}"
            )
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.dtype, self.packed_out = dtype, packed_out
        self.weight = nn.Parameter(torch.empty(in_features, features, *(k,) * ndim,
                                               device=device))
        self.bias = (
            nn.Parameter(torch.empty(features, device=device)) if use_bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch's fan_in for a transposed conv: dim 1 times the receptive field
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if self.packed_out:
            return conv_transpose_packed(x, self.weight, self.bias, dt)
        w = self.weight.to(dt, memory_format=_CL[self.weight.dim()])
        b = None if self.bias is None else self.bias.to(dt)
        y = _CONV_T[self.weight.dim()](x.to(dt).movedim(-1, 1), w, b, self.stride,
                                       self.padding, self.output_padding)
        return y.movedim(1, -1)


class Dense(nn.Module):
    """``torch.nn.Linear`` over the last axis, computing in ``dtype``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, device=device))
        self.bias = (
            nn.Parameter(torch.empty(features, device=device)) if use_bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class InstanceNorm(nn.Module):
    """InstanceNorm over the spatial dims per (sample, channel), torch semantics.

    Batch statistics in eval as in train (no running stats), biased
    variance, fp32 statistics, optional affine and ReLU. ``use_kernels``
    selects the kernel wrapper (the CUDA kernel for a CUDA tensor) or the
    plain version.

    ``packed=True`` takes an s2d packed tensor (N, *g, f*features) and pools
    each channel's statistics over (spatial, parity): with parity-major
    channels that is the plain per-channel norm of the free view
    (N, g*f, features), so the same kernel runs on it.
    """

    def __init__(self, features: int, affine: bool = True, fuse_relu: bool = False,
                 use_kernels: bool = True, packed: bool = False, device=None):
        super().__init__()
        self.features = features
        self.fuse_relu, self.use_kernels, self.packed = fuse_relu, use_kernels, packed
        if affine:
            self.weight = nn.Parameter(torch.empty(features, device=device))
            self.bias = nn.Parameter(torch.empty(features, device=device))
        else:
            self.weight = self.bias = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = instance_norm_relu if self.use_kernels else instance_norm_relu_ref
        if self.packed:
            y = fn(x.reshape(x.shape[0], -1, self.features), self.weight, self.bias, EPS,
                   self.fuse_relu)
            return y.reshape(x.shape)
        return fn(x, self.weight, self.bias, EPS, self.fuse_relu)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the channels, torch's bookkeeping (JAX
    ``_TorchBatchNorm``).

    Training mode normalises with the batch's mean and biased variance and
    updates the running statistics with momentum 0.1, storing the unbiased
    variance (m / (m - 1) for m values a channel). Where a channel sees one
    value (m = 1, batch 1 at a 1^3 grid), torch's ``F.batch_norm`` raises;
    as JAX, the output is then the bias and the stored variance the biased
    one, 0. Eval mode normalises with the running statistics. Statistics,
    normalisation and the output are fp32 whatever the input's dtype; the
    next conv casts back. The state is the buffers ``mean`` and ``var``
    (initially 0 and 1), JAX's ``batch_stats`` leaves.
    """

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training and x.numel() == x.shape[-1]:  # m = 1
            with torch.no_grad():
                self.mean.mul_(1.0 - MOMENTUM).add_(MOMENTUM * x32.reshape(-1))
                self.var.mul_(1.0 - MOMENTUM)
            # x less its own mean: zero, and no gradient to x or the scale
            return (x32 - x32) * (self.weight * EPS ** -0.5) + self.bias
        y = F.batch_norm(x32.movedim(-1, 1), self.mean, self.var, self.weight, self.bias,
                         self.training, MOMENTUM, EPS)
        return y.movedim(1, -1)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups, dtype=float32)`` (TransBTS's
    GroupNorm(8)): consecutive channels form a group; fp32 statistics and an
    fp32 output; affine."""

    def __init__(self, features: int, num_groups: int = 8, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().movedim(-1, 1), self.num_groups, self.weight, self.bias,
                         EPS)
        return y.movedim(1, -1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, fp32 statistics."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, EPS)
        return y.to(x.dtype)


class BasicConv(nn.Module):
    """Conv3x3 (no bias) + InstanceNorm (affine) + ReLU (JAX ``BasicConv``),
    2-D or 3-D by ``ndim``."""

    def __init__(self, in_features: int, features: int, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, ndim: int = 3, device=None):
        super().__init__()
        self.conv = Conv(in_features, features, 3, 1, 1, use_bias=False, dtype=dtype,
                         ndim=ndim, device=device)
        self.norm = InstanceNorm(features, affine=True, fuse_relu=True,
                                 use_kernels=use_kernels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class UpConv(nn.Module):
    """Conv3x3 + InstanceNorm (no affine) + ReLU + bi/trilinear upsample x2."""

    def __init__(self, in_features: int, features: int, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, ndim: int = 3, device=None):
        super().__init__()
        self.conv = Conv(in_features, features, 3, 1, 1, use_bias=True,
                         dtype=dtype, ndim=ndim, device=device)
        self.norm = InstanceNorm(features, affine=False, fuse_relu=True,
                                 use_kernels=use_kernels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_linear(self.norm(self.conv(x)), 2)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """torch.nn.GELU default: the exact erf form."""
    return F.gelu(x)


def self_attention(qkv: torch.Tensor, heads: int, p: float = 0.0, training: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Multi-head attention of the (b, n, 3 c) output of a ``qkv`` projection,
    split as torch's ``reshape(b, n, 3, heads, c / heads)``, at JAX's
    precision (TransBTS's ``SelfAttention``, UNETR's ``ViTBlock``): scores
    and softmax in fp32 (the einsum's ``preferred_element_type``), dropout
    ``p`` on the probabilities, which are cast to v's dtype for P.V.
    Returns (b, n, c).

    Plain math, not ``F.scaled_dot_product_attention``: SDPA draws its
    dropout from the global RNG, where the port draws every mask from an
    explicit generator.
    """
    b, n = qkv.shape[:2]
    qkv = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = dropout(torch.softmax(scores * q.shape[-1] ** -0.5, dim=-1), p, training, generator)
    out = torch.matmul(probs.to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, n, -1)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with slope 0.01 (UNETR's, as monai's)."""
    return F.leaky_relu(x, 0.01)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p and scale
    it by 1 / (1 - p); zero the rest.

    The identity in eval and at p = 0. The keep mask is drawn from
    ``generator``, which lives on x's device: there is no hidden global RNG,
    so training with p > 0 and no generator raises. (``F.dropout`` takes no
    generator.)
    """
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` with torch's default initialisation.

    ``generator`` is a CPU generator: values are drawn on the CPU in module
    order and copied to each parameter's device.
    """
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model
