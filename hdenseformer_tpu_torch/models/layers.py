"""Building blocks of the port, fine grid, forward only.

Counterpart of ``hdenseformer_tpu/models/layers.py``. As there, every module
takes and returns channels-last ``(N, *spatial, C)`` tensors, keeps fp32
parameters, and computes in ``dtype`` (None: the input's dtype), with
normalization statistics in fp32.

Inside, ``x.movedim(-1, 1)`` is a free NCDHW view whose memory is
``torch.channels_last_3d``. Conv weights are cast into that memory format
too, so cuDNN's convolutions return it whatever their input, and the conv
output viewed back as ``(N, *spatial, C)`` is contiguous: the layout the
InstanceNorm kernel takes.

Parameters are created uninitialised, as flax modules hold none until
``init``: fill them with ``init_weights(model, generator)`` (torch's default
initialisation, drawn on the CPU so that a seed gives the same weights on
every device) or load them with ``weights.load_jax_params``.

The space-to-depth packed arguments run at full rank (``ops/s2d.py``):
``Conv(packed=True)`` for odd kernels and for k1, ``ConvTranspose(
packed_out=True)`` for k3 s2 p1 op1, and ``InstanceNorm(packed=True)``,
which is what Hecktor20Top1's level 1 runs. Not ported here: partial-rank
packing (``packed_dims`` naming fewer dims raises), the shift-free conv pair
(``packed_shift``/``shift``, HDenseFormer's packed level 0), the BatchNorm
variants, 1-D and 2-D convolutions and dilation (ROADMAP.md queue 1 items 3
and 4).
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

_CL = torch.channels_last_3d
EPS = 1e-5  # torch's InstanceNorm and LayerNorm default, as in the JAX modules


def _uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


class Conv(nn.Module):
    """Channels-last Conv3d with torch's (out, in, k, k, k) weight.

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
                 device=None):
        super().__init__()
        k = kernel_size
        if packed and (stride != 1 or k % 2 != 1 or padding != k // 2 or out_f32):
            raise ValueError(
                f"a packed conv is SAME and stride 1 with an odd kernel: got k{k}, "
                f"stride {stride}, padding {padding}, out_f32 {out_f32}"
            )
        self.stride, self.padding = stride, padding
        self.dtype, self.out_f32 = dtype, out_f32
        self.packed, self.packed_dims, self.use_kernels = packed, packed_dims, use_kernels
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k, k, device=device))
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
        w = self.weight.to(dt, memory_format=_CL)
        if self.out_f32:
            y = F.conv3d(x.float().movedim(-1, 1), w.float(), self.bias,
                         self.stride, self.padding)
        else:
            b = None if self.bias is None else self.bias.to(dt)
            y = F.conv3d(x.to(dt).movedim(-1, 1), w, b, self.stride, self.padding)
        return y.movedim(1, -1)


class ConvTranspose(nn.Module):
    """Channels-last ConvTranspose3d with torch's (in, out, k, k, k) weight.

    The JAX module stores the spatially flipped equivalent-conv kernel
    (k, k, k, in, out); ``weights.from_jax_params`` flips it back.
    ``packed_out=True`` (k3, s2, p1, op1 only) emits the s2d packed-plain
    layout of the upsampled grid (``ops.s2d.conv_transpose_packed``).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 dtype: Optional[torch.dtype] = None, packed_out: bool = False,
                 device=None):
        super().__init__()
        k = kernel_size
        if packed_out and (k, stride, padding, output_padding) != (3, 2, 1, 1):
            raise ValueError(
                "a packed-output ConvTranspose is k3 s2 p1 op1, got "
                f"k{k} s{stride} p{padding} op{output_padding}"
            )
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.dtype, self.packed_out = dtype, packed_out
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch's fan_in for a transposed conv: dim 1 times the receptive field
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if self.packed_out:
            return conv_transpose_packed(x, self.weight, self.bias, dt)
        w = self.weight.to(dt, memory_format=_CL)
        y = F.conv_transpose3d(x.to(dt).movedim(-1, 1), w, self.bias.to(dt), self.stride,
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
    """Conv3x3 (no bias) + InstanceNorm (affine) + ReLU (JAX ``BasicConv``)."""

    def __init__(self, in_features: int, features: int, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.conv = Conv(in_features, features, 3, 1, 1, use_bias=False, dtype=dtype,
                         device=device)
        self.norm = InstanceNorm(features, affine=True, fuse_relu=True,
                                 use_kernels=use_kernels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class UpConv(nn.Module):
    """Conv3x3 + InstanceNorm (no affine) + ReLU + trilinear upsample x2."""

    def __init__(self, in_features: int, features: int, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.conv = Conv(in_features, features, 3, 1, 1, use_bias=True,
                         dtype=dtype, device=device)
        self.norm = InstanceNorm(features, affine=False, fuse_relu=True,
                                 use_kernels=use_kernels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_linear(self.norm(self.conv(x)), 2)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """torch.nn.GELU default: the exact erf form."""
    return F.gelu(x)


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
