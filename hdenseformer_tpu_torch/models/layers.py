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

Not ported here: the space-to-depth packed arguments (``packed``,
``packed_dims``, ``shift``, ``packed_out``), the BatchNorm variants, 1-D and
2-D convolutions and dilation, all off the HDenseFormer 3-D serving path.
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
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, out_f32: bool = False,
                 device=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.dtype, self.out_f32 = dtype, out_f32
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
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch's fan_in for a transposed conv: dim 1 times the receptive field
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
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
    """

    def __init__(self, features: int, affine: bool = True, fuse_relu: bool = False,
                 use_kernels: bool = True, device=None):
        super().__init__()
        self.fuse_relu, self.use_kernels = fuse_relu, use_kernels
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
