"""Building blocks of the port, on the fine grid and packed.

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

The space-to-depth packed arguments are JAX's (``ops/s2d.py``), in 2-D and
3-D, over ``packed_dims`` (None: every spatial dim): ``Conv(packed=True)``
for odd SAME kernels, k1 and stride-2 convs, with ``packed_shift`` "out" or
"in" for the shift-free pair; ``ConvTranspose(packed_out=True)`` for k3 s2
p1 op1 and k2 s2; ``InstanceNorm(packed=True[, shifted=True])``, and
``BatchNorm``/``GroupNorm`` called with ``packed_dims`` (and ``shifted``);
``BasicConv(packed=True, shift=...)`` and ``UpConv(packed_out=True)``. A
shifted norm follows a ``packed_shift="out"`` conv and zeroes its pad slots
for the ``"in"`` conv after it. Not ported: 1-D convolutions.

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
from hdenseformer_tpu_torch.ops.mha import applies as mha_applies
from hdenseformer_tpu_torch.ops.mha import apply_keep, attention_ref, mha
from hdenseformer_tpu_torch.ops.resize import upsample_linear
from hdenseformer_tpu_torch.ops.s2d import (
    _pdims,
    apply_shifted_mask,
    conv1_packed,
    conv3_packed_s2p,
    conv_s2_packed,
    conv_transpose2_packed,
    conv_transpose_packed,
    convk_packed,
    convk_packed_p2s,
    group_norm_relu_packed,
    shifted_count,
    upsample2x_packed,
)
from hdenseformer_tpu_torch.parallel.mesh import active_mesh, global_sum, sharded_draw
from hdenseformer_tpu_torch.utils.profiling import count

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

    ``packed=True`` takes the s2d packed-plain layout over ``packed_dims``
    (the same weight): an odd kernel with SAME padding runs
    ``ops.s2d.convk_packed`` (at full rank the half-shift through the kernel
    wrapper, or its plain version when ``use_kernels`` is False), k1 runs
    ``conv1_packed``, which returns fp32 as JAX's does, and stride 2 runs
    ``conv_s2_packed``, which returns the unpacked coarse grid.
    ``packed_shift`` selects the shift-free pair: "out" returns the
    packed-shifted layout (``convk_packed_p2s``; its pad slots, bias
    included, are garbage until a shifted norm zeroes them), "in" takes it
    (``conv3_packed_s2p``, k3).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, out_f32: bool = False,
                 packed: bool = False, packed_dims=None, use_kernels: bool = True,
                 dilation: int = 1, ndim: int = 3, packed_shift: Optional[str] = None,
                 device=None):
        super().__init__()
        k = kernel_size
        if packed and (stride not in (1, 2) or k % 2 != 1 or padding != k // 2 or out_f32
                       or dilation != 1 or ndim not in (2, 3)
                       or packed_shift not in (None, "out", "in")
                       or (packed_shift and (k < 3 or stride != 1))
                       or (packed_shift == "in" and k != 3)
                       or (stride == 2 and k == 1)):
            raise ValueError(
                "a packed conv is 2-D or 3-D and SAME with an odd, undilated kernel, stride 1 "
                "(shift 'out': k >= 3, 'in': k3) or 2 (k >= 3, no shift): got "
                f"k{k}, stride {stride}, padding {padding}, dilation {dilation}, ndim {ndim}, "
                f"out_f32 {out_f32}, packed_shift {packed_shift!r}"
            )
        if not packed and packed_shift is not None:
            raise ValueError("packed_shift needs packed=True")
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype, self.out_f32 = dtype, out_f32
        self.packed, self.packed_dims, self.use_kernels = packed, packed_dims, use_kernels
        self.packed_shift = packed_shift
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
            dims = self.packed_dims
            if self.stride == 2:
                return conv_s2_packed(x, self.weight, self.bias, dt, dims)
            if self.weight.shape[-1] == 1:
                return conv1_packed(x, self.weight, self.bias, dims)
            if self.packed_shift == "out":
                return convk_packed_p2s(x, self.weight, self.bias, dt, dims)
            if self.packed_shift == "in":
                return conv3_packed_s2p(x, self.weight, self.bias, dt, dims)
            return convk_packed(x, self.weight, self.bias, dt, dims, self.use_kernels)
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
    ``packed_out=True`` emits the s2d packed-plain layout of the upsampled
    grid over ``packed_dims``: k3 s2 p1 op1 through
    ``ops.s2d.conv_transpose_packed``, k2 s2 (full rank) through
    ``conv_transpose2_packed``.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 packed_out: bool = False, packed_dims=None, ndim: int = 3, device=None):
        super().__init__()
        k = kernel_size
        if packed_out and ((k, stride, padding, output_padding) not in ((3, 2, 1, 1), (2, 2, 0, 0))
                           or ndim not in (2, 3)
                           or (k == 2 and len(_pdims(ndim, packed_dims)) != ndim)):
            raise ValueError(
                "a packed-output ConvTranspose is 2-D or 3-D, k3 s2 p1 op1 or k2 s2 (full "
                f"rank), got k{k} s{stride} p{padding} op{output_padding} ndim {ndim} "
                f"packed_dims {packed_dims}"
            )
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.dtype, self.packed_out, self.packed_dims = dtype, packed_out, packed_dims
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
            up = conv_transpose2_packed if self.weight.shape[-1] == 2 else conv_transpose_packed
            return up(x, self.weight, self.bias, dt, self.packed_dims)
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

    ``packed=True`` takes an s2d packed tensor (N, *g, f*features) over
    ``packed_dims`` and pools each channel's statistics over (spatial,
    parity): with parity-major channels that is the plain per-channel norm of
    the free view (N, g*f, features), so the same kernel runs on it.
    ``shifted=True`` takes the packed-shifted output of a ``packed_shift=
    "out"`` conv: the kernel's shifted mode leaves the pad slots out of the
    statistics and writes 0 there.
    """

    def __init__(self, features: int, affine: bool = True, fuse_relu: bool = False,
                 use_kernels: bool = True, packed: bool = False, packed_dims=None,
                 shifted: bool = False, device=None):
        super().__init__()
        if shifted and not packed:
            raise ValueError("a shifted InstanceNorm is packed")
        self.features = features
        self.fuse_relu, self.use_kernels, self.packed = fuse_relu, use_kernels, packed
        self.packed_dims, self.shifted = packed_dims, shifted
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
        if self.shifted:
            dims = _pdims(x.dim() - 2, self.packed_dims)
            return fn(x, self.weight, self.bias, EPS, self.fuse_relu, shifted=dims)
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

    ``forward(x, packed_dims=...)`` takes an s2d packed x over those dims
    (JAX ``_PackedBatchNorm``, plain torch): the statistics of each channel
    pool over (batch, space, parity blocks), with ``shifted`` less the pad
    slots of a packed-shifted x (zero in the output), ``fuse_relu`` applies
    the ReLU, and the output keeps x's dtype, as JAX's packed path does. The
    running statistics follow the same bookkeeping from the pooled set, so
    one state serves both layouts.

    Under a data-parallel mesh (``parallel/mesh.py``) the training
    statistics are those of the global batch, as JAX's BatchNorm reduces
    over the whole sharded batch: the fine path all-reduces each channel's
    (sum, sum of squares) and takes JAX's E[x^2] - E[x]^2, the packed path
    all-reduces its two sums; the count is the world size times the
    rank's. The running statistics stay the same on every rank.
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

    def forward(self, x: torch.Tensor, packed_dims=None, shifted: bool = False,
                fuse_relu: bool = False) -> torch.Tensor:
        if packed_dims is not None:
            return self._packed(x, packed_dims, shifted, fuse_relu)
        x32 = x.float()
        if self.training and active_mesh() is not None:
            return self._global(x32)
        if self.training and x.numel() == x.shape[-1]:  # m = 1
            with torch.no_grad():
                self.mean.mul_(1.0 - MOMENTUM).add_(MOMENTUM * x32.reshape(-1))
                self.var.mul_(1.0 - MOMENTUM)
            # x less its own mean: zero, and no gradient to x or the scale
            return (x32 - x32) * (self.weight * EPS ** -0.5) + self.bias
        y = F.batch_norm(x32.movedim(-1, 1), self.mean, self.var, self.weight, self.bias,
                         self.training, MOMENTUM, EPS)
        return y.movedim(1, -1)

    def _global(self, x32: torch.Tensor) -> torch.Tensor:
        """Training mode over the mesh's global batch (fine grid)."""
        axes = tuple(range(x32.dim() - 1))
        m = active_mesh().world_size * (x32.numel() // x32.shape[-1])
        sums = global_sum(torch.stack([x32.sum(axes), x32.square().sum(axes)]))
        mean = sums[0] / m
        var = sums[1] / m - mean.square()
        with torch.no_grad():
            self.mean.mul_(1.0 - MOMENTUM).add_(MOMENTUM * mean)
            self.var.mul_(1.0 - MOMENTUM).add_(MOMENTUM * var * (m / (m - 1) if m > 1 else 1.0))
        return (x32 - mean) * (torch.rsqrt(var + EPS) * self.weight) + self.bias

    def _packed(self, x: torch.Tensor, dims, shifted: bool, relu: bool) -> torch.Tensor:
        nsp = x.dim() - 2
        pd = _pdims(nsp, dims)
        f = 2 ** len(pd)
        c = x.shape[-1] // f

        mesh = active_mesh()

        def per_channel(v):  # (.., f*C) summed over batch, space and parity -> (C,)
            v = apply_shifted_mask(v, pd) if shifted else v
            return global_sum(v.sum(tuple(range(x.dim() - 1))).reshape(f, c).sum(0))

        x32 = x.float()
        if self.training:
            m = x.shape[0] * (shifted_count(x.shape[1:-1], pd) if shifted
                              else f * math.prod(x.shape[1:-1]))
            if mesh is not None:
                m *= mesh.world_size
            mean = per_channel(x32) / m
            d = x32 - mean.repeat(f)
            var = per_channel(d.square()) / m
            y = d * torch.rsqrt(var + EPS).repeat(f) * self.weight.repeat(f) + self.bias.repeat(f)
            with torch.no_grad():
                self.mean.mul_(1.0 - MOMENTUM).add_(MOMENTUM * mean)
                self.var.mul_(1.0 - MOMENTUM).add_(MOMENTUM * var * (m / (m - 1)))
        else:
            inv = torch.rsqrt(self.var + EPS)
            g = (inv * self.weight).repeat(f)
            y = x32 * g + (self.bias - self.mean * inv * self.weight).repeat(f)
        if relu:
            y = torch.clamp_min(y, 0.0)
        if shifted:
            y = apply_shifted_mask(y, pd)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups, dtype=float32)`` (TransBTS's
    GroupNorm(8)): consecutive channels form a group; fp32 statistics and an
    fp32 output; affine.

    ``forward(x, packed_dims=...)`` takes an s2d packed x (JAX
    ``_PackedGroupNorm``: ``s2d.group_norm_relu_packed``, the groups pooled
    over the parity blocks, with ``shifted`` less the pad slots), with
    ``fuse_relu`` the ReLU, and returns x's dtype, as JAX's packed path."""

    def __init__(self, features: int, num_groups: int = 8, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, packed_dims=None, shifted: bool = False,
                fuse_relu: bool = False) -> torch.Tensor:
        if packed_dims is not None:
            return group_norm_relu_packed(x, self.weight, self.bias, self.num_groups, EPS,
                                          fuse_relu, packed_dims, shifted)
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
    2-D or 3-D by ``ndim``.

    ``packed``: packed-plain over ``packed_dims``; ``shift`` "out" returns
    the packed-shifted layout (its norm is the shifted one), "in" takes it:
    chained, the two run two fine SAME convs with no shift copy.
    """

    def __init__(self, in_features: int, features: int, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, ndim: int = 3, packed: bool = False,
                 packed_dims=None, shift: Optional[str] = None, device=None):
        super().__init__()
        self.conv = Conv(in_features, features, 3, 1, 1, use_bias=False, dtype=dtype,
                         packed=packed, packed_dims=packed_dims, use_kernels=use_kernels,
                         ndim=ndim, packed_shift=shift, device=device)
        self.norm = InstanceNorm(features, affine=True, fuse_relu=True,
                                 use_kernels=use_kernels, packed=packed,
                                 packed_dims=packed_dims, shifted=shift == "out", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class UpConv(nn.Module):
    """Conv3x3 + InstanceNorm (no affine) + ReLU + bi/trilinear upsample x2.

    ``packed_out`` emits the upsampled grid packed-plain over ``packed_dims``
    (``ops.s2d.upsample2x_packed``)."""

    def __init__(self, in_features: int, features: int, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, ndim: int = 3, packed_out: bool = False,
                 packed_dims=None, device=None):
        super().__init__()
        self.packed_out, self.packed_dims = packed_out, packed_dims
        self.conv = Conv(in_features, features, 3, 1, 1, use_bias=True,
                         dtype=dtype, ndim=ndim, device=device)
        self.norm = InstanceNorm(features, affine=False, fuse_relu=True,
                                 use_kernels=use_kernels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv(x))
        if self.packed_out:
            return upsample2x_packed(y, self.packed_dims)
        return upsample_linear(y, 2)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """torch.nn.GELU default: the exact erf form."""
    return F.gelu(x)


def self_attention(qkv: torch.Tensor, heads: int, p: float = 0.0, training: bool = False,
                   generator: Optional[torch.Generator] = None,
                   use_kernels: bool = True) -> torch.Tensor:
    """Multi-head attention of the (b, n, 3 c) output of a ``qkv`` projection,
    split as torch's ``reshape(b, n, 3, heads, c / heads)``, at JAX's
    precision (TransBTS's ``SelfAttention``, UNETR's ``ViTBlock``): scores
    and softmax in fp32 (the einsum's ``preferred_element_type``), dropout
    ``p`` on the probabilities, which are cast to v's dtype for P.V.
    Returns (b, n, c).

    With ``use_kernels``, a bf16 qkv on CUDA with heads of 64 goes through
    the hand-written kernel ``ops.mha.mha``, which keeps the n x n tiles on
    chip; everything else (the CPU, other widths, fp32) runs the plain math
    ``ops.mha.attention_ref``. Both take their dropout from one keep mask
    that ``dropout_keep`` draws, as ``dropout`` would, from ``generator``:
    there is no hidden global RNG (``F.scaled_dot_product_attention`` draws
    from one). Counters (``utils.profiling``): ``attention.calls``,
    ``attention.fused_calls`` (the calls the kernel took) and
    ``attention.score_elements``, the b * heads * n^2 scores that the plain
    math materialises in fp32.
    """
    b, n = qkv.shape[:2]
    count("attention.calls")
    keep = None
    if training and p > 0.0:
        keep = dropout_keep((b, heads, n, n), p, qkv.device, generator)
    if use_kernels and mha_applies(qkv.device.type, qkv.dtype, qkv.shape[-1] // (3 * heads)):
        count("attention.fused_calls")
        return mha(qkv, heads, keep, p)
    count("attention.score_elements", b * heads * n * n)
    return attention_ref(qkv, heads, keep, p)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with slope 0.01 (UNETR's, as monai's)."""
    return F.leaky_relu(x, 0.01)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p and scale
    it by 1 / (1 - p); zero the rest.

    The identity in eval and at p = 0; otherwise the keep mask is
    ``dropout_keep``'s draw.
    """
    if not training or p == 0.0:
        return x
    return apply_keep(x, dropout_keep(x.shape, p, x.device, generator), p)


def dropout_keep(shape, p: float, device, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """The keep mask of dropout ``p`` over a tensor of ``shape`` on
    ``device``: ``torch.rand(shape, generator=generator) >= p``.

    ``generator`` lives on ``device``: there is no hidden global RNG, so a
    draw without one raises. (``F.dropout`` takes no generator.) Dim 0 is
    the batch: under a data-parallel mesh a rank keeps its rows of the
    global batch's mask (``sharded_draw``). The counter
    ``dropout.drawn_elements`` adds the elements of the mask (the rank's
    rows under a mesh).
    """
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    shape = tuple(shape)
    count("dropout.drawn_elements", math.prod(shape))
    return sharded_draw(lambda s: torch.rand(s, generator=generator, device=device), shape) >= p


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
