"""Hecktor20Top1, 3-D, forward (eval) only.

Counterpart of ``hdenseformer_tpu/models/hecktor20top1.py``: a 5-level UNet
of SE-normalized residual conv blocks (FastSmoothSENorm: InstanceNorm
without affine, scaled by a sigmoid and shifted by a tanh excitation of the
global mean), a k7 stem, ConvTranspose (k3, s2, p1, op1) decoder skips, and
three additive vision heads merged before the last block. Input
``(N, D, H, W, C)``, output one channels-last logits tensor
``(N, D, H, W, n_cls)`` in fp32. Module and parameter names are the JAX
ones, so ``weights.load_jax_params`` loads a JAX parameter tree.

``s2d`` packs level 1 (the full-resolution ``n_filters``-channel level)
into the space-to-depth layout of ``ops/s2d.py``, as JAX does: the k7 stem,
``block_1_2_left``, ``upconv_1``, the right blocks, the vision-head merge
and the 1x1 head run packed, and every k3/k7 conv there goes through the
half-shift (``ops/shift_pack.py``): 4 launches a forward. ``None`` applies
JAX's rule to ``image_size`` (pack when 3-D, even dims and ``n_filters`` <=
32); True and False force it. The packed and fine executions share one
parameter tree. The dict form that also packs level 2 raises.

Where JAX decides the packing at each call from the input's shape, the port
decides it once, from ``image_size``, when it builds the modules; a packed
model then takes inputs whose spatial dims are even.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hdenseformer_tpu_torch.models.layers import Conv, ConvTranspose, InstanceNorm
from hdenseformer_tpu_torch.ops.resize import max_pool, upsample_linear
from hdenseformer_tpu_torch.ops.s2d import (
    concat_packed,
    max_pool_packed,
    pack,
    unpack,
    upsample2x_packed,
)

LEVEL2_PACKING = "ROADMAP.md queue 1 item 4 (partial-rank s2d packing of level 2)"


class SEWeights(nn.Module):
    """Global mean -> 1x1 conv -> ReLU -> 1x1 conv (JAX ``SEWeights``).

    ``packed``: the input is packed-plain; the per-packed-channel means are
    averaged over the parity blocks, so the excitation sees the fine-grid
    mean. Returns the per-fine-channel excitation (N, 1, 1, 1, C).
    """

    def __init__(self, in_channels: int, reduction: int = 2,
                 dtype: Optional[torch.dtype] = None, packed: bool = False, device=None):
        super().__init__()
        self.in_channels, self.packed = in_channels, packed
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(in_channels, in_channels // reduction, 1, **kw)
        self.conv2 = Conv(in_channels // reduction, in_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(dim=tuple(range(1, x.dim() - 1)), keepdim=True)
        if self.packed:
            f = pooled.shape[-1] // self.in_channels
            pooled = pooled.view(pooled.shape[:-1] + (f, self.in_channels)).mean(dim=-2)
        return self.conv2(F.relu(self.conv1(pooled)))


class FastSmoothSENorm(nn.Module):
    """IN (no affine) * sigmoid(gamma(x)) + tanh(beta(x)). ``packed``: the
    norm pools each channel over (spatial, parity) and the gates tile over
    the parity blocks."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 dtype: Optional[torch.dtype] = None, packed: bool = False,
                 use_kernels: bool = True, device=None):
        super().__init__()
        self.packed = packed
        kw = dict(dtype=dtype, packed=packed, device=device)
        self.gamma = SEWeights(in_channels, reduction, **kw)
        self.beta = SEWeights(in_channels, reduction, **kw)
        self.norm = InstanceNorm(in_channels, affine=False, fuse_relu=False,
                                 use_kernels=use_kernels, packed=packed, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma = torch.sigmoid(self.gamma(x))
        beta = torch.tanh(self.beta(x))
        normed = self.norm(x)
        if self.packed:
            f = x.shape[-1] // gamma.shape[-1]
            gamma, beta = gamma.repeat(1, 1, 1, 1, f), beta.repeat(1, 1, 1, 1, f)
        return gamma * normed + beta


class FastSmoothSeNormConv(nn.Module):
    """conv -> ReLU -> FastSmoothSENorm; ``packed`` runs it all packed."""

    def __init__(self, in_channels: int, out_channels: int, reduction: int = 2,
                 kernel_size: int = 3, padding: int = 1,
                 dtype: Optional[torch.dtype] = None, packed: bool = False,
                 use_kernels: bool = True, device=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, 1, padding, dtype=dtype,
                         packed=packed, use_kernels=use_kernels, device=device)
        self.norm = FastSmoothSENorm(out_channels, reduction, dtype, packed=packed,
                                     use_kernels=use_kernels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.relu(self.conv(x)))


class RESseNormConv(nn.Module):
    """FastSmoothSeNormConv plus a residual, through a 1x1 FastSmoothSeNormConv
    (``res_conv``) when the widths differ."""

    def __init__(self, in_channels: int, out_channels: int, reduction: int = 2,
                 kernel_size: int = 3, padding: int = 1,
                 dtype: Optional[torch.dtype] = None, packed: bool = False,
                 use_kernels: bool = True, device=None):
        super().__init__()
        kw = dict(dtype=dtype, packed=packed, use_kernels=use_kernels, device=device)
        self.conv1 = FastSmoothSeNormConv(in_channels, out_channels, reduction, kernel_size,
                                          padding, **kw)
        self.res_conv = (
            FastSmoothSeNormConv(in_channels, out_channels, reduction, 1, 0, **kw)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.res_conv is None else self.res_conv(x)
        return self.conv1(x) + res


class VisionUp(nn.Module):
    """1x1 FastSmoothSeNormConv + trilinear upsample by ``scale``.

    ``packed_out`` emits the packed-plain layout of the upsampled grid:
    ``upsample2x_packed`` at scale 2, the fine upsample then ``pack`` at 4
    and 8.
    """

    def __init__(self, in_channels: int, out_channels: int, scale: int,
                 reduction: int = 2, dtype: Optional[torch.dtype] = None,
                 packed_out: bool = False, use_kernels: bool = True, device=None):
        super().__init__()
        self.scale, self.packed_out = scale, packed_out
        self.conv = FastSmoothSeNormConv(in_channels, out_channels, reduction, 1, 0, dtype,
                                         use_kernels=use_kernels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.packed_out:
            if self.scale == 2:
                return upsample2x_packed(x)
            return pack(upsample_linear(x, self.scale))
        return upsample_linear(x, self.scale)


def packs_level1(s2d, n_filters: int, image_size: Sequence[int]) -> bool:
    """JAX's level-1 packing rule (``Hecktor20Top1.__call__``) on ``image_size``."""
    if isinstance(s2d, dict):
        if s2d.get(2):
            raise NotImplementedError(f"s2d={s2d!r} packs level 2: {LEVEL2_PACKING}")
        return bool(s2d.get(1, False))
    if s2d is None:
        return (n_filters <= 32 and len(image_size) == 3
                and all(s % 2 == 0 for s in image_size))
    return bool(s2d)


class Hecktor20Top1(nn.Module):
    """The full model; returns one fp32 logits tensor (N, D, H, W, n_cls)."""

    def __init__(self, in_channels: int, n_cls: int, n_filters: int = 32,
                 image_size: Sequence[int] = (144, 144, 144), reduction: int = 2,
                 s2d=None, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        nf, r = n_filters, reduction
        image_size = tuple(image_size)
        if len(image_size) != 3:
            raise ValueError(f"the port's Hecktor20Top1 is 3-D, got image_size {image_size}")
        self.packed = pk = packs_level1(s2d, nf, image_size)
        kw = dict(dtype=dtype, use_kernels=use_kernels, device=device)

        def res(cin, cout, k=3, packed=False):
            return RESseNormConv(cin, cout, r, k, k // 2, packed=packed, **kw)

        def sen(cin, cout, packed=False):
            return FastSmoothSeNormConv(cin, cout, r, 3, 1, packed=packed, **kw)

        self.block_1_1_left = res(in_channels, nf, k=7, packed=pk)
        self.block_1_2_left = res(nf, nf, packed=pk)
        cin = nf
        for lvl, width in ((2, 2 * nf), (3, 4 * nf), (4, 8 * nf), (5, 16 * nf)):
            for i in range(1, 4):
                self.add_module(f"block_{lvl}_{i}_left", res(cin, width))
                cin = width
        up = dict(dtype=dtype, device=device)
        for lvl, width, scale in ((4, 8 * nf, 8), (3, 4 * nf, 4), (2, 2 * nf, 2)):
            self.add_module(f"upconv_{lvl}", ConvTranspose(2 * width, width, 3, 2, 1, 1, **up))
            self.add_module(f"block_{lvl}_1_right", sen(2 * width, width))
            self.add_module(f"block_{lvl}_2_right", sen(width, width))
            self.add_module(f"vision_{lvl}", VisionUp(width, nf, scale, r, packed_out=pk, **kw))
        self.upconv_1 = ConvTranspose(2 * nf, nf, 3, 2, 1, 1, packed_out=pk, **up)
        self.block_1_1_right = sen(2 * nf, nf, packed=pk)
        self.block_1_2_right = sen(nf, nf, packed=pk)
        self.conv1x1 = Conv(nf, n_cls, 1, packed=pk, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` is unused (the model has no dropout); it is taken so
        that every model of the zoo is called alike, as JAX applies each with
        ``rngs=``."""
        del generator
        if self.packed and any(s % 2 for s in x.shape[1:-1]):
            raise ValueError(
                f"this Hecktor20Top1 packs level 1 and takes even spatial dims, got "
                f"{tuple(x.shape)}; build it with s2d=False for odd dims"
            )
        if self.packed:
            ds0 = self.block_1_2_left(self.block_1_1_left(pack(x)))
            h = max_pool_packed(ds0)
        else:
            ds0 = self.block_1_2_left(self.block_1_1_left(x))
            h = max_pool(ds0)
        skips = []
        for lvl in (2, 3, 4, 5):
            if lvl > 2:
                h = max_pool(h)
            for i in range(1, 4):
                h = getattr(self, f"block_{lvl}_{i}_left")(h)
            skips.append(h)
        h = skips.pop()
        visions = []
        for lvl in (4, 3, 2):
            h = torch.cat([getattr(self, f"upconv_{lvl}")(h), skips.pop()], dim=-1)
            h = getattr(self, f"block_{lvl}_1_right")(h)
            h = getattr(self, f"block_{lvl}_2_right")(h)
            visions.append(getattr(self, f"vision_{lvl}")(h))
        sv4, sv3, sv2 = visions
        up1 = self.upconv_1(h)
        h = concat_packed([up1, ds0]) if self.packed else torch.cat([up1, ds0], dim=-1)
        h = self.block_1_1_right(h)
        h = self.block_1_2_right(h + sv4 + sv3 + sv2)
        logits = self.conv1x1(h.float())
        return unpack(logits) if self.packed else logits


def hecktertop1(in_channels, n_cls, image_size=(144, 144, 144), **kw):
    return Hecktor20Top1(in_channels, n_cls, 32, tuple(image_size), **kw)
