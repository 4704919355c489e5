"""DAUNet: 3-D UNet with Depth-Attention / Squeeze-Excitation variants.

Counterpart of ``hdenseformer_tpu/models/daunet.py``: a 5-level UNet
(widths ``width``, per-level depth ``depths[k]``) of double convs with
BatchNorm, built by one of five builders:

- ``plain``: conv-BN-ReLU, conv-BN-ReLU (also the ``inc`` block of all);
- ``da``: ..., conv-BN -> DepthAttention -> ReLU;
- ``se``: ..., conv-BN -> SELayer -> ReLU;
- ``da_se``: ..., conv-BN -> DepthAttention -> SELayer -> ReLU;
- ``res_da_se``: ``da_se`` plus a residual (a 1x1 ``downsample`` conv
  where the widths differ) before the last ReLU.

Input ``(N, D, H, W, C)``, output channels-last fp32 logits. Module and
parameter names are the JAX ones (``weights.load_jax_params`` loads a JAX
tree, ``batch_stats`` included). As in JAX:

- the decoder upsamples by align-corners trilinear (JAX's ``bilinear``
  default, the only one its ``get_net`` builds), pads each spatial dim by
  its own difference from the skip (``diff // 2`` before, the rest after:
  the reference's evident intent, JAX's stated divergence) and
  concatenates ``[skip, up]``;
- BatchNorm returns fp32 (``layers.BatchNorm``), so the blocks' outputs
  are fp32 and each conv casts to ``dtype``;
- with ``dropout_flag``, dropout 0.5 before the fp32 1x1 head ``outc``,
  drawn from the ``generator`` given to ``forward``.

``s2d`` is JAX's: None packs level 0 (``inc`` and ``up4``, ``ops/s2d.py``,
full rank) where ``width[0] <= 32``, the builder is not residual and the
input's spatial dims are even, True forces it, False keeps the fine grid.
As in JAX the decision is taken at each call from the input's shape; the
modules and the state are the same in either layout. A packed
``DoubleConv`` runs the shift-free conv pair (``convk_packed_p2s``, the
packed BatchNorm over the shifted layout with its ReLU, ``conv3_packed_s2p``),
and its BatchNorms keep the input's dtype where the fine ones return fp32,
as JAX's packed path does. The max-pool's lowering (``pool_mode``) is an
XLA choice of the same function, not taken.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hdenseformer_tpu_torch.models.layers import BatchNorm, Conv, Dense, dropout
from hdenseformer_tpu_torch.ops.resize import max_pool, upsample_linear_align_corners
from hdenseformer_tpu_torch.ops.s2d import (
    _pdims,
    concat_packed,
    conv1_packed,
    conv3_packed_s2p,
    convk_packed_p2s,
    max_pool_packed,
    pack,
    unpack,
)


def _adaptive_avg_depth(y: torch.Tensor, target: int) -> torch.Tensor:
    """AdaptiveAvgPool over the D axis of (B, D, C) to ``target`` bins
    ``[floor(i d / t), ceil((i + 1) d / t))``."""
    if y.shape[1] == target:
        return y
    return F.adaptive_avg_pool1d(y.transpose(1, 2), target).transpose(1, 2)


class DepthAttention(nn.Module):
    """Depth-wise squeeze gating: the (H, W) mean pooled to ``depth`` bins,
    flattened in torch (C, D) order, a C*depth -> depth -> C*depth sigmoid
    MLP, the gate pooled back to the feature depth and applied per
    (depth, channel). ``packed_dims``: x is packed over those dims; the
    (H, W) mean pools their parity blocks too, and the gate is laid into
    the parity blocks by each block's D bit."""

    def __init__(self, channels: int, depth: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.depth = depth
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Dense(channels * depth, depth, **kw)
        self.fc2 = Dense(depth, channels * depth, **kw)

    def forward(self, x: torch.Tensor, packed_dims=None) -> torch.Tensor:
        b = x.shape[0]
        y = x.mean(dim=tuple(range(2, x.dim() - 1)))  # (B, D or coarse D, f*C)
        if packed_dims is None:
            d, c = x.shape[1], x.shape[-1]
        else:
            dims = _pdims(x.dim() - 2, packed_dims)
            npk, dc = len(dims), x.shape[1]
            c = x.shape[-1] // 2 ** npk
            d = dc * (2 if 0 in dims else 1)
            y = y.reshape((b, dc) + (2,) * npk + (c,))
            hw = tuple(2 + j for j, i in enumerate(dims) if i != 0)
            if hw:
                y = y.mean(dim=hw)
            y = y.reshape(b, d, c)  # the D bit, if packed, interleaves into D
        y = _adaptive_avg_depth(y, self.depth)
        y = y.transpose(1, 2).reshape(b, c * self.depth)
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        gate = _adaptive_avg_depth(y.reshape(b, c, self.depth).transpose(1, 2), d)
        if packed_dims is None:
            return x * gate[:, :, None, None, :]
        if 0 in dims:
            bit = npk - 1 - dims.index(0)
            gm = gate.reshape(b, dc, 2, c)
            blocks = [gm[:, :, (m >> bit) & 1] for m in range(2 ** npk)]
        else:
            blocks = [gate] * 2 ** npk
        return x * torch.cat(blocks, dim=-1)[:, :, None, None, :]


class SELayer(nn.Module):
    """Global squeeze-excitation: mean -> C/16 -> ReLU -> C -> sigmoid gate.
    ``packed_dims``: x is packed; the mean pools the parity blocks and the
    gate tiles over them."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Dense(channels, channels // reduction, **kw)
        self.fc2 = Dense(channels // reduction, channels, **kw)

    def forward(self, x: torch.Tensor, packed_dims=None) -> torch.Tensor:
        f = 1 if packed_dims is None else 2 ** len(_pdims(x.dim() - 2, packed_dims))
        c = x.shape[-1] // f
        y = x.mean(dim=tuple(range(1, x.dim() - 1)))
        if f > 1:
            y = y.reshape(-1, f, c).mean(1)
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        if f > 1:
            y = y.repeat(1, f)
        return x * y.reshape(y.shape[0], *([1] * (x.dim() - 2)), y.shape[-1])


class DoubleConv(nn.Module):
    """(conv-BN-ReLU) x2 with the builder's DA / SE / residual; fp32 out.

    ``forward(x, packed_dims)`` runs it packed-plain over those dims (JAX's
    ``packed=True``): conv1 writes the packed-shifted layout, bn1 (shifted,
    with its ReLU) zeroes the pad slots, conv2 reads it back, then bn2 and
    the gates, packed; the 1x1 ``downsample`` is ``conv1_packed``."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None, depth: Optional[int] = None,
                 use_da: bool = False, use_se: bool = False, residual: bool = False,
                 dtype: Optional[torch.dtype] = None, use_kernels: bool = True, device=None):
        super().__init__()
        mid = mid_channels or out_channels
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(in_channels, mid, 3, 1, 1, use_kernels=use_kernels, **kw)
        self.bn1 = BatchNorm(mid, device=device)
        self.conv2 = Conv(mid, out_channels, 3, 1, 1, use_kernels=use_kernels, **kw)
        self.bn2 = BatchNorm(out_channels, device=device)
        self.da = DepthAttention(out_channels, depth, **kw) if use_da else None
        self.se = SELayer(out_channels, **kw) if use_se else None
        self.residual = residual
        self.downsample = (Conv(in_channels, out_channels, 1, **kw)
                           if residual and in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, packed_dims=None) -> torch.Tensor:
        if packed_dims is not None:
            return self._packed(x, packed_dims)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.da is not None:
            h = self.da(h)
        if self.se is not None:
            h = self.se(h)
        if self.residual:
            h = h + (x if self.downsample is None else self.downsample(x))
        return F.relu(h)

    def _packed(self, x: torch.Tensor, dims) -> torch.Tensor:
        c1, c2 = self.conv1, self.conv2
        dt = c1.dtype or x.dtype
        h = convk_packed_p2s(x, c1.weight, c1.bias, dt, dims)
        h = self.bn1(h, packed_dims=dims, shifted=True, fuse_relu=True)
        h = conv3_packed_s2p(h, c2.weight, c2.bias, c2.dtype or h.dtype, dims)
        h = self.bn2(h, packed_dims=dims)
        if self.da is not None:
            h = self.da(h, dims)
        if self.se is not None:
            h = self.se(h, dims)
        if self.residual:
            ds = self.downsample
            h = h + (x if ds is None else conv1_packed(x, ds.weight, ds.bias, dims))
        return F.relu(h)


BUILDERS = {
    "plain": dict(use_da=False, use_se=False, residual=False),
    "da": dict(use_da=True, use_se=False, residual=False),
    "se": dict(use_da=False, use_se=True, residual=False),
    "da_se": dict(use_da=True, use_se=True, residual=False),
    "res_da_se": dict(use_da=True, use_se=True, residual=True),
}


class DAUNet(nn.Module):
    """The generic DA/SE UNet skeleton; ``forward`` returns fp32 logits.
    ``use_kernels`` reaches every conv, as ``get_net`` passes it to every
    model (no conv of this model runs a kernel wrapper today)."""

    def __init__(self, n_channels: int, n_classes: int = 2,
                 width: Sequence[int] = (32, 64, 128, 256, 512),
                 depths: Sequence[int] = (128, 64, 32, 16, 8), conv_builder: str = "da",
                 dropout_flag: bool = True, dtype: Optional[torch.dtype] = None,
                 s2d=None, use_kernels: bool = True, device=None):
        super().__init__()
        w, dp = tuple(width), tuple(depths)
        kw = BUILDERS[conv_builder]
        self.dropout_flag, self.s2d = dropout_flag, s2d
        self.auto_packs = w[0] <= 32 and not kw["residual"]
        common = dict(dtype=dtype, use_kernels=use_kernels, device=device)

        def block(cin, cout, depth, mid=None, builder=kw):
            return DoubleConv(cin, cout, mid, depth, **builder, **common)

        self.inc = block(n_channels, w[0], dp[0], builder=BUILDERS["plain"])
        self.down1 = block(w[0], w[1], dp[1])
        self.down2 = block(w[1], w[2], dp[2])
        self.down3 = block(w[2], w[3], dp[3])
        self.down4 = block(w[3], w[4] // 2, dp[4])
        small = w[4] // 2
        for name, skip, out, depth in (("up1", w[3], w[3] // 2, dp[3]),
                                       ("up2", w[2], w[2] // 2, dp[2]),
                                       ("up3", w[1], w[1] // 2, dp[1]),
                                       ("up4", w[0], w[0], dp[0])):
            cat = skip + small
            self.add_module(name, block(cat, out, depth, mid=cat // 2))
            small = out
        self.outc = Conv(w[0], n_classes, 1, device=device)

    def _up(self, name: str, x_small: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        u = upsample_linear_align_corners(x_small, 2)
        pads = []  # F.pad's order: the last dim first (C, then W, H, D)
        for i in range(u.dim() - 2, 0, -1):
            diff = skip.shape[i] - u.shape[i]
            pads += [diff // 2, diff - diff // 2]
        if any(pads):
            u = F.pad(u, [0, 0] + pads)
        return getattr(self, name)(torch.cat([skip, u.to(skip.dtype)], dim=-1))

    def packs(self, x: torch.Tensor) -> bool:
        """JAX's level-0 packing rule at x's shape."""
        if self.s2d is None:
            return self.auto_packs and x.dim() == 5 and all(s % 2 == 0 for s in x.shape[1:-1])
        return bool(self.s2d)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        full = (0, 1, 2) if self.packs(x) else None  # level 0's packed dims
        if full:
            x1 = self.inc(pack(x), full)
            h = max_pool_packed(x1)
        else:
            x1 = self.inc(x)
            h = max_pool(x1)
        x2 = self.down1(h)
        x3 = self.down2(max_pool(x2))
        x4 = self.down3(max_pool(x3))
        y = self.down4(max_pool(x4))
        for name, skip in (("up1", x4), ("up2", x3), ("up3", x2)):
            y = self._up(name, y, skip)
        if full:  # level 0's decoder in packed space: the skip never left it
            u = pack(upsample_linear_align_corners(y, 2))
            y = self.up4(concat_packed([x1, u]), full)
        else:
            y = self._up("up4", y, x1)
        if self.dropout_flag:
            y = dropout(y, 0.5, self.training, generator)
        if full:
            return unpack(conv1_packed(y.float(), self.outc.weight, self.outc.bias))
        return self.outc(y.float())


def _make(conv_builder: str, init_depth: int, n_channels: int, n_classes: int, dtype=None,
          **kw) -> DAUNet:
    depths = tuple(init_depth // (2 ** k) for k in range(5))
    return DAUNet(n_channels, n_classes, depths=depths, conv_builder=conv_builder,
                  dtype=dtype, **kw)


def da_unet(init_depth=128, n_channels=1, n_classes=2, dtype=None, **kw):
    return _make("da", init_depth, n_channels, n_classes, dtype, **kw)


def se_unet(init_depth=128, n_channels=1, n_classes=2, dtype=None, **kw):
    return _make("se", init_depth, n_channels, n_classes, dtype, **kw)


def da_se_unet(init_depth=128, n_channels=1, n_classes=2, dtype=None, **kw):
    return _make("da_se", init_depth, n_channels, n_classes, dtype, **kw)


def res_da_se_unet(init_depth=128, n_channels=1, n_classes=2, dtype=None, **kw):
    return _make("res_da_se", init_depth, n_channels, n_classes, dtype, **kw)
