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

The port runs the fine grid at every level. JAX's default (``s2d=None``)
packs level 0 where ``width[0] <= 32``, the builder is not residual and
the dims are even; its tests hold packed equal to fine in fp32, and in
bf16 its packed BatchNorm keeps the input dtype where the fine one
returns fp32. The packed path waits for the packed BatchNorm (ROADMAP.md
queue 1 item 4). The max-pool's lowering
(``pool_mode``) is an XLA choice of the same function, not taken.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hdenseformer_tpu_torch.models.layers import BatchNorm, Conv, Dense, dropout
from hdenseformer_tpu_torch.ops.resize import max_pool, upsample_linear_align_corners


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
    (depth, channel)."""

    def __init__(self, channels: int, depth: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.depth = depth
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Dense(channels * depth, depth, **kw)
        self.fc2 = Dense(depth, channels * depth, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, c = x.shape[0], x.shape[1], x.shape[-1]
        y = _adaptive_avg_depth(x.mean(dim=tuple(range(2, x.dim() - 1))), self.depth)
        y = y.transpose(1, 2).reshape(b, c * self.depth)
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        gate = _adaptive_avg_depth(y.reshape(b, c, self.depth).transpose(1, 2), d)
        return x * gate[:, :, None, None, :]


class SELayer(nn.Module):
    """Global squeeze-excitation: mean -> C/16 -> ReLU -> C -> sigmoid gate."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Dense(channels, channels // reduction, **kw)
        self.fc2 = Dense(channels // reduction, channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=tuple(range(1, x.dim() - 1)))
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y.reshape(y.shape[0], *([1] * (x.dim() - 2)), y.shape[-1])


class DoubleConv(nn.Module):
    """(conv-BN-ReLU) x2 with the builder's DA / SE / residual; fp32 out."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None, depth: Optional[int] = None,
                 use_da: bool = False, use_se: bool = False, residual: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        mid = mid_channels or out_channels
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(in_channels, mid, 3, 1, 1, **kw)
        self.bn1 = BatchNorm(mid, device=device)
        self.conv2 = Conv(mid, out_channels, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(out_channels, device=device)
        self.da = DepthAttention(out_channels, depth, **kw) if use_da else None
        self.se = SELayer(out_channels, **kw) if use_se else None
        self.residual = residual
        self.downsample = (Conv(in_channels, out_channels, 1, **kw)
                           if residual and in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.da is not None:
            h = self.da(h)
        if self.se is not None:
            h = self.se(h)
        if self.residual:
            h = h + (x if self.downsample is None else self.downsample(x))
        return F.relu(h)


BUILDERS = {
    "plain": dict(use_da=False, use_se=False, residual=False),
    "da": dict(use_da=True, use_se=False, residual=False),
    "se": dict(use_da=False, use_se=True, residual=False),
    "da_se": dict(use_da=True, use_se=True, residual=False),
    "res_da_se": dict(use_da=True, use_se=True, residual=True),
}


class DAUNet(nn.Module):
    """The generic DA/SE UNet skeleton; ``forward`` returns fp32 logits."""

    def __init__(self, n_channels: int, n_classes: int = 2,
                 width: Sequence[int] = (32, 64, 128, 256, 512),
                 depths: Sequence[int] = (128, 64, 32, 16, 8), conv_builder: str = "da",
                 dropout_flag: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        w, dp = tuple(width), tuple(depths)
        kw = BUILDERS[conv_builder]
        self.dropout_flag = dropout_flag
        common = dict(dtype=dtype, device=device)

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

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(max_pool(x1))
        x3 = self.down2(max_pool(x2))
        x4 = self.down3(max_pool(x3))
        y = self.down4(max_pool(x4))
        for name, skip in (("up1", x4), ("up2", x3), ("up3", x2), ("up4", x1)):
            y = self._up(name, y, skip)
        if self.dropout_flag:
            y = dropout(y, 0.5, self.training, generator)
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
