"""UNETR: a ViT encoder with UNet-style decoder taps.

Counterpart of ``hdenseformer_tpu/models/unetr.py`` (a MONAI-style UNETR
written without monai):

- the patch embedding flattens each 16^3 cell in (p1, p2, p3, c) order,
  cells in row-major grid order, through the ``Dense`` ``patch_embed``,
  and adds ``pos_embed`` (tokens, hidden; trunc-normal 0.02 at init);
- ``num_layers`` pre-LN ``ViTBlock``s (bias-free ``qkv``, fp32 scores and
  softmax, exact GELU), then ``vit_norm``;
- skips from the outputs of layers 4, 7 and 10 (``hidden_states[3]``,
  ``[6]``, ``[9]``), each raised to its level by a ladder of bias-free
  ConvTranspose k2 s2 (``encoder{2,3,4}_up{j}``), and ``encoder1``, a
  ``UnetResBlock`` on the input;
- four ``decoder{5..2}`` stages: a bias-free ConvTranspose k2 s2
  (``_up``), the concatenation ``[up, skip]`` (the opposite of DAUNet's and
  TransBTS's order) and a ``UnetResBlock`` (``_res``); the fp32 1x1 head
  ``out``.

``UnetResBlock`` is conv (no bias) - InstanceNorm (affine, no ReLU) -
LeakyReLU 0.01, twice, plus a residual through a 1x1 ``conv3``/``norm3``
where the widths differ or the stride is not 1. Its norms go through
``layers.InstanceNorm``: the CUDA kernel on a CUDA tensor where
``use_kernels``, the plain version otherwise. At 144^3 a forward runs 15 of
them (each ``UnetResBlock`` here has its ``norm3``).

Input ``(N, D, H, W, C)`` with edges that are multiples of 16, output
channels-last fp32 logits. Module and parameter names are the JAX ones.
Dropout (``dropout_rate``, 0 in ``get_net``'s configuration) draws from the
``generator`` given to ``forward``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from hdenseformer_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    InstanceNorm,
    LayerNorm,
    dropout,
    gelu_exact,
    leaky_relu,
    self_attention,
)

PATCH = 16
TAPS = (3, 6, 9)  # hidden_states read by encoder2, encoder3, encoder4


class UnetResBlock(nn.Module):
    """conv-IN-LeakyReLU x2 with a 1x1 residual (monai's dynunet block)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dtype: Optional[torch.dtype] = None,
                 use_kernels: bool = True, device=None):
        super().__init__()
        k, p = kernel_size, kernel_size // 2
        conv = dict(use_bias=False, dtype=dtype, device=device)
        norm = dict(affine=True, fuse_relu=False, use_kernels=use_kernels, device=device)
        self.conv1 = Conv(in_channels, out_channels, k, stride, p, **conv)
        self.norm1 = InstanceNorm(out_channels, **norm)
        self.conv2 = Conv(out_channels, out_channels, k, 1, p, **conv)
        self.norm2 = InstanceNorm(out_channels, **norm)
        if in_channels != out_channels or stride != 1:
            self.conv3 = Conv(in_channels, out_channels, 1, stride, 0, **conv)
            self.norm3 = InstanceNorm(out_channels, **norm)
        else:
            self.conv3 = self.norm3 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm2(self.conv2(leaky_relu(self.norm1(self.conv1(x)))))
        res = x if self.conv3 is None else self.norm3(self.conv3(x))
        return leaky_relu(h + res)


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, heads: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, use_kernels: bool = True, device=None):
        super().__init__()
        self.heads, self.p, self.use_kernels = heads, dropout, use_kernels
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(hidden, device=device)
        self.qkv = Dense(hidden, 3 * hidden, use_bias=False, **kw)
        self.proj = Dense(hidden, hidden, **kw)
        self.norm2 = LayerNorm(hidden, device=device)
        self.fc1 = Dense(hidden, mlp_dim, **kw)
        self.fc2 = Dense(mlp_dim, hidden, **kw)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        p, train = self.p, self.training
        out = self.proj(self_attention(self.qkv(self.norm1(x)), self.heads,
                                       use_kernels=self.use_kernels))
        x = x + dropout(out, p, train, generator)
        h = dropout(gelu_exact(self.fc1(self.norm2(x))), p, train, generator)
        return x + dropout(self.fc2(h), p, train, generator)


class UNETR(nn.Module):
    """The full model; ``forward`` returns fp32 logits (N, D, H, W, out_channels)."""

    def __init__(self, in_channels: int, out_channels: int,
                 img_size: Sequence[int] = (96, 96, 96), feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12, dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, use_kernels: bool = True, device=None):
        super().__init__()
        if num_layers <= max(TAPS):
            raise ValueError(f"UNETR reads hidden_states{list(TAPS)}: num_layers "
                             f"{num_layers} is too few")
        fs, hid = feature_size, hidden_size
        self.grid = tuple(s // PATCH for s in img_size)
        self.num_layers, self.p = num_layers, dropout_rate
        kw = dict(dtype=dtype, device=device)
        res = dict(dtype=dtype, use_kernels=use_kernels, device=device)
        tokens = 1
        for g in self.grid:
            tokens *= g
        self.patch_embed = Dense(PATCH ** len(self.grid) * in_channels, hid, **kw)
        self.pos_embed = nn.Parameter(torch.empty(tokens, hid, device=device))
        for i in range(num_layers):
            self.add_module(f"vit_{i}", ViTBlock(hid, mlp_dim, num_heads, dropout_rate,
                                                 use_kernels=use_kernels, **kw))
        self.vit_norm = LayerNorm(hid, device=device)
        self.encoder1 = UnetResBlock(in_channels, fs, **res)
        for name, out, ladder in (("encoder2", 2 * fs, 2), ("encoder3", 4 * fs, 1),
                                  ("encoder4", 8 * fs, 0)):
            for j in range(ladder + 1):
                self.add_module(f"{name}_up{j}", ConvTranspose(hid if j == 0 else out, out, 2, 2,
                                                               use_bias=False, **kw))
        cin = hid
        for name, out in (("decoder5", 8 * fs), ("decoder4", 4 * fs), ("decoder3", 2 * fs),
                          ("decoder2", fs)):
            self.add_module(f"{name}_up", ConvTranspose(cin, out, 2, 2, use_bias=False, **kw))
            self.add_module(f"{name}_res", UnetResBlock(2 * out, out, **res))
            cin = out
        self.out = Conv(fs, out_channels, 1, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # truncated normal, std 0.02, cut at +-2 (flax's truncated_normal(0.02))
        with torch.no_grad():
            drawn = torch.empty(self.pos_embed.shape)
            nn.init.trunc_normal_(drawn, std=0.02, a=-0.04, b=0.04, generator=generator)
            self.pos_embed.copy_(drawn)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, g0 p, g1 p, g2 p, C) -> (N, g0 g1 g2, p^3 C), then ``patch_embed``."""
        b, nsp = x.shape[0], x.dim() - 2
        split = [b]
        for g in self.grid:
            split += [g, PATCH]
        h = x.reshape(split + [x.shape[-1]])
        perm = [0] + [1 + 2 * i for i in range(nsp)] + [2 + 2 * i for i in range(nsp)]
        h = h.permute(perm + [1 + 2 * nsp]).reshape(b, -1, PATCH ** nsp * x.shape[-1])
        return self.patch_embed(h)

    def _ladder(self, name: str, t: torch.Tensor, layers: int) -> torch.Tensor:
        for j in range(layers + 1):
            t = getattr(self, f"{name}_up{j}")(t)
        return t

    def _decoder(self, name: str, t: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = getattr(self, f"{name}_up")(t)
        return getattr(self, f"{name}_res")(torch.cat([up, skip.to(up.dtype)], dim=-1))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if tuple(s // PATCH for s in x.shape[1:-1]) != self.grid or any(
                s % PATCH for s in x.shape[1:-1]):
            raise ValueError(f"this UNETR takes {tuple(g * PATCH for g in self.grid)} "
                             f"inputs, got {tuple(x.shape)}")
        tokens = self._embed(x)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        tokens = dropout(tokens, self.p, self.training, generator)
        hidden_states = []
        for i in range(self.num_layers):
            tokens = getattr(self, f"vit_{i}")(tokens, generator)
            hidden_states.append(tokens)
        b, hid = x.shape[0], tokens.shape[-1]

        def grid(t):
            return t.reshape(b, *self.grid, hid)

        enc1 = self.encoder1(x)
        enc2 = self._ladder("encoder2", grid(hidden_states[TAPS[0]]), 2)
        enc3 = self._ladder("encoder3", grid(hidden_states[TAPS[1]]), 1)
        enc4 = self._ladder("encoder4", grid(hidden_states[TAPS[2]]), 0)
        y = self._decoder("decoder5", grid(self.vit_norm(tokens)), enc4)
        y = self._decoder("decoder4", y, enc3)
        y = self._decoder("decoder3", y, enc2)
        y = self._decoder("decoder2", y, enc1)
        return self.out(y.float())
