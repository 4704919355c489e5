"""TransBTS: a 3-D UNet encoder, a transformer bottleneck, a conv decoder.

Counterpart of ``hdenseformer_tpu/models/transbts.py``:

- the encoder (``UnetEncoder``, module ``Unet``): ``InitConv``, channel
  dropout 0.2, GroupNorm(8)-ReLU-conv residual ``EnBlock``s and stride-2
  ``EnDown`` convs to the 1/8 grid at 128 channels;
- the bottleneck: BatchNorm, ReLU, a 3x3 conv to ``embedding_dim``, the grid
  flattened to tokens, a learned position embedding (zeros at init),
  dropout, and ``num_layers`` pre-LN transformer layers (bias-free ``qkv``,
  fp32 scores and softmax, exact GELU; dropout on the probabilities and at
  four more sites a layer);
- the decoder reads the last layer's output before any LayerNorm: two
  conv-BN-ReLU ``Enblock8`` pairs (the second residual), three ``DeUp``s
  (1x1 conv, ConvTranspose k2 s2 with bias, ``[skip, up]``, 1x1 conv), each
  followed by a residual conv-BN-ReLU ``DeBlock``, and the fp32 1x1
  ``endconv``.

Input ``(N, D, H, W, C)``, output channels-last fp32 logits. Module and
parameter names are the JAX ones. GroupNorm and BatchNorm return fp32
(``layers.GroupNorm``, ``layers.BatchNorm``), and each conv casts back to
``dtype``, as JAX's fine path does.

Dropout draws from the ``generator`` given to ``forward``. The encoder's
channel dropout is split into a draw (``UnetEncoder.channel_keep``: one
keep coin per (sample, channel)) and its application, so that a caller can
replay a mask drawn elsewhere.

``img_dim`` is the input's edge (an int) or its spatial shape: the position
embedding has a row per token of the 1/8 grid, which the port fixes when
it builds the model (JAX sizes it from the input at ``init``).

``s2d`` is JAX's: levels 0 and 1 (16 and 32 channels) may run
space-to-depth packed (``ops/s2d.py``). None packs both at full rank where
their grids are even, False keeps the fine grid, True forces full rank, and
a dict {level: True | dims} chooses the rank per level. Where JAX decides at
each call from the input's shape, the port decides once, from ``img_dim``
(``packed``), and raises on an input that would pack otherwise. A packed
level runs its GroupNorm-ReLU-conv chain packed (the shift-free pair inside
each ``EnBlock``, the packed GroupNorm of ``layers.GroupNorm``, which keeps
the input's dtype), its ``EnDown`` reads packed-plain and writes the next
level's fine grid (``s2d.conv_s2_packed``), and its skip stays packed. A
full-rank packed level's ``DeUp`` emits the packed layout from the k2
transposed conv (one matmul), its 1x1 convs run packed (fp32 out, as JAX's
``conv1_packed``), and its ``DeBlock`` is the shift-free pair with packed
BatchNorms; a partial-rank skip is unpacked for a fine decoder. The token
grid is the input's 1/8 by construction (JAX's ``patch_dim`` of 8).

Spans (``utils.profiling``, host work, recorded on an eager call and at a
CUDA graph's capture): ``transbts.encoder``, ``transbts.transformer`` (BN,
``conv_x``, the tokens and the layers) and ``transbts.decoder``. The
attention and dropout counters are ``layers.self_attention``'s and
``layers.dropout``'s; the channel coin adds its draws to
``dropout.drawn_elements``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hdenseformer_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dense,
    GroupNorm,
    LayerNorm,
    dropout,
    gelu_exact,
    self_attention,
)
from hdenseformer_tpu_torch.ops.s2d import concat_packed, pack, unpack
from hdenseformer_tpu_torch.parallel.mesh import sharded_draw
from hdenseformer_tpu_torch.utils.profiling import count, span

CHANNEL_DROPOUT = 0.2  # the encoder's, fixed where TransBTSModel builds it, as in JAX


def packed_levels(s2d, spatial) -> tuple:
    """JAX's ``TransBTSModel._lvl_dims`` of levels 0 and 1 at input shape
    ``spatial``: None (fine grid) or the tuple of packed dims each."""
    nsp = len(spatial)
    use = True if s2d is None else s2d
    out = []
    for lvl in (0, 1):
        if isinstance(use, dict):
            spec = use.get(lvl, False)
        elif isinstance(use, (tuple, list)):
            spec = lvl in use
        else:
            spec = bool(use)
        if spec is False:
            out.append(None)
            continue
        dims = tuple(range(nsp)) if spec is True else tuple(spec)
        fine = [s // 2 ** lvl for s in spatial]
        ok = all(fine[i] > 0 and fine[i] % 2 == 0 and spatial[i] % 2 ** lvl == 0
                 for i in dims)
        out.append(dims if ok else None)
    return tuple(out)


class EnBlock(nn.Module):
    """GN-ReLU-conv x2 plus the input; packed-plain over ``packed_dims``
    where given, the convs the shift-free pair."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None, packed_dims=None,
                 use_kernels: bool = True, device=None):
        super().__init__()
        self.dims = packed_dims
        p = dict(packed=True, packed_dims=packed_dims) if packed_dims else {}
        kw = dict(dtype=dtype, use_kernels=use_kernels, device=device)
        self.bn1 = GroupNorm(channels, device=device)
        self.conv1 = Conv(channels, channels, 3, 1, 1, packed_shift="out" if p else None,
                          **p, **kw)
        self.bn2 = GroupNorm(channels, device=device)
        self.conv2 = Conv(channels, channels, 3, 1, 1, packed_shift="in" if p else None,
                          **p, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dims:
            h = self.conv1(self.bn1(x, packed_dims=self.dims, fuse_relu=True))
            h = self.bn2(h, packed_dims=self.dims, shifted=True, fuse_relu=True)
            return self.conv2(h) + x
        h = self.conv1(F.relu(self.bn1(x)))
        return self.conv2(F.relu(self.bn2(h))) + x


class UnetEncoder(nn.Module):
    """The 4-level encoder to the 1/8 grid; returns the three skips and the
    bottom feature map. ``pk`` holds levels 0 and 1's packed dims or None;
    a packed level's skip is returned packed. ``use_kernels`` False runs
    the packed ``InitConv``'s half-shift as its plain version."""

    def __init__(self, in_channels: int, base_channels: int = 16,
                 dropout: float = CHANNEL_DROPOUT, dtype: Optional[torch.dtype] = None,
                 pk: tuple = (None, None), use_kernels: bool = True, device=None):
        super().__init__()
        bc, self.p, self.pk = base_channels, dropout, tuple(pk)
        kw = dict(dtype=dtype, use_kernels=use_kernels, device=device)
        p0, p1 = (dict(packed=True, packed_dims=d) if d else {} for d in self.pk)
        self.InitConv = Conv(in_channels, bc, 3, 1, 1, **p0, **kw)
        self.EnBlock1 = EnBlock(bc, packed_dims=self.pk[0], **kw)
        self.EnDown1 = Conv(bc, 2 * bc, 3, 2, 1, **p0, **kw)
        self.EnBlock2_1 = EnBlock(2 * bc, packed_dims=self.pk[1], **kw)
        self.EnBlock2_2 = EnBlock(2 * bc, packed_dims=self.pk[1], **kw)
        self.EnDown2 = Conv(2 * bc, 4 * bc, 3, 2, 1, **p1, **kw)
        self.EnBlock3_1 = EnBlock(4 * bc, **kw)
        self.EnBlock3_2 = EnBlock(4 * bc, **kw)
        self.EnDown3 = Conv(4 * bc, 8 * bc, 3, 2, 1, **kw)
        for i in range(1, 5):
            self.add_module(f"EnBlock4_{i}", EnBlock(8 * bc, **kw))

    def channel_keep(self, x: torch.Tensor, generator: Optional[torch.Generator]
                     ) -> torch.Tensor:
        """The draw of the channel dropout: a (N, 1, 1, 1, C) keep mask of the
        C = base_channels channels, each coin kept with probability 1 - p,
        from ``generator`` (on x's device)."""
        if generator is None:
            raise ValueError("dropout in training needs an explicit torch.Generator")
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (self.InitConv.weight.shape[0],)
        count("dropout.drawn_elements", shape[0] * shape[-1])
        return sharded_draw(lambda s: torch.rand(s, generator=generator, device=x.device),
                            shape) >= self.p

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        pk0, pk1 = self.pk
        x = self.InitConv(pack(x, pk0) if pk0 else x)
        if self.training and self.p > 0:
            keep = self.channel_keep(x, generator)
            if pk0:  # one coin a channel, over its parity blocks
                keep = keep.repeat((1,) * (x.dim() - 1) + (x.shape[-1] // keep.shape[-1],))
            x = torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
        x1_1 = self.EnBlock1(x)
        h = self.EnDown1(x1_1)  # the fine grid of level 1
        h = self.EnBlock2_1(pack(h, pk1) if pk1 else h)
        x2_1 = self.EnBlock2_2(h)
        h = self.EnBlock3_1(self.EnDown2(x2_1))
        x3_1 = self.EnBlock3_2(h)
        h = self.EnDown3(x3_1)
        for i in range(1, 5):
            h = getattr(self, f"EnBlock4_{i}")(h)
        return x1_1, x2_1, x3_1, h


class SelfAttention(nn.Module):
    """Multi-head self-attention (``layers.self_attention``) with dropout on
    the probabilities and on the projected output."""

    def __init__(self, dim: int, heads: int = 8, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, use_kernels: bool = True, device=None):
        super().__init__()
        self.heads, self.p, self.use_kernels = heads, dropout, use_kernels
        kw = dict(dtype=dtype, device=device)
        self.qkv = Dense(dim, 3 * dim, use_bias=False, **kw)
        self.proj = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        out = self_attention(self.qkv(x), self.heads, self.p, self.training, generator,
                             self.use_kernels)
        return dropout(self.proj(out), self.p, self.training, generator)


def _grid(size: int) -> int:
    """The edge after three k3 s2 p1 convs: ceil(size / 2), thrice."""
    for _ in range(3):
        size = -(-size // 2)
    return size


class TransBTSModel(nn.Module):
    """The full model; ``forward`` returns fp32 logits (N, D, H, W, classes)."""

    def __init__(self, n_channels: int = 2, num_classes: int = 2, img_dim=144,
                 embedding_dim: int = 512, num_heads: int = 8, num_layers: int = 4,
                 hidden_dim: int = 4096, dropout_rate: float = 0.1,
                 attn_dropout_rate: float = 0.1, dtype: Optional[torch.dtype] = None,
                 s2d=None, use_kernels: bool = True, device=None):
        super().__init__()
        ed = embedding_dim
        dims = (img_dim,) * 3 if isinstance(img_dim, int) else tuple(img_dim)
        self.num_layers, self.p, self.s2d = num_layers, dropout_rate, s2d
        self.packed = pk = packed_levels(s2d, dims)
        # the DeUp's k2 transposed conv packs at full rank only
        self.packed_up = pk_up = tuple(d if d and len(d) == len(dims) else None for d in pk)
        kw = dict(dtype=dtype, device=device)
        self.Unet = UnetEncoder(n_channels, 16, CHANNEL_DROPOUT, pk=pk,
                                use_kernels=use_kernels, **kw)
        self.bn = BatchNorm(128, device=device)
        self.conv_x = Conv(128, ed, 3, 1, 1, **kw)
        tokens = 1
        for d in dims:
            tokens *= _grid(d)
        self.position_embeddings = nn.Parameter(torch.empty(tokens, ed, device=device))
        for i in range(num_layers):
            self.add_module(f"attn_norm_{i}", LayerNorm(ed, device=device))
            self.add_module(f"attn_{i}", SelfAttention(ed, num_heads, attn_dropout_rate,
                                                       use_kernels=use_kernels, **kw))
            self.add_module(f"ff_norm_{i}", LayerNorm(ed, device=device))
            self.add_module(f"ff_fc1_{i}", Dense(ed, hidden_dim, **kw))
            self.add_module(f"ff_fc2_{i}", Dense(hidden_dim, ed, **kw))
        q = ed // 4
        for name, cin in (("Enblock8_1_conv1", ed), ("Enblock8_1_conv2", q),
                          ("Enblock8_2_conv1", q), ("Enblock8_2_conv2", q)):
            self.add_module(name, Conv(cin, q, 3, 1, 1, **kw))
            self.add_module(name.replace("conv", "bn"), BatchNorm(q, device=device))
        cin = q
        for lvl, out, skip, up in ((4, ed // 8, 64, None), (3, ed // 16, 32, pk_up[1]),
                                   (2, ed // 32, 16, pk_up[0])):
            p = dict(packed=True, packed_dims=up) if up else {}
            self.add_module(f"DeUp{lvl}_conv1", Conv(cin, out, 1, **kw))
            self.add_module(f"DeUp{lvl}_conv2", ConvTranspose(
                out, out, 2, 2, packed_out=bool(up), packed_dims=up, **kw))
            self.add_module(f"DeUp{lvl}_conv3", Conv(skip + out, out, 1, **p, **kw))
            for j, shift in ((1, "out"), (2, "in")):
                self.add_module(f"DeBlock{lvl}_conv{j}", Conv(
                    out, out, 3, 1, 1, packed_shift=shift if up else None, **p, **kw))
                self.add_module(f"DeBlock{lvl}_bn{j}", BatchNorm(out, device=device))
            cin = out
        self.endconv = Conv(cin, num_classes, 1, **(
            dict(packed=True, packed_dims=pk_up[0]) if pk_up[0] else {}), device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.position_embeddings)

    def _pair(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``{name}conv1`` - ``bn1`` - ReLU - ``conv2`` - ``bn2`` - ReLU."""
        for j in (1, 2):
            x = F.relu(getattr(self, f"{name}bn{j}")(getattr(self, f"{name}conv{j}")(x)))
        return x

    def _deup(self, lvl: int, h: torch.Tensor, skip: torch.Tensor, dims=None) -> torch.Tensor:
        """``DeUp{lvl}``, then the residual ``DeBlock{lvl}``; packed over
        ``dims`` where the level's decoder is."""
        h = getattr(self, f"DeUp{lvl}_conv2")(getattr(self, f"DeUp{lvl}_conv1")(h))
        if dims:
            h = getattr(self, f"DeUp{lvl}_conv3")(concat_packed([skip, h], dims))
            h1 = getattr(self, f"DeBlock{lvl}_conv1")(h)
            h1 = getattr(self, f"DeBlock{lvl}_bn1")(h1, packed_dims=dims, shifted=True,
                                                    fuse_relu=True)
            h1 = getattr(self, f"DeBlock{lvl}_conv2")(h1)
            return getattr(self, f"DeBlock{lvl}_bn2")(h1, packed_dims=dims, fuse_relu=True) + h
        h = getattr(self, f"DeUp{lvl}_conv3")(torch.cat([skip, h.to(skip.dtype)], dim=-1))
        return self._pair(f"DeBlock{lvl}_", h) + h

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        pk = self.packed
        if packed_levels(self.s2d, x.shape[1:-1]) != pk:
            raise ValueError(
                f"input {tuple(x.shape)} would pack levels 0-1 as "
                f"{packed_levels(self.s2d, x.shape[1:-1])}, but this model was built from its "
                f"img_dim to pack them as {pk}: build it at the input's shape, or with s2d=False"
            )
        with span("transbts.encoder"):
            x1_1, x2_1, x3_1, h = self.Unet(x, generator)
        with span("transbts.transformer"):
            tokens, grid = self._transformer(h, generator)
        with span("transbts.decoder"):
            return self._decoder(tokens, grid, x1_1, x2_1, x3_1)

    def _transformer(self, h: torch.Tensor, generator) -> tuple:
        """The bottleneck: BN, ReLU, ``conv_x``, the tokens and the layers;
        returns the last layer's output, before any LayerNorm, and the grid."""
        train, p = self.training, self.p
        h = self.conv_x(F.relu(self.bn(h)))
        b, grid, ed = h.shape[0], h.shape[1:-1], h.shape[-1]
        tokens = h.reshape(b, -1, ed) + self.position_embeddings.to(h.dtype)
        tokens = dropout(tokens, p, train, generator)
        for i in range(self.num_layers):
            a = getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(tokens), generator)
            tokens = tokens + dropout(a, p, train, generator)
            f = getattr(self, f"ff_fc1_{i}")(getattr(self, f"ff_norm_{i}")(tokens))
            f = getattr(self, f"ff_fc2_{i}")(dropout(gelu_exact(f), p, train, generator))
            tokens = tokens + dropout(f, p, train, generator)
        return tokens, grid

    def _decoder(self, tokens: torch.Tensor, grid, x1_1, x2_1, x3_1) -> torch.Tensor:
        """The ``Enblock8`` pairs, the three ``DeUp``/``DeBlock`` levels on
        the encoder's skips, and ``endconv``: the fp32 logits."""
        pk, pk_up = self.packed, self.packed_up
        y = tokens.reshape(tokens.shape[0], *grid, tokens.shape[-1])
        y = self._pair("Enblock8_1_", y)
        y = self._pair("Enblock8_2_", y) + y
        y = self._deup(4, y, x3_1)
        if pk[1] and not pk_up[1]:
            x2_1 = unpack(x2_1, pk[1])  # a partial-rank skip: the decoder reads it fine
        y = self._deup(3, y, x2_1, pk_up[1])
        if pk_up[1]:
            y = unpack(y, pk_up[1])  # DeUp2's transposed conv reads the fine grid
        if pk[0] and not pk_up[0]:
            x1_1 = unpack(x1_1, pk[0])
        y = self._deup(2, y, x1_1, pk_up[0])
        if pk_up[0]:
            return unpack(self.endconv(y.float()), pk_up[0])
        return self.endconv(y.float())


def TransBTS(n_channels=2, num_classes=2, img_dim=144, dtype=None, s2d=None,
             use_kernels=True, device=None):
    """The factory of the JAX package's signature, ``use_kernels`` and
    ``device``."""
    return TransBTSModel(n_channels=n_channels, num_classes=num_classes, img_dim=img_dim,
                         dtype=dtype, s2d=s2d, use_kernels=use_kernels, device=device)
