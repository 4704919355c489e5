"""H-DenseFormer, 2-D and 3-D, fine grid.

Counterpart of ``hdenseformer_tpu/models/hdenseformer.py``: each input
modality runs through its own densely connected transformer over 16^d-patch
tokens, whose upsampled maps are added into a 4-level UNet encoder, with a
ConvTranspose decoder and four deep-supervision heads. Input
``(N, *spatial, C_mod)`` with two or three spatial dims (the rank of
``image_size``), output the channels-last logits list ``[full, /2, /4,
/8]``, fp32. ``HDenseFormer_2D_32/_16`` are the same module at a 2-tuple
``image_size``, as in JAX.

Differences from the JAX module, none of which changes the function:

- The modality paths are a ``ModuleList`` of ``DenseTransformerBlock``s,
  run one after the other, where JAX runs one ``nn.vmap`` over stacked
  parameters; ``weights.from_jax_params`` splits the stacked axis.
- Every UNet level runs on the fine grid. JAX packs by default
  (space-to-depth, ``s2d=None``): in 3-D level 0 over (H, W), in 2-D every
  level of at most 32 channels at full rank (levels 0-1 of ``_16``, level
  0 of ``_32``). Its tests hold packed equal to fine in 3-D; the port's
  tests hold the fine grid against JAX's packed 2-D default too.
- Dropout (flax semantics, ``layers.dropout``) draws from an explicit
  ``torch.Generator`` passed to ``forward``; in training with p > 0 a
  missing generator raises. JAX splits its dropout key per modality path;
  here the paths draw one after the other from the one generator.
- Rematerialisation (``remat``, JAX's ``nn.remat`` choice of blocks) is
  ``torch.utils.checkpoint``, non-reentrant, per block. ``checkpoint``
  replays only the global RNG states, never an explicit generator, so
  ``remat_call`` saves the generator's state before a block's forward,
  sets it back for the recompute (the same dropout masks) and afterwards
  restores where the forward had left it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from hdenseformer_tpu_torch.models.layers import (
    BasicConv,
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm,
    UpConv,
    dropout,
    gelu_exact,
)
from hdenseformer_tpu_torch.ops.dense_attention import attention_ref, dense_attention
from hdenseformer_tpu_torch.ops.resize import max_pool, resize_nearest

PATCH = 16  # tokens are PATCH^d patches
GROWTH = 32  # width of the transformer's features
HEADS = 8  # attention heads, of width GROWTH / HEADS = 4
INNER_DEPTH = 4  # attention layers per dense block; transformer_depth counts them

_ENCODER = {f"block_{lvl}_{i}_left" for lvl in (1, 2, 3, 4) for i in (1, 2)}
_DECODER = {f"block_{lvl}_{i}_right" for lvl in (1, 2, 3) for i in (1, 2)}
_UP = {"deep_conv", "up1", "up2", "up3"}
_TRANSPOSED = {f"upconv_{lvl}" for lvl in (1, 2, 3)}
# JAX's remat values and the blocks each checkpoints (hdenseformer.py's
# nn.remat choices): "attns" is each modality's transformer path; "levels"
# takes the full- and half-resolution UNet levels, encoder and decoder
REMAT_BLOCKS = {
    True: frozenset(_ENCODER | _DECODER | _UP | _TRANSPOSED | {"attns"}),
    "encoder": frozenset(_ENCODER | _UP | {"attns"}),
    "levels": frozenset({f"block_{lvl}_{i}_{side}" for lvl in (1, 2) for i in (1, 2)
                         for side in ("left", "right")} | {"upconv_1", "upconv_2"}),
    False: frozenset(),
}


def remat_call(fn, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args[, generator])`` under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward instead of stored.

    With a ``generator`` the recompute draws the forward's dropout masks:
    the generator is set back to its state at the forward's start for the
    recompute, and afterwards to where the forward had left it, so a remat
    and a plain step leave it in the same state. (Getting and setting a
    generator's state waits for nothing on the card.) The global RNG states
    are not saved (``preserve_rng_state=False``): the model draws from none.
    """
    if not torch.is_grad_enabled():
        return fn(*args) if generator is None else fn(*args, generator)
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    start, ran = generator.get_state(), []

    def run(*inputs):
        if not ran:  # the forward
            ran.append(True)
            return fn(*inputs, generator)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*inputs, generator)
        finally:  # also when checkpoint stops the recompute early
            generator.set_state(resume)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class DenseForward(nn.Module):
    """Linear -> GELU -> Dropout -> Linear -> Dropout."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.p = dropout
        self.fc1 = Dense(in_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, out_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = dropout(gelu_exact(self.fc1(x)), self.p, self.training, generator)
        return dropout(self.fc2(x), self.p, self.training, generator)


class DenseAttention(nn.Module):
    """Multi-head self-attention at tiny width: ``dim`` = HEADS heads of dim / HEADS.

    ``use_kernels`` selects ``ops.dense_attention`` (the CUDA kernel for a
    CUDA tensor) or its plain version ``attention_ref``. Dropout follows
    ``to_out``.
    """

    def __init__(self, dim: int, use_kernels: bool = True, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.use_kernels, self.p = use_kernels, dropout
        self.to_qkv = Dense(dim, dim * 3, use_bias=False, dtype=dtype, device=device)
        self.to_out = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        b, n, dim = x.shape
        q, k, v = (
            t.view(b, n, HEADS, dim // HEADS).transpose(1, 2)
            for t in self.to_qkv(x).split(dim, dim=-1)
        )
        attend = dense_attention if self.use_kernels else attention_ref
        out = attend(q, k, v).to(q.dtype).transpose(1, 2).reshape(b, n, dim)
        return dropout(self.to_out(out), self.p, self.training, generator)


class DensePreConvAttentionBlock(nn.Module):
    """Densely connected attention block of INNER_DEPTH inner layers.

    Each inner layer squeezes the concatenated features to GROWTH channels,
    applies pre-normed attention and feed-forward with residuals, and
    appends the same pre-normed feed-forward applied once more to the
    updated stream (the reference does this, HDenseFormer.py:98).
    """

    def __init__(self, channels: int, use_kernels: bool = True, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        g = GROWTH
        kw = dict(dtype=dtype, device=device)
        for i in range(INNER_DEPTH):
            self.add_module(f"squeeze_{i}", Dense(channels + i * g, g, **kw))
            self.add_module(f"attn_norm_{i}", LayerNorm(g, device=device))
            self.add_module(f"attn_{i}", DenseAttention(g, use_kernels=use_kernels,
                                                        dropout=dropout, **kw))
            self.add_module(f"ff_norm_{i}", LayerNorm(g, device=device))
            self.add_module(f"ff_{i}", DenseForward(g, 2 * g, g, dropout, **kw))
        self.out_layer = DenseForward(channels + INNER_DEPTH * g, 2 * g, channels, dropout, **kw)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        features = [x]
        for i in range(INNER_DEPTH):
            ff, ff_norm = getattr(self, f"ff_{i}"), getattr(self, f"ff_norm_{i}")
            y = getattr(self, f"squeeze_{i}")(torch.cat(features, dim=-1))
            y = getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(y), generator) + y
            y = ff(ff_norm(y), generator) + y
            features.append(ff(ff_norm(y), generator))
        return self.out_layer(torch.cat(features, dim=-1), generator)


class DenseTransformerBlock(nn.Module):
    """PATCH^d patch embed + ``depth`` dense blocks + re-gridding of the tokens."""

    def __init__(self, out_channels: int, image_size: Sequence[int], depth: int,
                 use_kernels: bool = True, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.out_channels, self.p = out_channels, dropout
        self.grid = tuple(s // PATCH for s in image_size)
        num_patches = 1
        for g in self.grid:
            num_patches *= g
        self.patch_embed = Conv(1, out_channels, PATCH, PATCH, 0, dtype=dtype,
                                ndim=len(self.grid), device=device)
        self.pos_embed = nn.Parameter(torch.empty(num_patches, out_channels, device=device))
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", DensePreConvAttentionBlock(
                out_channels, use_kernels=use_kernels, dropout=dropout, dtype=dtype,
                device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.pos_embed)  # the JAX initialiser

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.patch_embed(x)
        b, actual_grid = x.shape[0], tuple(x.shape[1:-1])
        x = x.reshape(b, -1, self.out_channels)
        x = dropout(x + self.pos_embed.to(x.dtype)[None], self.p, self.training, generator)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, generator)
        x = x.reshape(b, *actual_grid, self.out_channels)
        if actual_grid != self.grid:
            x = resize_nearest(x, self.grid)
        return x


class HDenseFormer(nn.Module):
    """Hybrid densely connected transformer + UNet, 2-D or 3-D.

    Input ``(N, *spatial, in_channels)`` with ``len(image_size)`` spatial
    dims; output ``[(N, *spatial, n_cls), /2, /4, /8]`` logits in fp32.
    ``dropout`` is the transformer paths' rate
    (JAX's default, 0.5); in training, ``forward`` draws it from its
    ``generator``. The model is built in eval mode, as flax applies it with
    ``train=False`` unless asked: ``.train()`` turns dropout on. ``remat``
    in {True, "encoder", "levels", False} checkpoints JAX's blocks
    (``REMAT_BLOCKS``) whenever gradients are recorded.
    """

    def __init__(self, in_channels: int, n_cls: int, n_filters: int,
                 image_size: Sequence[int] = (144, 144, 144),
                 transformer_depth: int = 12, use_kernels: bool = True,
                 dropout: float = 0.5, remat=False, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        nf = n_filters
        image_size = tuple(image_size)
        if len(image_size) not in (2, 3):
            raise ValueError(f"HDenseFormer is 2-D or 3-D, got image_size {image_size}")
        nd = len(image_size)
        self.remat = remat if isinstance(remat, str) else bool(remat)
        if self.remat not in REMAT_BLOCKS:
            raise ValueError(f"remat must be one of {list(REMAT_BLOCKS)}, got {remat!r}")
        self.remat_blocks = REMAT_BLOCKS[self.remat]
        kw = dict(dtype=dtype, ndim=nd, device=device)
        blk = dict(use_kernels=use_kernels, **kw)
        self.attns = nn.ModuleList(
            DenseTransformerBlock(4 * nf, image_size, transformer_depth // INNER_DEPTH,
                                  use_kernels=use_kernels, dropout=dropout, dtype=dtype,
                                  device=device)
            for _ in range(in_channels)
        )
        self.deep_conv = UpConv(in_channels * 4 * nf, 8 * nf, **blk)
        self.up1 = UpConv(8 * nf, 4 * nf, **blk)
        self.up2 = UpConv(4 * nf, 2 * nf, **blk)
        self.up3 = UpConv(2 * nf, nf, **blk)
        widths = {1: nf, 2: 2 * nf, 3: 4 * nf, 4: 8 * nf}
        cin = in_channels
        for lvl in (1, 2, 3, 4):
            ch = widths[lvl]
            self.add_module(f"block_{lvl}_1_left", BasicConv(cin, ch, **blk))
            self.add_module(f"block_{lvl}_2_left", BasicConv(ch, ch, **blk))
            cin = ch
        self.head_d3 = Conv(8 * nf, n_cls, 1, out_f32=True, **kw)
        for lvl, head in ((3, "head_d2"), (2, "head_d1"), (1, "head")):
            ch = widths[lvl]
            self.add_module(f"upconv_{lvl}", ConvTranspose(2 * ch, ch, 3, 2, 1, 1, **kw))
            self.add_module(f"block_{lvl}_1_right", BasicConv(2 * ch, ch, **blk))
            self.add_module(f"block_{lvl}_2_right", BasicConv(ch, ch, **blk))
            self.add_module(head, Conv(ch, n_cls, 1, out_f32=True, **kw))
        self.eval()

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The block ``name`` on ``x``, checkpointed where ``remat`` says."""
        block = getattr(self, name)
        return remat_call(block, x) if name in self.remat_blocks else block(x)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> list[torch.Tensor]:
        # modality-major channels, as JAX's moveaxis + reshape of the vmap output
        paths = [x[..., m:m + 1] for m in range(len(self.attns))]
        if "attns" in self.remat_blocks:
            attnall = [remat_call(attn, xm, generator=generator)
                       for xm, attn in zip(paths, self.attns)]
        else:
            attnall = [attn(xm, generator) for xm, attn in zip(paths, self.attns)]
        attnout = self._block("deep_conv", torch.cat(attnall, dim=-1))  # 1/8
        at1 = self._block("up1", attnout)  # 1/4
        at2 = self._block("up2", at1)  # 1/2
        at3 = self._block("up3", at2)  # 1/1

        skips = []
        h = x
        for lvl, ats in ((1, at3), (2, at2), (3, at1)):
            d = self._block(f"block_{lvl}_1_left", h)
            d = self._block(f"block_{lvl}_2_left", d) + ats
            skips.append(d)
            h = max_pool(d)
        y = self._block("block_4_2_left", self._block("block_4_1_left", h)) + attnout
        outs = [self.head_d3(y)]
        for lvl, head in ((3, "head_d2"), (2, "head_d1"), (1, "head")):
            up = self._block(f"upconv_{lvl}", y)
            y = torch.cat([up, skips[lvl - 1]], dim=-1)
            y = self._block(f"block_{lvl}_1_right", y)
            y = self._block(f"block_{lvl}_2_right", y)
            outs.append(getattr(self, head)(y))
        return outs[::-1]


def HDenseFormer_32(in_channels, n_cls, image_size, transformer_depth, **kw):
    return HDenseFormer(in_channels, n_cls, 32, tuple(image_size), transformer_depth, **kw)


def HDenseFormer_16(in_channels, n_cls, image_size, transformer_depth, **kw):
    return HDenseFormer(in_channels, n_cls, 16, tuple(image_size), transformer_depth, **kw)


def _plane(image_size) -> tuple:
    """The ``image_size`` of a 2-D variant, which must have two dims."""
    if len(tuple(image_size)) != 2:
        raise ValueError(f"a 2-D HDenseFormer takes a 2-D image_size, got {image_size}")
    return tuple(image_size)


def HDenseFormer_2D_32(in_channels, n_cls, image_size, transformer_depth, **kw):
    return HDenseFormer_32(in_channels, n_cls, _plane(image_size), transformer_depth, **kw)


def HDenseFormer_2D_16(in_channels, n_cls, image_size, transformer_depth, **kw):
    return HDenseFormer_16(in_channels, n_cls, _plane(image_size), transformer_depth, **kw)
