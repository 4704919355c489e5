"""H-DenseFormer, 2-D and 3-D.

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
- ``s2d`` is JAX's: the UNet levels of fewer than 128 channels may run
  space-to-depth packed (``ops/s2d.py``), each through the shift-free conv
  pair (the first ``BasicConv`` writes the half-shifted layout, its norm is
  the shifted InstanceNorm, the second reads it back), with ``up3`` and the
  level's transposed conv emitting the packed layout directly. None is
  JAX's default: in 3-D every level of at most 32 channels packs over
  (H, W) (level 0 of ``_32``, levels 0-1 of ``_16``), in 2-D at full rank;
  False keeps the fine grid; True, a tuple of levels or a dict {level:
  True | dims} choose as in JAX (``packed_levels``). Where JAX decides at
  each call from the input's shape, the port decides once, from
  ``image_size``; an input whose shape would pack otherwise raises. Block
  names, and so ``REMAT_BLOCKS`` and the weight bridge, are the same in
  either layout.
- Dropout (flax semantics, ``layers.dropout``) draws from an explicit
  ``torch.Generator`` passed to ``forward``; in training with p > 0 a
  missing generator raises. JAX splits its dropout key per modality path;
  here the paths draw one after the other from the one generator.
- Rematerialisation (``remat``, JAX's ``nn.remat`` choice of blocks) is
  ``torch.utils.checkpoint``, non-reentrant, per block. ``checkpoint``
  replays only the global RNG states, never an explicit generator, so
  ``remat_call`` saves the generator's state before a block's forward,
  sets it back for the recompute (the same dropout masks) and afterwards
  restores where the forward had left it. Inside a captured CUDA graph
  (``utils/graphs.py``) the recompute draws from a generator state
  registered with the graph instead (``RematGraphRng``).
"""
from __future__ import annotations

import contextlib
import contextvars
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
from hdenseformer_tpu_torch.ops.s2d import concat_packed, max_pool_packed, pack, unpack

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


def packed_levels(s2d, n_filters: int, spatial: Sequence[int], levels: int = 3) -> tuple:
    """JAX's ``lvl_dims`` for each of the first ``levels`` UNet levels at
    input shape ``spatial``: None (fine grid) or the tuple of packed dims.

    A level of 2^lvl * n_filters channels packs when it has fewer than 128
    and its fine grid is even on the packed dims. ``s2d`` None: in 3-D the
    levels of at most 32 channels over (H, W), in 2-D at full rank; a dict
    {level: True | dims}; a tuple or list of levels (full rank); else
    ``bool(s2d)`` for every level (full rank).
    """
    nsp = len(spatial)
    use = True if s2d is None else s2d
    out = []
    for lvl in range(levels):
        ch = 2 ** lvl * n_filters
        if isinstance(use, dict):
            spec = use.get(lvl, False)
        elif isinstance(use, (tuple, list)):
            spec = lvl in use
        elif s2d is None:
            spec = False if ch > 32 else ((1, 2) if nsp == 3 else True)
        else:
            spec = bool(use)
        if spec is False or ch >= 128:
            out.append(None)
            continue
        dims = tuple(range(nsp)) if spec is True else tuple(spec)
        fine = [s // 2 ** lvl for s in spatial]
        ok = all(fine[i] > 0 and fine[i] % 2 == 0 and spatial[i] % 2 ** lvl == 0
                 for i in dims)
        out.append(dims if ok else None)
    return tuple(out)


class RematGraphRng:
    """The dropout generator of ``remat_call`` in a step captured as a CUDA
    graph.

    While a stream captures, a generator's seed and offset are read on the
    card at replay, so the eager way of replaying a block's masks cannot run:
    ``get_state``, ``set_state`` and ``clone_state`` all raise under
    capture. Instead the k-th checkpointed call of the step recomputes from
    its own generator state, cloned from ``generator`` before the capture and
    registered with the graph (``capturing``); ``remat_call`` swaps it in for
    the recompute by ``graphsafe_set_state`` and swaps the generator's own
    state back after. Before each replay ``sync`` seeds every such state as
    ``generator`` is seeded and moves it to the offset the generator had at
    that call's start: the offsets are those of an eager run of the same step
    (``recording``, the warm-up), which draws the same sequence. The
    recompute so draws the forward's masks, as the eager step's does.
    """

    def __init__(self, generator: torch.Generator):
        if generator.device.type != "cuda":
            raise ValueError("a CUDA graph's dropout generator lives on the card")
        self.generator = generator
        self.offsets: list = []  # the generator's offset at each call's start, less the step's
        self.states: list = []  # one registered generator a call
        self.calls = 0
        self.mode: Optional[str] = None
        self._base = 0

    @contextlib.contextmanager
    def _active(self, mode: str):
        self.mode, self.calls = mode, 0
        token = _GRAPH_RNG.set(self)
        try:
            yield self
        finally:
            _GRAPH_RNG.reset(token)
            self.mode = None

    def recording(self):
        """Context of the eager run whose checkpointed calls it records."""
        self.offsets, self._base = [], self.generator.get_offset()
        return self._active("record")

    @contextlib.contextmanager
    def capturing(self, graph: torch.cuda.CUDAGraph):
        """Context of the capture into ``graph`` (entered before it begins):
        one state a recorded call, registered with ``graph``."""
        self.states = [self.generator.clone_state() for _ in self.offsets]
        for state in self.states:
            graph.register_generator_state(state)
        with self._active("capture"):
            yield self
            if self.calls != len(self.offsets):
                raise RuntimeError(f"the captured step made {self.calls} checkpointed calls "
                                   f"with the generator, its eager run {len(self.offsets)}")

    def sync(self) -> None:
        """Before a replay: each call's state at the generator's seed and at
        its offset plus that call's."""
        seed, base = self.generator.initial_seed(), self.generator.get_offset()
        for state, offset in zip(self.states, self.offsets):
            state.manual_seed(seed)
            state.set_offset(base + offset)


_GRAPH_RNG: contextvars.ContextVar = contextvars.ContextVar("remat_graph_rng", default=None)


def remat_call(fn, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args[, generator])`` under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward instead of stored.

    With a ``generator`` the recompute draws the forward's dropout masks:
    the generator is set back to its state at the forward's start for the
    recompute, and afterwards to where the forward had left it, so a remat
    and a plain step leave it in the same state. (Getting and setting a
    generator's state waits for nothing on the card.) The global RNG states
    are not saved (``preserve_rng_state=False``): the model draws from none.
    While the current stream captures a CUDA graph, the recompute draws from
    the state that the step's ``RematGraphRng`` registered for this call, and
    without one it raises.
    """
    if not torch.is_grad_enabled():
        return fn(*args) if generator is None else fn(*args, generator)
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    rng = _GRAPH_RNG.get()
    if rng is not None and rng.generator is not generator:
        rng = None
    capturing = generator.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if capturing:
        if rng is None or rng.mode != "capture" or rng.calls >= len(rng.states):
            raise RuntimeError("remat with a dropout generator under CUDA-graph capture needs "
                               "the step's RematGraphRng, recorded by an eager run of the step")
        replay_state = rng.states[rng.calls]
        rng.calls += 1
    else:
        if rng is not None and rng.mode == "record":
            rng.offsets.append(generator.get_offset() - rng._base)
        start = generator.get_state()
    ran = []

    def run(*inputs):
        if not ran:  # the forward
            ran.append(True)
            return fn(*inputs, generator)
        if capturing:
            resume = generator.graphsafe_get_state()
            generator.graphsafe_set_state(replay_state)
        else:
            resume = generator.get_state()
            generator.set_state(start)
        try:
            return fn(*inputs, generator)
        finally:  # also when checkpoint stops the recompute early
            if capturing:
                generator.graphsafe_set_state(resume)
            else:
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
    (``REMAT_BLOCKS``) whenever gradients are recorded. ``s2d`` packs the
    narrow levels as JAX's (see the module docstring); ``packed`` holds each
    level's packed dims or None.
    """

    def __init__(self, in_channels: int, n_cls: int, n_filters: int,
                 image_size: Sequence[int] = (144, 144, 144),
                 transformer_depth: int = 12, use_kernels: bool = True,
                 dropout: float = 0.5, remat=False, dtype: Optional[torch.dtype] = None,
                 s2d=None, device=None):
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
        self.s2d, self.n_filters = s2d, nf
        self.packed = pk = packed_levels(s2d, nf, image_size)
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
        self.up3 = UpConv(2 * nf, nf, packed_out=pk[0] is not None, packed_dims=pk[0], **blk)
        widths = {1: nf, 2: 2 * nf, 3: 4 * nf, 4: 8 * nf}

        def pair(side: str, lvl: int, cin: int, ch: int, dims) -> None:
            """The level's two BasicConvs: the shift-free pair where packed."""
            p = dict(packed=True, packed_dims=dims) if dims else {}
            self.add_module(f"block_{lvl}_1_{side}",
                            BasicConv(cin, ch, shift="out" if dims else None, **p, **blk))
            self.add_module(f"block_{lvl}_2_{side}",
                            BasicConv(ch, ch, shift="in" if dims else None, **p, **blk))

        cin = in_channels
        for lvl in (1, 2, 3, 4):
            pair("left", lvl, cin, widths[lvl], pk[lvl - 1] if lvl < 4 else None)
            cin = widths[lvl]
        self.head_d3 = Conv(8 * nf, n_cls, 1, out_f32=True, **kw)
        for lvl, head in ((3, "head_d2"), (2, "head_d1"), (1, "head")):
            ch, dims = widths[lvl], pk[lvl - 1]
            self.add_module(f"upconv_{lvl}", ConvTranspose(
                2 * ch, ch, 3, 2, 1, 1, packed_out=dims is not None, packed_dims=dims, **kw))
            pair("right", lvl, 2 * ch, ch, dims)
            if dims:  # conv1_packed: fp32 out, as the fine head's out_f32
                self.add_module(head, Conv(ch, n_cls, 1, packed=True, packed_dims=dims, **kw))
            else:
                self.add_module(head, Conv(ch, n_cls, 1, out_f32=True, **kw))
        self.eval()

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The block ``name`` on ``x``, checkpointed where ``remat`` says."""
        block = getattr(self, name)
        return remat_call(block, x) if name in self.remat_blocks else block(x)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> list[torch.Tensor]:
        pk = self.packed
        if packed_levels(self.s2d, self.n_filters, x.shape[1:-1]) != pk:
            raise ValueError(
                f"input {tuple(x.shape)} would pack the levels as "
                f"{packed_levels(self.s2d, self.n_filters, x.shape[1:-1])}, but this model was "
                f"built from its image_size to pack them as {pk}: build it at the input's "
                "spatial shape, or with s2d=False"
            )
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
        at3 = self._block("up3", at2)  # 1/1, packed where level 1 packs

        # a packed level runs packed from its input's pack to its max-pool, and
        # its skip stays packed for the decoder
        skips = []
        h = x
        for lvl, ats in ((1, at3), (2, at2), (3, at1)):
            dims = pk[lvl - 1]
            if dims:
                h = pack(h, dims)
                if lvl > 1:
                    ats = pack(ats, dims)
            d = self._block(f"block_{lvl}_1_left", h)
            d = self._block(f"block_{lvl}_2_left", d) + ats
            skips.append(d)
            h = max_pool_packed(d, dims) if dims else max_pool(d)
        y = self._block("block_4_2_left", self._block("block_4_1_left", h)) + attnout
        outs = [self.head_d3(y)]
        for lvl, head in ((3, "head_d2"), (2, "head_d1"), (1, "head")):
            dims = pk[lvl - 1]
            up = self._block(f"upconv_{lvl}", y)
            if dims:
                y = concat_packed([up, skips[lvl - 1]], dims)
            else:
                y = torch.cat([up, skips[lvl - 1]], dim=-1)
            y = self._block(f"block_{lvl}_1_right", y)
            y = self._block(f"block_{lvl}_2_right", y)
            out = getattr(self, head)(y)
            if dims:
                y, out = unpack(y, dims), unpack(out, dims)
            outs.append(out)
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
