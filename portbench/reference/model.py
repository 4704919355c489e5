"""HDenseFormer_32 and HDenseFormer_2D_32 in plain PyTorch: the benchmark's
reference forward.

A frozen, independent statement of the architecture (shijun18/H-DenseFormer,
``HDenseFormer.py``) at the fine grid: every modality runs through its own
densely connected transformer over 16^d-patch tokens; the token maps feed an
upsampling pyramid that is added into a 4-level UNet encoder; a transposed
conv decoder ends in four deep-supervision heads. Input ``(N, *spatial,
C_mod)`` channels-last, output the fp32 logits ``[full, /2, /4, /8]``.

Parameter names and shapes are those of the system under test, so that one
state dict, made by ``portbench.weights``, loads into both. Dropout (p 0.5
in the transformer paths) keeps an element where ``torch.rand(shape,
generator) >= p``, drawn in forward order from the one generator it is
given: modality by modality, the token embedding, then in each inner layer
the attention's output, the feed-forward's two and the repeated
feed-forward's two, then the block's output layer's two.

``precision`` quantises the operands of every convolution and matrix
product: "fp32" (none; TF32 must be off, which ``portbench.reference``
sets), "bf16", or "fp8" (float8_e4m3fn with one scale a tensor, from its
largest magnitude). The product accumulates in fp32 and the gradient passes
the rounding unchanged. Everything else runs in fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

PATCH, GROWTH, HEADS, INNER_DEPTH = 16, 32, 8, 4
EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8_e4m3fn


class _RoundTrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        if precision == "bf16":
            return x.to(torch.bfloat16).float()
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def quantise(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision not in ("bf16", "fp8"):
        raise ValueError(f"precision {precision!r}: fp32, bf16 or fp8")
    return _RoundTrip.apply(x, precision)


class _Op(nn.Module):
    precision = "fp32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return quantise(x, self.precision)


def _cl(x: torch.Tensor) -> torch.Tensor:  # (N, *s, C) -> (N, C, *s)
    return x.movedim(-1, 1)


def _lc(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


class Conv(_Op):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, nd: int = 3):
        super().__init__()
        self.stride, self.padding, self.nd = stride, padding, nd
        self.weight = nn.Parameter(torch.empty(cout, cin, *(k,) * nd))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        conv = F.conv3d if self.nd == 3 else F.conv2d
        return _lc(conv(_cl(self.q(x)), self.q(self.weight), self.bias, self.stride,
                        self.padding))


class ConvTranspose(_Op):
    """k3, stride 2, padding 1, output padding 1: the exact 2x upsampling conv."""

    def __init__(self, cin: int, cout: int, nd: int = 3):
        super().__init__()
        self.nd = nd
        self.weight = nn.Parameter(torch.empty(cin, cout, *(3,) * nd))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        conv = F.conv_transpose3d if self.nd == 3 else F.conv_transpose2d
        return _lc(conv(_cl(self.q(x)), self.q(self.weight), self.bias, 2, 1, 1))


class Dense(_Op):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, EPS)


def instance_norm_relu(x, weight=None, bias=None):
    """Per (sample, channel) over space: biased variance, eps 1e-5, then
    the affine and ReLU."""
    axes = tuple(range(1, x.dim() - 1))
    mean = x.mean(axes, keepdim=True)
    var = (x - mean).square().mean(axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS)
    if weight is not None:
        y = y * weight + bias
    return torch.relu(y)


class InstanceNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return instance_norm_relu(x, self.weight, self.bias)


class BasicConv(nn.Module):
    """conv3 (no bias) -> InstanceNorm (affine) -> ReLU."""

    def __init__(self, cin: int, cout: int, nd: int):
        super().__init__()
        self.conv = Conv(cin, cout, 3, 1, 1, bias=False, nd=nd)
        self.norm = InstanceNorm(cout)

    def forward(self, x):
        return self.norm(self.conv(x))


class UpConv(nn.Module):
    """conv3 (bias) -> InstanceNorm (no affine) -> ReLU -> linear 2x upsample
    (half-pixel centres)."""

    def __init__(self, cin: int, cout: int, nd: int):
        super().__init__()
        self.conv = Conv(cin, cout, 3, 1, 1, bias=True, nd=nd)

    def forward(self, x):
        y = instance_norm_relu(self.conv(x))
        mode = "trilinear" if y.dim() == 5 else "bilinear"
        return _lc(F.interpolate(_cl(y), scale_factor=2, mode=mode, align_corners=False))


def dropout(x, p: float, training: bool, generator: Optional[torch.Generator]):
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class DenseForward(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: int, p: float):
        super().__init__()
        self.p = p
        self.fc1, self.fc2 = Dense(cin, hidden), Dense(hidden, cout)

    def forward(self, x, g):
        x = dropout(F.gelu(self.fc1(x)), self.p, self.training, g)
        return dropout(self.fc2(x), self.p, self.training, g)


class DenseAttention(_Op):
    def __init__(self, dim: int, p: float):
        super().__init__()
        self.p = p
        self.to_qkv = Dense(dim, 3 * dim, bias=False)
        self.to_out = Dense(dim, dim)

    def forward(self, x, g):
        b, n, dim = x.shape
        q, k, v = (t.reshape(b, n, HEADS, dim // HEADS).transpose(1, 2)
                   for t in self.to_qkv(x).split(dim, dim=-1))
        scores = torch.matmul(self.q(q), self.q(k).transpose(-1, -2)) * (dim // HEADS) ** -0.5
        out = torch.matmul(self.q(torch.softmax(scores, dim=-1)), self.q(v))
        out = out.transpose(1, 2).reshape(b, n, dim)
        return dropout(self.to_out(out), self.p, self.training, g)


class DensePreConvAttentionBlock(nn.Module):
    def __init__(self, c: int, p: float):
        super().__init__()
        g = GROWTH
        for i in range(INNER_DEPTH):
            self.add_module(f"squeeze_{i}", Dense(c + i * g, g))
            self.add_module(f"attn_norm_{i}", LayerNorm(g))
            self.add_module(f"attn_{i}", DenseAttention(g, p))
            self.add_module(f"ff_norm_{i}", LayerNorm(g))
            self.add_module(f"ff_{i}", DenseForward(g, 2 * g, g, p))
        self.out_layer = DenseForward(c + INNER_DEPTH * g, 2 * g, c, p)

    def forward(self, x, gen):
        features = [x]
        for i in range(INNER_DEPTH):
            ff, ff_norm = getattr(self, f"ff_{i}"), getattr(self, f"ff_norm_{i}")
            y = getattr(self, f"squeeze_{i}")(torch.cat(features, dim=-1))
            y = getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(y), gen) + y
            y = ff(ff_norm(y), gen) + y
            features.append(ff(ff_norm(y), gen))
        return self.out_layer(torch.cat(features, dim=-1), gen)


class DenseTransformerBlock(nn.Module):
    def __init__(self, c: int, image_size: Sequence[int], blocks: int, p: float):
        super().__init__()
        self.c, self.p = c, p
        self.grid = tuple(s // PATCH for s in image_size)
        self.patch_embed = Conv(1, c, PATCH, PATCH, 0, nd=len(self.grid))
        self.pos_embed = nn.Parameter(torch.empty(math.prod(self.grid), c))
        self.depth = blocks
        for i in range(blocks):
            self.add_module(f"block_{i}", DensePreConvAttentionBlock(c, p))

    def forward(self, x, g):
        x = self.patch_embed(x)
        b = x.shape[0]
        x = dropout(x.reshape(b, -1, self.c) + self.pos_embed, self.p, self.training, g)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, g)
        return x.reshape(b, *self.grid, self.c)


class HDenseFormer(nn.Module):
    """The fine-grid model; ``n_filters`` 32 is HDenseFormer_32 (3-D
    ``image_size``) and HDenseFormer_2D_32 (2-D)."""

    def __init__(self, in_channels: int, n_cls: int, image_size: Sequence[int],
                 transformer_depth: int, n_filters: int = 32, dropout_p: float = 0.5):
        super().__init__()
        nf, nd = n_filters, len(image_size)
        self.attns = nn.ModuleList(
            DenseTransformerBlock(4 * nf, image_size, transformer_depth // INNER_DEPTH,
                                  dropout_p) for _ in range(in_channels))
        self.deep_conv = UpConv(in_channels * 4 * nf, 8 * nf, nd)
        self.up1 = UpConv(8 * nf, 4 * nf, nd)
        self.up2 = UpConv(4 * nf, 2 * nf, nd)
        self.up3 = UpConv(2 * nf, nf, nd)
        widths = {1: nf, 2: 2 * nf, 3: 4 * nf, 4: 8 * nf}
        cin = in_channels
        for lvl in (1, 2, 3, 4):
            self.add_module(f"block_{lvl}_1_left", BasicConv(cin, widths[lvl], nd))
            self.add_module(f"block_{lvl}_2_left", BasicConv(widths[lvl], widths[lvl], nd))
            cin = widths[lvl]
        self.head_d3 = Conv(8 * nf, n_cls, 1, nd=nd)
        for lvl, head in ((3, "head_d2"), (2, "head_d1"), (1, "head")):
            ch = widths[lvl]
            self.add_module(f"upconv_{lvl}", ConvTranspose(2 * ch, ch, nd))
            self.add_module(f"block_{lvl}_1_right", BasicConv(2 * ch, ch, nd))
            self.add_module(f"block_{lvl}_2_right", BasicConv(ch, ch, nd))
            self.add_module(head, Conv(ch, n_cls, 1, nd=nd))

    def set_precision(self, precision: str) -> "HDenseFormer":
        quantise(torch.zeros(1), precision)  # validates the name
        for m in self.modules():
            if isinstance(m, _Op):
                m.precision = precision
        return self

    def forward(self, x, generator: Optional[torch.Generator] = None):
        pool = F.max_pool3d if x.dim() == 5 else F.max_pool2d
        attnall = [attn(x[..., m:m + 1], generator) for m, attn in enumerate(self.attns)]
        attnout = self.deep_conv(torch.cat(attnall, dim=-1))
        at1 = self.up1(attnout)
        at2 = self.up2(at1)
        at3 = self.up3(at2)
        skips, h = [], x
        for lvl, ats in ((1, at3), (2, at2), (3, at1)):
            d = getattr(self, f"block_{lvl}_1_left")(h)
            d = getattr(self, f"block_{lvl}_2_left")(d) + ats
            skips.append(d)
            h = _lc(pool(_cl(d), 2, 2))
        y = self.block_4_2_left(self.block_4_1_left(h)) + attnout
        outs = [self.head_d3(y)]
        for lvl, head in ((3, "head_d2"), (2, "head_d1"), (1, "head")):
            y = torch.cat([getattr(self, f"upconv_{lvl}")(y), skips[lvl - 1]], dim=-1)
            y = getattr(self, f"block_{lvl}_2_right")(getattr(self, f"block_{lvl}_1_right")(y))
            outs.append(getattr(self, head)(y))
        return outs[::-1]


def build(config: dict, device=None) -> HDenseFormer:
    """The reference model of a configuration file's ``model`` entry,
    parameters uninitialised (``portbench.weights`` fills them)."""
    m = config["model"]
    with torch.device(device or "cpu"):
        return HDenseFormer(m["in_channels"], m["num_classes"], tuple(m["image_size"]),
                            m["transformer_depth"], m["n_filters"], m["dropout"])
