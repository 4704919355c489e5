"""TransBTS (Wang et al., MICCAI 2021, arXiv:2103.04430) in plain PyTorch, as
shijun18/H-DenseFormer builds it (``models/TransBTS/
TransBTS_downsample8x_skipconnection.py:322-342``, ``TransBTS(n_channels,
num_classes, img_dim)``): the benchmark's reference of the family
"transbts", with its loss, bounds and kernel names.

Input ``x`` (N, D, H, W, C) channels-last, fp32; output ``[logits]`` (N, D,
H, W, classes). GN is GroupNorm(8) over consecutive channels, BN a
BatchNorm, both eps 1e-5; ConvK a k^3 SAME conv with bias; every drop(.) is
below.

Encoder (``Unet``), base width 16:

    h = ConvK3(x; C -> 16);  h = h * keep_c / 0.8          (channel dropout 0.2)
    EnBlock(c): y = Conv3(relu(GN(Conv3(relu(GN(h)))))) + h
    x1 = EnBlock1(h)                                        16 ch, full grid
    x2 = EnBlock2_2(EnBlock2_1(EnDown1(x1)))                32 ch, 1/2
    x3 = EnBlock3_2(EnBlock3_1(EnDown2(x2)))                64 ch, 1/4
    z  = EnBlock4_4(..EnBlock4_1(EnDown3(x3)))              128 ch, 1/8
    EnDown: Conv3 stride 2, padding 1

Bottleneck, E = 512, n tokens of the 1/8 grid in (D, H, W) order:

    t = drop(flatten(Conv3(relu(BN(z)); 128 -> E)) + position_embeddings)
    for each of the 4 layers:
        q, k, v = split(LN_a(t) Wqkv^T)  into 8 heads of 64  (no bias)
        P = drop(softmax(q k^T / 8))                         (fp32)
        t = t + drop(drop((P v) Wproj^T + b))
        t = t + drop(drop(gelu(LN_f(t) W1^T + b1)) W2^T + b2)

Decoder, on the last layer's t before any LayerNorm (y: the t grid):

    pair(y)  = relu(BN(Conv3(relu(BN(Conv3(y))))))
    y = pair_8_1(y; E -> 128);  y = pair_8_2(y) + y
    DeUp(y, skip) = Conv1(cat[skip, ConvT2(Conv1(y))])      (k2 s2 with bias)
    DeBlock(y) = pair(y) + y
    y = DeBlock4(DeUp4(y, x3)); y = DeBlock3(DeUp3(y, x2)); y = DeBlock2(DeUp2(y, x1))
    logits = Conv1(y; 16 -> classes)

Dropout rate 0.1 everywhere in the bottleneck (``dropout_rate``, and
``attn_dropout_rate`` on P and after Wproj); exact (erf) GELU. Every
dropout keeps an element where ``torch.rand(shape, generator) >= p`` and
scales it by 1 / (1 - p), drawn from the one generator given to
``forward`` in this order: the channel coin (N, 1, 1, 1, 16), the tokens,
then per layer the probabilities, the projection, the residual, after GELU
and after W2. BN in training normalises by the batch's mean and biased variance and moves
the buffers ``mean`` and ``var`` with momentum 0.1, the variance unbiased;
in eval it reads them.

Departures from the source, each the system's too: the channel dropout
(``F.dropout3d`` called with its default ``training=True``, on at eval in
the source) runs only in training; the source's final softmax is left to
the loss, so the output is logits; the source zero-initialises its learned
position table, and ``portbench.weights`` draws it as a norm's shift,
U(-0.1, 0.1), for both sides. Parameter and buffer names are the system's
(``position_embeddings``, ``Dense`` weights (out, in), ``mean``/``var``),
so one state dict loads into both.

``set_precision`` quantises the operands of every convolution and matrix
product, the attention's two included (``reference.model.quantise``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench import roofline
from portbench.reference import train
from portbench.reference.model import Conv, Dense, LayerNorm, _cl, _lc, _Op, dropout, quantise

# fixed by the source's ``Unet`` and norms, whatever the signature
BASE, CHANNEL_DROPOUT, GROUPS, EPS, MOMENTUM = 16, 0.2, 8, 1e-5, 0.1


class GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return _lc(F.group_norm(_cl(x), GROUPS, self.weight, self.bias, EPS))


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        return _lc(F.batch_norm(_cl(x), self.mean, self.var, self.weight, self.bias,
                                self.training, MOMENTUM, EPS))


class ConvTranspose2(_Op):
    """k2, stride 2, with bias: the exact 2x upsampling of ``DeUp``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return _lc(F.conv_transpose3d(_cl(self.q(x)), self.q(self.weight), self.bias, 2))


class EnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.bn1, self.conv1 = GroupNorm(c), Conv(c, c, 3, 1, 1)
        self.bn2, self.conv2 = GroupNorm(c), Conv(c, c, 3, 1, 1)

    def forward(self, x):
        return self.conv2(torch.relu(self.bn2(self.conv1(torch.relu(self.bn1(x)))))) + x


class Unet(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        c = BASE
        self.InitConv = Conv(cin, c, 3, 1, 1)
        self.EnBlock1 = EnBlock(c)
        self.EnDown1 = Conv(c, 2 * c, 3, 2, 1)
        self.EnBlock2_1, self.EnBlock2_2 = EnBlock(2 * c), EnBlock(2 * c)
        self.EnDown2 = Conv(2 * c, 4 * c, 3, 2, 1)
        self.EnBlock3_1, self.EnBlock3_2 = EnBlock(4 * c), EnBlock(4 * c)
        self.EnDown3 = Conv(4 * c, 8 * c, 3, 2, 1)
        for i in range(1, 5):
            self.add_module(f"EnBlock4_{i}", EnBlock(8 * c))

    def forward(self, x, g):
        h = self.InitConv(x)
        if self.training:
            keep = torch.rand((h.shape[0], 1, 1, 1, h.shape[-1]), generator=g,
                              device=h.device) >= CHANNEL_DROPOUT
            h = torch.where(keep, h / (1.0 - CHANNEL_DROPOUT), torch.zeros((), device=h.device))
        x1 = self.EnBlock1(h)
        x2 = self.EnBlock2_2(self.EnBlock2_1(self.EnDown1(x1)))
        x3 = self.EnBlock3_2(self.EnBlock3_1(self.EnDown2(x2)))
        z = self.EnDown3(x3)
        for i in range(1, 5):
            z = getattr(self, f"EnBlock4_{i}")(z)
        return x1, x2, x3, z


class SelfAttention(_Op):
    def __init__(self, dim: int, heads: int, p: float):
        super().__init__()
        self.heads, self.p = heads, p
        self.qkv = Dense(dim, 3 * dim, bias=False)
        self.proj = Dense(dim, dim)

    def forward(self, x, g):
        b, n, dim = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        scores = torch.matmul(self.q(q), self.q(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
        probs = dropout(torch.softmax(scores, dim=-1), self.p, self.training, g)
        out = torch.matmul(self.q(probs), self.q(v)).transpose(1, 2).reshape(b, n, dim)
        return dropout(self.proj(out), self.p, self.training, g)


class TransBTS(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, image_size: Sequence[int],
                 embed: int, heads: int, hidden: int, layers: int, p: float, attn_p: float):
        super().__init__()
        self.layers, self.p = layers, p
        self.Unet = Unet(in_channels)
        self.bn = BatchNorm(8 * BASE)
        self.conv_x = Conv(8 * BASE, embed, 3, 1, 1)
        grid = list(image_size)
        for _ in range(3):  # three k3 s2 p1 convs: ceil(s / 2) each
            grid = [-(-s // 2) for s in grid]
        self.position_embeddings = nn.Parameter(torch.empty(math.prod(grid), embed))
        for i in range(layers):
            self.add_module(f"attn_norm_{i}", LayerNorm(embed))
            self.add_module(f"attn_{i}", SelfAttention(embed, heads, attn_p))
            self.add_module(f"ff_norm_{i}", LayerNorm(embed))
            self.add_module(f"ff_fc1_{i}", Dense(embed, hidden))
            self.add_module(f"ff_fc2_{i}", Dense(hidden, embed))
        q = embed // 4
        for name, cin in (("Enblock8_1_", embed), ("Enblock8_2_", q)):
            self._add_pair(name, cin, q)
        cin = q
        for lvl, skip in ((4, 4 * BASE), (3, 2 * BASE), (2, BASE)):
            out = cin // 2
            self.add_module(f"DeUp{lvl}_conv1", Conv(cin, out, 1))
            self.add_module(f"DeUp{lvl}_conv2", ConvTranspose2(out, out))
            self.add_module(f"DeUp{lvl}_conv3", Conv(skip + out, out, 1))
            self._add_pair(f"DeBlock{lvl}_", out, out)
            cin = out
        self.endconv = Conv(cin, num_classes, 1)

    def _add_pair(self, name: str, cin: int, cout: int) -> None:
        for j in (1, 2):
            self.add_module(f"{name}conv{j}", Conv(cin if j == 1 else cout, cout, 3, 1, 1))
            self.add_module(f"{name}bn{j}", BatchNorm(cout))

    def _pair(self, name: str, y):
        for j in (1, 2):
            y = torch.relu(getattr(self, f"{name}bn{j}")(getattr(self, f"{name}conv{j}")(y)))
        return y

    def set_precision(self, precision: str) -> "TransBTS":
        quantise(torch.zeros(1), precision)  # validates the name
        for m in self.modules():
            if isinstance(m, _Op):
                m.precision = precision
        return self

    def forward(self, x, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        g, p, train_mode = generator, self.p, self.training
        x1, x2, x3, z = self.Unet(x, g)
        h = self.conv_x(torch.relu(self.bn(z)))
        b, grid, e = h.shape[0], h.shape[1:-1], h.shape[-1]
        t = dropout(h.reshape(b, -1, e) + self.position_embeddings, p, train_mode, g)
        for i in range(self.layers):
            a = getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(t), g)
            t = t + dropout(a, p, train_mode, g)
            f = F.gelu(getattr(self, f"ff_fc1_{i}")(getattr(self, f"ff_norm_{i}")(t)))
            f = getattr(self, f"ff_fc2_{i}")(dropout(f, p, train_mode, g))
            t = t + dropout(f, p, train_mode, g)
        y = self._pair("Enblock8_1_", t.reshape(b, *grid, e))
        y = self._pair("Enblock8_2_", y) + y
        for lvl, skip in ((4, x3), (3, x2), (2, x1)):
            up = getattr(self, f"DeUp{lvl}_conv2")(getattr(self, f"DeUp{lvl}_conv1")(y))
            y = getattr(self, f"DeUp{lvl}_conv3")(torch.cat([skip, up], dim=-1))
            y = self._pair(f"DeBlock{lvl}_", y) + y
        return [self.endconv(y)]


def build(config: dict, device=None) -> TransBTS:
    """The reference model of a configuration's ``model`` entry, parameters
    uninitialised (``portbench.weights`` fills them), buffers as a fresh
    BatchNorm holds them."""
    m = config["model"]
    with torch.device(device or "cpu"):
        return TransBTS(m["in_channels"], m["num_classes"], tuple(m["image_size"]),
                        m["embedding_dim"], m["num_heads"], m["hidden_dim"], m["num_layers"],
                        m["dropout"], m["attn_dropout"])


def system_kwargs(config: dict) -> dict:
    return {}


def loss(outs, onehot, weight):
    """The system's ``FocalLoss`` (reduction "sum") on the one head."""
    return train.focal_sum(outs[0], onehot, weight)


def _shift_bound_s(config: dict, batch: int) -> float:
    """The packed ``InitConv``'s half-shift (``csrc/shift_pack.cu``'s
    forward), at full rank over (D, H, W): the input packed to (batch,
    D/2, H/2, W/2, 8 C) in the compute dtype, read once, and its shifted
    copy, one cell larger a dim, written once."""
    m = config["model"]
    item = roofline.ITEMSIZE[config["compute_dtype"]]
    grid = [s // 2 for s in m["image_size"]]
    channels = 8 * m["in_channels"]
    cells = math.prod(grid) + math.prod(g + 1 for g in grid)
    return batch * cells * channels * item / roofline.HBM_BYTES_PER_S


def forward_bound_s(config: dict, batch: int, clock_hz: float) -> float:
    return _shift_bound_s(config, batch)


def train_step_bound_s(config: dict, batch: int, clock_hz: float) -> float:
    """The forward's shift alone: its input, the augmented image, takes no
    gradient, so backward launches no transpose."""
    return _shift_bound_s(config, batch)


def kernel_patterns() -> List[str]:
    return ["(anonymous namespace)::shift_kernel"]
