"""2-D encoder-decoder baselines: unet, unet++ and deeplabv3+ on ResNet encoders.

Counterpart of ``hdenseformer_tpu/models/unet2d.py`` (the reference's
segmentation_models_pytorch nets): the same net and encoder names, ResNet-18,
-34 and -50 encoders, and the aux classification head (smp's ``aux_params=
{"classes": n - 1}``), which makes a net return ``[masks, class_logits]``.

- Unet: x2 nearest upsample, skip concat, (conv3x3-BN-ReLU) x2; decoder
  channels (256, 128, 64, 32, 16).
- Unet++: the nested dense decoder grid over the same blocks.
- DeepLabV3+: an output-stride-16 encoder (layer4 dilated 2), ASPP with
  rates (12, 24, 36) and image pooling, the 1/4 skip through a 48-channel
  1x1, two 3x3 fuse convs, a x4 bilinear head.
- The aux head: global average pool, dropout 0.2, linear.

Channels-last ``(N, H, W, C)`` in and out, as every module of the port; the
module names are JAX's, so ``weights.load_jax_params`` carries ``params``
and ``batch_stats`` across. Convolutions compute in ``dtype`` (None: the
input's); BatchNorm (``models.layers.BatchNorm``: torch's bookkeeping, JAX's
m = 1 case) returns fp32, so the skips, pools and heads run in fp32, as in
JAX. The heads read fp32. Dropout draws from the explicit generator given to
``forward``; in training without one it raises. These nets launch no kernel
of the port: convolutions and BatchNorm are library calls.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hdenseformer_tpu_torch.models.layers import BatchNorm, Conv, Dense, dropout
from hdenseformer_tpu_torch.ops.resize import max_pool, resize_linear, resize_nearest


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, dilation: int = 1,
          dtype=None, device=None) -> Conv:
    return Conv(cin, cout, k, stride, padding, use_bias=False, dtype=dtype, dilation=dilation,
                ndim=2, device=device)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_nearest(x, tuple(s * 2 for s in x.shape[1:-1]))


class ConvBnRelu(nn.Module):
    """Conv (no bias, SAME by its dilation) + BatchNorm + ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, dtype=None, device=None):
        super().__init__()
        self.conv = _conv(in_features, features, kernel, stride, dilation * (kernel // 2),
                          dilation, dtype, device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1, dilation: int = 1,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv(in_features, features, 3, stride, dilation, dilation, **kw)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = _conv(features, features, 3, 1, dilation, dilation, **kw)
        self.bn2 = BatchNorm(features, device=device)
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.downsample_conv = _conv(in_features, features, 1, stride, **kw)
            self.downsample_bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        res = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(h + res)


class Bottleneck(nn.Module):
    """1x1 to ``features``, 3x3 (stride, dilation), 1x1 to 4 ``features``."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1, dilation: int = 1,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = features * 4
        self.conv1 = _conv(in_features, features, 1, **kw)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = _conv(features, features, 3, stride, dilation, dilation, **kw)
        self.bn2 = BatchNorm(features, device=device)
        self.conv3 = _conv(features, out, 1, **kw)
        self.bn3 = BatchNorm(out, device=device)
        self.downsample = stride != 1 or in_features != out
        if self.downsample:
            self.downsample_conv = _conv(in_features, out, 1, stride, **kw)
            self.downsample_bn = BatchNorm(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        res = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(h + res)


_RESNETS = {
    "resnet18": dict(block=BasicBlock, layers=(2, 2, 2, 2)),
    "resnet34": dict(block=BasicBlock, layers=(3, 4, 6, 3)),
    "resnet50": dict(block=Bottleneck, layers=(3, 4, 6, 3)),
}
_WIDTHS = (64, 128, 256, 512)


def encoder_channels(in_channels: int, encoder_name: str) -> tuple:
    """Widths of ``ResNetEncoder``'s six features."""
    e = _RESNETS[encoder_name]["block"].expansion
    return (in_channels, 64) + tuple(w * e for w in _WIDTHS)


class ResNetEncoder(nn.Module):
    """ResNet backbone returning smp's feature pyramid: [input, conv1 (1/2),
    layer1 (1/4), layer2 (1/8), layer3 (1/16), layer4 (1/32, or 1/16 dilated 2
    at ``output_stride`` 16)]. The stem pools 3x3 / 2 over a -inf pad of 1."""

    def __init__(self, in_channels: int, encoder_name: str = "resnet18",
                 output_stride: int = 32, dtype=None, device=None):
        super().__init__()
        spec = _RESNETS[encoder_name]
        block = spec["block"]
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv(in_channels, 64, 7, 2, 3, **kw)
        self.bn1 = BatchNorm(64, device=device)
        self.blocks = []
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(spec["layers"], _WIDTHS)):
            stride, dilation = (1 if stage == 0 else 2), 1
            if output_stride == 16 and stage == 3:
                stride, dilation = 1, 2
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(cin, width, stride if b == 0 else 1, dilation, **kw))
                cin = width * block.expansion
                names.append(name)
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> list:
        feats = [x]
        h = F.relu(self.bn1(self.conv1(x)))
        feats.append(h)
        h = max_pool(h, 3, 2, padding=1)
        for names in self.blocks:
            for name in names:
                h = getattr(self, name)(h)
            feats.append(h)
        return feats


class DecoderBlock(nn.Module):
    """Nearest x2, concat the skip (if any), two ConvBnRelu 3x3."""

    def __init__(self, in_features: int, skip_features: int, features: int, dtype=None,
                 device=None):
        super().__init__()
        self.conv1 = ConvBnRelu(in_features + skip_features, features, 3, dtype=dtype,
                                device=device)
        self.conv2 = ConvBnRelu(features, features, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _up2(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        return self.conv2(self.conv1(x))


class ClassificationHead(nn.Module):
    """Global average pool, dropout (from the generator), fp32 linear."""

    def __init__(self, in_features: int, classes: int, p: float = 0.2, device=None):
        super().__init__()
        self.p = p
        self.fc = Dense(in_features, classes, device=device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        pooled = dropout(x.mean(dim=(1, 2)), self.p, self.training, generator)
        return self.fc(pooled.float())


class _Net2D(nn.Module):
    """What the three nets share: the encoder, the fp32 head and the aux head."""

    def _outputs(self, masks, head_in, generator):
        if self.cls_head is None:
            return masks
        return [masks, self.cls_head(head_in, generator)]

    def _aux(self, aux_classes, head_features, device):
        self.cls_head = (ClassificationHead(head_features, aux_classes, device=device)
                         if aux_classes else None)


class Unet2D(_Net2D):
    def __init__(self, in_channels: int, encoder_name: str = "resnet18", classes: int = 2,
                 aux_classes: Optional[int] = None,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16), dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.encoder = ResNetEncoder(in_channels, encoder_name, **kw)
        enc = encoder_channels(in_channels, encoder_name)
        skips = enc[:-1][::-1]
        self.n_decoder = len(decoder_channels)
        cin = enc[-1]
        for i, ch in enumerate(decoder_channels):
            skip = skips[i] if i < len(decoder_channels) - 1 else 0
            self.add_module(f"decoder_{i}", DecoderBlock(cin, skip, ch, **kw))
            cin = ch
        self.seg_head = Conv(cin, classes, 3, 1, 1, ndim=2, device=device)
        self._aux(aux_classes, enc[-1], device)

    def forward(self, x: torch.Tensor, generator=None):
        feats = self.encoder(x)
        head_in = feats[-1]
        skips = feats[:-1][::-1]  # [1/16, 1/8, 1/4, 1/2, input]
        h = head_in
        for i in range(self.n_decoder):
            skip = skips[i] if i < self.n_decoder - 1 else None
            h = getattr(self, f"decoder_{i}")(h, skip)
        return self._outputs(self.seg_head(h.float()), head_in, generator)


class UnetPlusPlus2D(_Net2D):
    def __init__(self, in_channels: int, encoder_name: str = "resnet18", classes: int = 2,
                 aux_classes: Optional[int] = None,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16), dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.encoder = ResNetEncoder(in_channels, encoder_name, **kw)
        enc = encoder_channels(in_channels, encoder_name)[1:]  # depths 0..4
        self.depth = depth = len(enc) - 1
        width = {(i, 0): enc[i] for i in range(len(enc))}
        for j in range(1, depth + 1):
            for i in range(depth - j + 1):
                k = depth - 1 - i
                ch = decoder_channels[k] if k < len(decoder_channels) else decoder_channels[-1]
                cin = sum(width[(i, m)] for m in range(j)) + width[(i + 1, j - 1)]
                self.add_module(f"x_{i}_{j}_c1", ConvBnRelu(cin, ch, 3, **kw))
                self.add_module(f"x_{i}_{j}_c2", ConvBnRelu(ch, ch, 3, **kw))
                width[(i, j)] = ch
        self.final_conv = ConvBnRelu(width[(0, depth)], decoder_channels[-1], 3, **kw)
        self.seg_head = Conv(decoder_channels[-1], classes, 3, 1, 1, ndim=2, device=device)
        self._aux(aux_classes, enc[-1], device)

    def forward(self, x: torch.Tensor, generator=None):
        feats = self.encoder(x)
        head_in = feats[-1]
        grid = {(i, 0): f for i, f in enumerate(feats[1:])}
        for j in range(1, self.depth + 1):
            for i in range(self.depth - j + 1):
                h = torch.cat([grid[(i, m)] for m in range(j)] + [_up2(grid[(i + 1, j - 1)])],
                              dim=-1)
                h = getattr(self, f"x_{i}_{j}_c1")(h)
                grid[(i, j)] = getattr(self, f"x_{i}_{j}_c2")(h)
        top = self.final_conv(_up2(grid[(0, self.depth)]))
        return self._outputs(self.seg_head(top.float()), head_in, generator)


class ASPP(nn.Module):
    """1x1, three dilated 3x3 and the image-pooling branch, projected by a 1x1."""

    def __init__(self, in_features: int, features: int = 256, rates: Sequence[int] = (12, 24, 36),
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.features, self.rates = features, tuple(rates)
        self.b0 = ConvBnRelu(in_features, features, 1, **kw)
        for i, r in enumerate(self.rates):
            self.add_module(f"b{i + 1}", ConvBnRelu(in_features, features, 3, dilation=r, **kw))
        self.pool_conv = ConvBnRelu(in_features, features, 1, **kw)
        self.project = ConvBnRelu(features * (len(self.rates) + 2), features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.b0(x)] + [getattr(self, f"b{i + 1}")(x) for i in range(len(self.rates))]
        pooled = self.pool_conv(x.mean(dim=(1, 2), keepdim=True))
        branches.append(pooled.expand(*x.shape[:-1], self.features))
        return self.project(torch.cat(branches, dim=-1))


class DeepLabV3Plus2D(_Net2D):
    def __init__(self, in_channels: int, encoder_name: str = "resnet18", classes: int = 2,
                 aux_classes: Optional[int] = None, decoder_channels: int = 256, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        enc = encoder_channels(in_channels, encoder_name)
        self.encoder = ResNetEncoder(in_channels, encoder_name, output_stride=16, **kw)
        self.aspp = ASPP(enc[-1], decoder_channels, **kw)
        self.low_proj = ConvBnRelu(enc[2], 48, 1, **kw)
        self.fuse1 = ConvBnRelu(decoder_channels + 48, decoder_channels, 3, **kw)
        self.fuse2 = ConvBnRelu(decoder_channels, decoder_channels, 3, **kw)
        self.seg_head = Conv(decoder_channels, classes, 1, ndim=2, device=device)
        self._aux(aux_classes, enc[-1], device)

    def forward(self, x: torch.Tensor, generator=None):
        feats = self.encoder(x)
        head_in = feats[-1]
        low = self.low_proj(feats[2])  # 1/4
        h = torch.cat([resize_linear(self.aspp(head_in), low.shape[1:-1]), low], dim=-1)
        h = self.fuse2(self.fuse1(h))
        masks = resize_linear(self.seg_head(h.float()), x.shape[1:-1])
        return self._outputs(masks, head_in, generator)


def load_torch_resnet_encoder(model: nn.Module, state_dict: Mapping,
                              encoder: str = "encoder") -> nn.Module:
    """Load a torchvision/smp-format ResNet state dict (ImageNet weights, say)
    into ``model``'s encoder in place: the reference's ``ex_pre_trained``
    (smp's ``encoder_weights='imagenet'``), from a local file.

    ``state_dict`` maps torchvision names (``conv1.weight``, ``bn1.*``,
    ``layer{s}.{b}.conv{i}.weight``, ``layer{s}.{b}.downsample.{0,1}.*``)
    to arrays or tensors; other keys (``fc.*``) are ignored. The port's conv
    weights have torchvision's layout; BatchNorm's running statistics become
    the buffers ``mean`` and ``var``. Where the checkpoint's conv1 takes
    another number of input channels than the model (ImageNet RGB against
    the scan's channels), its kernel is averaged over them and repeated:
    smp's ``patch_first_conv``, computed in numpy as JAX's loader does.
    Returns ``model``.
    """
    sd = {k: (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v, np.float32)) for k, v in state_dict.items()}
    enc = model.get_submodule(encoder)

    def put(param: torch.Tensor, value: np.ndarray) -> None:
        if tuple(param.shape) != value.shape:
            raise ValueError(f"shape {value.shape} does not fit {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.ascontiguousarray(value)))

    def set_bn(bn: BatchNorm, prefix: str) -> None:
        for attr, key in (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                          ("var", "running_var")):
            put(getattr(bn, attr), sd[f"{prefix}.{key}"])

    w = sd["conv1.weight"]
    want = enc.conv1.weight.shape[1]
    if w.shape[1] != want:
        w = np.repeat(w.mean(axis=1, keepdims=True), want, axis=1)
    put(enc.conv1.weight, w)
    set_bn(enc.bn1, "bn1")
    for names in enc.blocks:
        for name in names:
            stage, b = name[len("layer"):].split("_")
            t, blk = f"layer{stage}.{b}", getattr(enc, name)
            for i in (1, 2, 3):
                if hasattr(blk, f"conv{i}"):
                    put(getattr(blk, f"conv{i}").weight, sd[f"{t}.conv{i}.weight"])
                    set_bn(getattr(blk, f"bn{i}"), f"{t}.bn{i}")
            if blk.downsample:
                put(blk.downsample_conv.weight, sd[f"{t}.downsample.0.weight"])
                set_bn(blk.downsample_bn, f"{t}.downsample.1")
    return model


NETS_2D = {"unet": Unet2D, "unet++": UnetPlusPlus2D, "deeplabv3+": DeepLabV3Plus2D}


def get_2d_net(net_name: str, encoder_name: str, in_channels: int, classes: int,
               aux_classes: Optional[int] = None, dtype=None, device=None) -> nn.Module:
    if encoder_name not in _RESNETS:
        raise ValueError(f"unknown encoder {encoder_name!r}; options {sorted(_RESNETS)}")
    if net_name not in NETS_2D:
        raise ValueError(f"unknown 2d net {net_name!r}")
    return NETS_2D[net_name](in_channels, encoder_name, classes, aux_classes, dtype=dtype,
                             device=device)
