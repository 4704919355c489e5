"""Peaks of one NVIDIA H100 SXM and the least time the system's hand-written
kernels could take for a configuration's work.

The arithmetic is ``chip_smoke.py``'s ``bound`` and ``attention_bound``,
frozen here: a kernel's bound is the larger of its bytes over the HBM rate
and its operations over the tensor-core peak; attention at head width 4 is
bound by its N^2 exponentials a (sample, head) over the special-function
units (16 ``ex2`` a clock on each of 132 SMs at the card's maximum SM
clock). Bytes count each input read once and each output written once.

The work comes from the configuration's shapes, never from what the system
launches: per forward, the InstanceNorm+ReLU of every BasicConv (two a UNet
level in the encoder, two in the decoder but at the bottom) and of the four
UpConvs on the grids they read, and one attention a transformer layer and
modality; per train step also each norm's backward (x and dy read, dx
written) and, once more, the forward of each norm and attention inside a
block that the configuration's ``remat`` checkpoints: backward recomputes
it, so it is work that the configuration asks of the kernels.
"""
from __future__ import annotations

import math
import subprocess
from typing import List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, also the MFU's denominator
SM_COUNT = 132
EX2_PER_CLOCK_SM = 16
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


_ENCODER = frozenset(f"block_{lvl}_{i}_left" for lvl in (1, 2, 3, 4) for i in (1, 2))
_DECODER = frozenset(f"block_{lvl}_{i}_right" for lvl in (1, 2, 3) for i in (1, 2))
_UP = frozenset({"deep_conv", "up1", "up2", "up3"})
# HDenseFormer's blocks that each value of ``remat`` checkpoints (the
# H-DenseFormer JAX model's nn.remat choices); "attns" is each modality's
# transformer; the transposed convolutions hold no norm and are left out
REMAT_BLOCKS = {
    True: _ENCODER | _DECODER | _UP | {"attns"},
    "encoder": _ENCODER | _UP | {"attns"},
    "levels": frozenset(f"block_{lvl}_{i}_{side}" for lvl in (1, 2) for i in (1, 2)
                        for side in ("left", "right")),
    False: frozenset(),
}


def norm_blocks(config: dict) -> List[Tuple[str, int, int]]:
    """(block, voxels a sample, channels) of each InstanceNorm of one forward."""
    m = config["model"]
    s, nf = m["image_size"], m["n_filters"]

    def vox(div):
        return math.prod(d // div for d in s)

    widths = {1: nf, 2: 2 * nf, 3: 4 * nf, 4: 8 * nf}
    blocks = []
    for lvl in (1, 2, 3, 4):  # encoder, two a level
        blocks += [(f"block_{lvl}_{i}_left", vox(2 ** (lvl - 1)), widths[lvl]) for i in (1, 2)]
    for lvl in (3, 2, 1):  # decoder
        blocks += [(f"block_{lvl}_{i}_right", vox(2 ** (lvl - 1)), widths[lvl]) for i in (1, 2)]
    # the UpConvs: deep_conv on the token grid, then up1..up3
    blocks += [("deep_conv", vox(16), 8 * nf), ("up1", vox(8), 4 * nf),
               ("up2", vox(4), 2 * nf), ("up3", vox(2), nf)]
    return blocks


def norm_shapes(config: dict) -> List[Tuple[int, int]]:
    """(voxels a sample, channels) of each InstanceNorm of one forward."""
    return [(v, c) for _, v, c in norm_blocks(config)]


def attention_calls(config: dict) -> Tuple[int, int]:
    """(calls a forward, tokens a sample)."""
    m = config["model"]
    return m["in_channels"] * m["transformer_depth"], math.prod(d // 16 for d in m["image_size"])


def forward_bound_s(config: dict, batch: int, clock_hz: float,
                    blocks: Optional[frozenset] = None) -> float:
    """The forward's norms and attentions, or only those inside ``blocks``."""
    item = ITEMSIZE[config["compute_dtype"]]
    norm_bytes = sum(2 * batch * v * c * item for name, v, c in norm_blocks(config)
                     if blocks is None or name in blocks)
    calls, n = attention_calls(config)
    if blocks is not None and "attns" not in blocks:
        calls = 0
    heads, d = 8, 4
    t_bytes = 4 * batch * heads * n * d * item / HBM_BYTES_PER_S
    t_ops = 4 * batch * heads * n * n * d / PEAK_BF16_FLOPS
    t_exp = batch * heads * n * n / (EX2_PER_CLOCK_SM * SM_COUNT * clock_hz)
    return norm_bytes / HBM_BYTES_PER_S + calls * max(t_bytes, t_ops, t_exp)


def backward_bound_s(config: dict, batch: int) -> float:
    item = ITEMSIZE[config["compute_dtype"]]
    return sum(3 * batch * v * c * item for v, c in norm_shapes(config)) / HBM_BYTES_PER_S


def recompute_bound_s(config: dict, batch: int, clock_hz: float) -> float:
    """The forward work that backward recomputes under the configuration's
    ``remat``."""
    return forward_bound_s(config, batch, clock_hz, REMAT_BLOCKS[config["remat"]])


def train_step_bound_s(config: dict, batch: int, clock_hz: float) -> float:
    return (forward_bound_s(config, batch, clock_hz) + recompute_bound_s(config, batch, clock_hz)
            + backward_bound_s(config, batch))
