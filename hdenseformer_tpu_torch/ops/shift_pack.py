"""Space-to-depth half-shift: packed-plain -> packed-shifted, and its transpose.

Counterpart of ``hdenseformer_tpu/ops/shift_pack.py``. In the packed layout
of ``ops/s2d.py`` (channels-last ``(N, *g, f*C)``, f = 2^d, parity-major
channels: packed index = p*C + c), shifted cell j, block p holds plain cell
j - bits(p), block p, and zero outside the grid: the SAME padding of the
fine convolution that ``conv3_packed`` and ``convk_packed`` then run as a
VALID convolution on the coarse grid. The op is linear and a bijection
onto its non-zero slots, so its gradient is another shifted copy
(``shift_unpack``: dx[j][q] = dy[j + bits(q)][q]) and keeps no residuals,
as the JAX custom VJP does.

- ``shift_pack_ref`` and ``shift_unpack_ref`` are the plain versions, ports
  of ``plain_to_shifted`` at full rank and of ``shift_unpack_xla``: a pad,
  2^d slices and a concatenate.
- ``shift_pack`` is the autograd function. A CUDA tensor launches the
  forward kernel of ``csrc/shift_pack.cu``, and its gradient the backward
  kernel (through ``shift_unpack``); a CPU tensor takes the plain versions;
  any other device raises.

Unlike the JAX gate (``_use_pallas``, off by default: inside a jitted step
the Pallas call blocked XLA's fusion), the kernel is always used on the
card: eager PyTorch has no fusion for it to block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from hdenseformer_tpu_torch.ops._build import check, load_library

_DTYPES = (torch.float32, torch.bfloat16)
_VEC_BYTES = (16, 8, 4, 2)


def _split(x: torch.Tensor, what: str) -> tuple[int, int]:
    """(nsp, C) of a packed (N, *g, 2^nsp * C) tensor; raises on other ranks."""
    nsp = x.dim() - 2
    if nsp not in (2, 3):
        raise ValueError(f"{what}: expected 2 or 3 spatial dims, got {tuple(x.shape)}")
    f = 2 ** nsp
    if x.shape[-1] % f:
        raise ValueError(f"{what}: {x.shape[-1]} channels are not a multiple of {f}")
    return nsp, x.shape[-1] // f


def _bits(p: int, nsp: int) -> list[int]:
    """Parity bits of block p, leading spatial dim first."""
    return [(p >> (nsp - 1 - i)) & 1 for i in range(nsp)]


def shift_pack_ref(xp: torch.Tensor) -> torch.Tensor:
    """Plain half-shift, (N, *g, f*C) -> (N, *(g+1), f*C)."""
    nsp, c = _split(xp, "shift_pack_ref")
    g = xp.shape[1:-1]
    xr = F.pad(xp, (0, 0) + (1, 1) * nsp)  # every spatial dim by one cell each side
    pieces = []
    for p in range(2 ** nsp):
        # padded coords: cell j - b of the grid sits at j - b + 1
        idx = (slice(None),) + tuple(
            slice(1 - b, 2 - b + gi) for b, gi in zip(_bits(p, nsp), g)
        ) + (slice(p * c, (p + 1) * c),)
        pieces.append(xr[idx])
    return torch.cat(pieces, dim=-1)


def shift_unpack_ref(dxs: torch.Tensor) -> torch.Tensor:
    """Plain transpose of the half-shift, (N, *(g+1), f*C) -> (N, *g, f*C)."""
    nsp, c = _split(dxs, "shift_unpack_ref")
    g = [s - 1 for s in dxs.shape[1:-1]]
    pieces = []
    for q in range(2 ** nsp):
        idx = (slice(None),) + tuple(
            slice(b, b + gi) for b, gi in zip(_bits(q, nsp), g)
        ) + (slice(q * c, (q + 1) * c),)
        pieces.append(dxs[idx])
    return torch.cat(pieces, dim=-1)


def _launch(x: torch.Tensor, forward: bool) -> torch.Tensor:
    what = "shift_pack" if forward else "shift_unpack"
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {x.dtype} is not float32 or bfloat16")
    nsp, c = _split(x, what)
    if not x.is_contiguous():
        raise ValueError(
            f"{what}: x {tuple(x.shape)} with strides {x.stride()} is not contiguous"
        )
    grow = 1 if forward else -1
    if not forward and min(x.shape[1:-1]) < 1:
        raise ValueError(f"{what}: a shifted grid has at least one cell, got {tuple(x.shape)}")
    out_shape = (x.shape[0],) + tuple(s + grow for s in x.shape[1:-1]) + (x.shape[-1],)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    block_bytes = c * x.element_size()
    vec = next(v for v in _VEC_BYTES
               if block_bytes % v == 0 and x.data_ptr() % v == 0 and y.data_ptr() % v == 0)
    # the kernel takes the grid of the plain side: the input of the forward,
    # the output of the backward
    g = tuple(x.shape[1:-1]) if forward else tuple(out_shape[1:-1])
    g3 = (1,) * (3 - nsp) + g
    rows = x.shape[0] * (out_shape[1] * out_shape[2] if nsp == 3 else out_shape[1])
    if rows > 2 ** 31 - 1:
        raise ValueError(f"{what}: {tuple(x.shape)} is too large for the kernel's grid")
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hdf_shift_pack(
            x.data_ptr(), y.data_ptr(), int(forward), vec, nsp, x.shape[0],
            *g3, block_bytes // vec, stream,
        )
    check(err, what)
    return y


def shift_unpack(dxs: torch.Tensor) -> torch.Tensor:
    """Transpose of the half-shift (the gradient of ``shift_pack``).

    On CUDA, dxs must be contiguous float32 or bfloat16; a new contiguous
    tensor is returned.
    """
    if dxs.device.type == "cpu":
        return shift_unpack_ref(dxs)
    if dxs.device.type != "cuda":
        raise ValueError(f"shift_unpack: unsupported device {dxs.device}")
    y = _launch(dxs, forward=False)
    shift_unpack.launches += y.numel() > 0
    return y


class _ShiftPack(torch.autograd.Function):
    """Linear and residual-free: the backward needs nothing from the forward."""

    @staticmethod
    def forward(ctx, xp: torch.Tensor) -> torch.Tensor:
        if xp.device.type == "cpu":
            return shift_pack_ref(xp)
        if xp.device.type != "cuda":
            raise ValueError(f"shift_pack: unsupported device {xp.device}")
        y = _launch(xp, forward=True)
        shift_pack.launches += y.numel() > 0
        return y

    @staticmethod
    def backward(ctx, dxs: torch.Tensor) -> torch.Tensor:
        return shift_unpack(dxs.contiguous())


def shift_pack(xp: torch.Tensor) -> torch.Tensor:
    """Half-shift of a packed-plain (N, *g, 2^d C) tensor, d = 2 or 3.

    On CUDA, xp must be contiguous float32 or bfloat16; nothing is copied
    to make it so. Differentiable: the gradient is ``shift_unpack``.
    """
    return _ShiftPack.apply(xp)


# kernel launches since the last reset, per direction; chip_smoke.py reads them
shift_pack.launches = 0
shift_unpack.launches = 0
