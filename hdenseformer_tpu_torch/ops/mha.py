"""Multi-head attention at head width 64 in bf16 (TransBTS, UNETR).

The JAX package has no kernel here: its ``SelfAttention`` (TransBTS) and
``ViTBlock`` (UNETR) are plain einsums. The port's plain version
(``models.layers.self_attention``) materialises the (B, H, N, N) fp32
scores, which at TransBTS's 5,832 tokens are 2.18 GB a tensor a layer.

- ``attention_ref`` is the plain math, as ``self_attention`` runs it on the
  CPU: fp32 scores and softmax, dropout by a given keep mask, probabilities
  rounded to v's dtype before the second product.
- ``mha`` is the autograd function over the hand-written kernels of
  ``csrc/mha64.cu``: one forward launch, and a backward of two (a dQ pass,
  then a dK/dV pass), each deterministic. It takes the qkv projection's
  (B, N, 3 * H * 64) output uncopied and returns (B, N, H * 64). It runs on
  CUDA bf16 at head width 64 only and raises on anything else: the caller
  dispatches (``applies``).

The keep mask is drawn by the caller (``layers.dropout_keep``), so the
kernel's dropout is the plain path's draw for draw: the same generator, the
same shape, the same point in its stream.
"""
from __future__ import annotations

from typing import Optional

import torch

from hdenseformer_tpu_torch.ops._build import check, load_library

HEAD_WIDTH = 64
_GRID_Y = 65535


def applies(device_type: str, dtype: torch.dtype, head_width: int) -> bool:
    """Whether ``mha`` takes a qkv on ``device_type`` in ``dtype`` split into
    heads of ``head_width``: CUDA, bf16, 64. Elsewhere the plain math runs."""
    return device_type == "cuda" and dtype == torch.bfloat16 and head_width == HEAD_WIDTH


def attention_ref(qkv: torch.Tensor, heads: int, keep: Optional[torch.Tensor] = None,
                  p: float = 0.0) -> torch.Tensor:
    """The plain math of ``mha``: (B, N, 3 C) -> (B, N, C), keep (B, H, N, N)
    bool or None (no dropout)."""
    b, n = qkv.shape[:2]
    qkv = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * q.shape[-1] ** -0.5, dim=-1)
    if keep is not None:
        probs = apply_keep(probs, keep, p)
    out = torch.matmul(probs.to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, n, -1)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Dropout by a drawn keep mask: x / (1 - p) where kept, 0 elsewhere."""
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _checked(qkv: torch.Tensor, heads: int, keep: Optional[torch.Tensor]) -> tuple:
    """(b, n, c) of a qkv that the kernels take; raises on anything else."""
    if qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16 or qkv.dim() != 3:
        raise ValueError(f"mha: needs a (B, N, 3 C) bfloat16 CUDA tensor, got "
                         f"{tuple(qkv.shape)} {qkv.dtype} on {qkv.device}")
    b, n, c3 = qkv.shape
    if heads < 1 or c3 != 3 * heads * HEAD_WIDTH:
        raise ValueError(f"mha: {c3} features are not 3 x {heads} heads of {HEAD_WIDTH}")
    if n < 1 or b * heads > _GRID_Y:
        raise ValueError(f"mha: no grid for {tuple(qkv.shape)} with {heads} heads")
    if (qkv.stride(2) != 1 or qkv.stride(0) % 8 or qkv.stride(1) % 8
            or qkv.data_ptr() % 16):
        raise ValueError(f"mha: rows must be contiguous and 16-byte aligned, strides "
                         f"{qkv.stride()}")
    if keep is not None and (keep.dtype != torch.bool or keep.device != qkv.device
                             or tuple(keep.shape) != (b, heads, n, n)
                             or not keep.is_contiguous()):
        raise ValueError(f"mha: keep must be a contiguous ({b}, {heads}, {n}, {n}) bool on "
                         f"{qkv.device}, got {tuple(keep.shape)} {keep.dtype} on {keep.device}")
    return b, n, c3 // 3


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward(qkv, heads, keep, p, save: bool):
    b, n, c = _checked(qkv, heads, keep)
    dev = qkv.device
    o = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
    o32 = torch.empty((b, n, c), dtype=torch.float32, device=dev) if save else None
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=dev) if save else None
    with torch.cuda.device(dev):
        err = load_library().hdf_mha64_fwd(
            qkv.data_ptr(), _ptr(keep), o.data_ptr(), _ptr(o32), _ptr(lse), b, heads, n,
            qkv.stride(0), qkv.stride(1), HEAD_WIDTH ** -0.5, 1.0 / (1.0 - p),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mha")
    mha.launches += 1
    return o, o32, lse


class _MHA(torch.autograd.Function):
    """Saves qkv, the keep mask, O in fp32 and the log-sum-exp; no N x N."""

    @staticmethod
    def forward(ctx, qkv, heads, keep, p):
        o, o32, lse = _forward(qkv, heads, keep, p, save=True)
        ctx.save_for_backward(qkv, keep, o32, lse)
        ctx.heads, ctx.p = heads, p
        return o

    @staticmethod
    def backward(ctx, dout):
        qkv, keep, o32, lse = ctx.saved_tensors
        b, n, c = _checked(qkv, ctx.heads, keep)
        dout = dout.contiguous()
        dqkv = torch.empty((b, n, 3 * c), dtype=torch.bfloat16, device=qkv.device)
        dlt = torch.empty((b, ctx.heads, n), dtype=torch.float32, device=qkv.device)
        with torch.cuda.device(qkv.device):
            err = load_library().hdf_mha64_bwd(
                qkv.data_ptr(), _ptr(keep), dout.data_ptr(), o32.data_ptr(), lse.data_ptr(),
                dlt.data_ptr(), dqkv.data_ptr(), b, ctx.heads, n, qkv.stride(0),
                qkv.stride(1), HEAD_WIDTH ** -0.5, 1.0 / (1.0 - ctx.p),
                torch.cuda.current_stream(qkv.device).cuda_stream)
        check(err, "mha backward")
        mha.backward_launches += 1
        return dqkv, None, None, None


def mha(qkv: torch.Tensor, heads: int, keep: Optional[torch.Tensor] = None,
        p: float = 0.0) -> torch.Tensor:
    """Attention of a (B, N, 3 * heads * 64) bf16 CUDA qkv, split as
    ``reshape(B, N, 3, heads, 64)``, with dropout ``p`` by the keep mask
    ``keep`` ((B, heads, N, N) bool, or None for none); (B, N, heads * 64)
    bf16. Differentiable in qkv; where nothing needs a gradient the forward
    neither saves nor writes what the backward reads."""
    if not (torch.is_grad_enabled() and qkv.requires_grad):
        return _forward(qkv, heads, keep, p, save=False)[0]
    return _MHA.apply(qkv, heads, keep, p)


# kernel launches since the last reset (forward; backward, each two kernels)
mha.launches = 0
mha.backward_launches = 0
