"""Dense softmax attention for tiny heads (head_dim 4).

Counterpart of ``hdenseformer_tpu/ops/dense_attention.py``. The
H-DenseFormer attention runs 8 heads of width 4 over 729 tokens in every
transformer layer of both modality paths.

- ``attention_ref`` is the plain version, a line-for-line port of
  ``xla_attention``: fp32 scores and softmax, probabilities rounded to
  ``v.dtype`` before the second product.
- ``dense_attention`` is the kernel wrapper. A CUDA tensor launches the
  hand-written kernel in ``csrc/dense_attention.cu``; a CPU tensor takes
  ``attention_ref``; any other device raises. The kernel keeps the
  probabilities in fp32, so in bf16 it differs from ``attention_ref`` by
  that rounding (see ``chip_smoke.py`` for the stated tolerance).
"""
from __future__ import annotations

import torch

from hdenseformer_tpu_torch.ops._build import check, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (4, 8)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention, (B, H, N, D) -> (B, H, N, D) in ``v.dtype``."""
    d = q.shape[-1]
    scores = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    probs = torch.softmax(scores * (d**-0.5), dim=-1)
    return torch.einsum("bhij,bhjd->bhid", probs.to(v.dtype), v)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v for (B, H, N, D) inputs.

    On CUDA, q, k and v must share dtype (float32 or bfloat16), shape and
    strides, with D in (4, 8) and contiguous; the (B, H, N) strides are
    free, so the three head views of one qkv projection go in uncopied. The
    output is a new contiguous tensor in the input dtype.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"dense_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"dense_attention: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                f"does not match q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
        if t.stride() != q.stride():
            raise ValueError(
                f"dense_attention: {name} strides {t.stride()} differ from q's {q.stride()}"
            )
    if q.dim() != 4:
        raise ValueError(f"dense_attention: expected (B, H, N, D), got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dense_attention: dtype {q.dtype} is not float32 or bfloat16")
    b, h, n, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"dense_attention: head dim {d} not in {_HEAD_DIMS}")
    if q.stride(3) != 1:
        raise ValueError(f"dense_attention: head dim must be contiguous, strides {q.stride()}")
    smem = 2 * n * d * 4
    if smem > 227 * 1024:
        raise ValueError(f"dense_attention: K and V of {n} tokens exceed shared memory")
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hdf_dense_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, n, d, q.stride(0), q.stride(1), q.stride(2),
            d**-0.5, stream,
        )
    check(err, "dense_attention")
    dense_attention.launches += 1
    return out


# kernel launches since the last reset; chip_smoke.py reads it
dense_attention.launches = 0
