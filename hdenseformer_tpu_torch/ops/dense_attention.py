"""Dense softmax attention for tiny heads (head_dim 4).

Counterpart of ``hdenseformer_tpu/ops/dense_attention.py``. The
H-DenseFormer attention runs 8 heads of width 4 over 729 tokens in every
transformer layer of both modality paths.

- ``attention_ref`` is the plain version, a line-for-line port of
  ``xla_attention``: fp32 scores and softmax, probabilities rounded to
  ``v.dtype`` before the second product.
- ``dense_attention`` is the autograd function. A CUDA tensor launches the
  hand-written kernel in ``csrc/dense_attention.cu``; a CPU tensor takes
  ``attention_ref``; any other device raises. The gradient recomputes
  ``attention_ref`` from the saved q, k, v and takes its vector-Jacobian
  product, as JAX's ``fused_dense_attention_trainable`` does through
  ``xla_attention`` (``_fused_bwd``). The kernel does not round the
  probabilities to bf16 (in bf16 it carries each as the sum of two bf16
  parts, to 2^-16 of itself), so in bf16 it differs from ``attention_ref``
  by that rounding (see ``chip_smoke.py`` for the stated tolerance).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from hdenseformer_tpu_torch.ops._build import check, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (4, 8)
# the block shape of csrc/dense_attention.cu (kRows, kChunk, kGroups, kSplits)
_ROWS_PER_WARP = 32  # two m16 tiles of the mma layout
_KEYS_PER_CHUNK = 16  # two m16n8k8 steps of QK^T, one m16n8k16 of P.V
_GROUPS_PER_BLOCK = 4
_KEY_SPLITS = 2
_LANES_PER_ROW = 4  # a quad of the mma's accumulator layout
_SMEM_BYTES = 227 * 1024  # shared memory a block can use on an H100
_GRID_Y = 65535


@dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/dense_attention.cu`` cuts a (B, H, N, D) launch.

    A warp owns ``rows_per_warp`` query rows of one (b, h) and one of
    ``key_splits`` interleaved shares of the chunks of ``keys_per_chunk``
    keys; each row is spread over ``lanes_per_row`` lanes of the warp, so
    over ``lanes_per_row * key_splits`` lanes in all. A block holds
    ``groups_per_block`` row groups x ``key_splits`` warps; ``grid`` is
    (blocks of row groups, B * H), and each block stages K and V of its
    (b, h), padded to ``padded_keys``, in shared memory: ``smem_bytes`` with
    the buffer that merges the key splits.
    """

    rows_per_warp: int
    lanes_per_row: int
    key_splits: int
    keys_per_chunk: int
    groups_per_block: int
    threads: int
    row_groups: int
    grid: tuple
    padded_keys: int
    smem_bytes: int


def launch_plan(b: int, h: int, n: int, d: int, elem_bytes: int) -> LaunchPlan:
    """The launch geometry of the kernel for (b, h, n, d) inputs of
    ``elem_bytes``-byte elements (2: bfloat16, 4: float32)."""
    row_groups = -(-n // _ROWS_PER_WARP)
    chunks = -(-n // _KEYS_PER_CHUNK)
    padded = chunks * _KEYS_PER_CHUNK
    merge_warps = (_KEY_SPLITS - 1) * _GROUPS_PER_BLOCK
    if elem_bytes == 2:
        # K rows in bf16, then V^T in lines of 8-byte words, 4 a chunk,
        # padded to 4 mod 16 words (vt_pitch); the merge buffer holds each
        # lane's accumulator (4 a tile), row maxima (2 a tile) and, for
        # D = 8, row sums (2 a tile)
        words = 4 * chunks
        pitch = words + (20 - words % 16) % 16
        smem = (-(-padded * d * 2 // 16) * 16 + d * pitch * 8
                + merge_warps * 32 * 4 * (4 * 2 + 2 * 2 + (2 * 2 if d == 8 else 1)))
    else:
        # K and V rows in fp32; the merge buffer holds (max, sum, acc[d]) a row
        smem = 2 * padded * d * 4 + merge_warps * _ROWS_PER_WARP * (d + 2) * 4
    return LaunchPlan(
        rows_per_warp=_ROWS_PER_WARP, lanes_per_row=_LANES_PER_ROW, key_splits=_KEY_SPLITS,
        keys_per_chunk=_KEYS_PER_CHUNK, groups_per_block=_GROUPS_PER_BLOCK,
        threads=32 * _GROUPS_PER_BLOCK * _KEY_SPLITS, row_groups=row_groups,
        grid=(-(-row_groups // _GROUPS_PER_BLOCK), b * h), padded_keys=padded, smem_bytes=smem,
    )


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention, (B, H, N, D) -> (B, H, N, D) in ``v.dtype``."""
    d = q.shape[-1]
    scores = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    probs = torch.softmax(scores * (d**-0.5), dim=-1)
    return torch.einsum("bhij,bhjd->bhid", probs.to(v.dtype), v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
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
    plan = launch_plan(b, h, n, d, q.element_size())
    if plan.smem_bytes > _SMEM_BYTES:
        raise ValueError(f"dense_attention: K and V of {n} tokens exceed shared memory")
    if n < 1 or plan.grid[1] > _GRID_Y:
        raise ValueError(f"dense_attention: no grid for {tuple(q.shape)}")
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


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v)
    return _launch(q, k, v)


class _DenseAttention(torch.autograd.Function):
    """Saves q, k, v (views, uncopied); the backward recomputes the plain math."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = attention_ref(q, k, v)
        return torch.autograd.grad(out, (q, k, v), dout)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v for (B, H, N, D) inputs.

    On CUDA, q, k and v must share dtype (float32 or bfloat16), shape and
    strides, with D in (4, 8) and contiguous; the (B, H, N) strides are
    free, so the three head views of one qkv projection go in uncopied. The
    output is a new contiguous tensor in the input dtype. Differentiable;
    where there is nothing to differentiate (serving under
    ``torch.inference_mode``) the forward runs without the autograd
    function and its host cost.
    """
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        return _forward(q, k, v)
    return _DenseAttention.apply(q, k, v)


# kernel launches since the last reset; chip_smoke.py reads it
dense_attention.launches = 0
