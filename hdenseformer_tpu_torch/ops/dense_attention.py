"""Dense softmax attention for tiny heads (head_dim 4).

Counterpart of ``hdenseformer_tpu/ops/dense_attention.py``. The
H-DenseFormer attention runs 8 heads of width 4 over 729 tokens in every
transformer layer of both modality paths.

- ``attention_ref`` is the plain version, a line-for-line port of
  ``xla_attention``: fp32 scores and softmax, probabilities rounded to
  ``v.dtype`` before the second product.
- ``dense_attention`` is the autograd function. A CUDA tensor launches the
  hand-written kernels in ``csrc/dense_attention.cu``, forward and backward;
  a CPU tensor takes ``attention_ref`` and, for the gradient, its
  vector-Jacobian product recomputed from the saved q, k, v (as JAX's
  ``fused_dense_attention_trainable`` does through ``xla_attention``,
  ``_fused_bwd``); any other device raises. When a gradient will be taken,
  the forward kernel also writes each row's log-sum-exp and (bf16) O in
  fp32, and the backward kernels recompute the probabilities from them: no
  (B, H, N, N) tensor reaches device memory. The forward kernel does not
  round the probabilities to bf16 (in bf16 it carries each as the sum of two
  bf16 parts, to 2^-16 of itself), so in bf16 it differs from
  ``attention_ref`` by that rounding (see ``chip_smoke.py`` for the stated
  tolerance); the backward keeps P, dP and dS in fp32 where the plain path
  rounds P and dP to bf16.
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


# the backward's geometry in csrc/dense_attention.cu (kBwdWarps, kBwdStep, kBwdR)
_BWD_WARPS = 8
_BWD_STEP = 4
_BWD_ROWS_PER_LANE = 2
_BWD_SPLITS = (1, 2, 4, 8)
# two waves of the 3 blocks an SM holds at once (85 registers a thread, the
# kernels' launch bounds): small blocks then even out the SMs' shares
_BWD_BLOCKS_PER_SM = 6
H100_SMS = 132


@dataclass(frozen=True)
class BwdLaunchPlan:
    """How the backward's two launches cut a (B, H, N, D) call; both share it.

    The dQ pass gives each lane ``rows_per_lane`` query rows (lane l: rows
    l, l + 32, ...) and walks keys; the dK/dV pass gives each lane key rows
    and walks queries. A warp holds ``rows_per_warp`` rows and one of
    ``splits`` spans of ``span`` columns; a block is ``groups_per_block``
    row groups x ``splits`` warps, its (b, h)'s columns staged in shared
    memory as fp32 rows, padded to
    ``splits * span`` (``dq_smem_bytes``: K and V; ``dkv_smem_bytes``: Q,
    dO, lse and Delta), beside the buffer that merges the splits. ``grid``
    is (blocks of row groups, B * H).
    """

    rows_per_lane: int
    rows_per_warp: int
    splits: int
    groups_per_block: int
    threads: int
    row_groups: int
    span: int
    grid: tuple
    dq_smem_bytes: int
    dkv_smem_bytes: int


def bwd_launch_plan(b: int, h: int, n: int, d: int, sm_count: int = H100_SMS) -> BwdLaunchPlan:
    """The backward's geometry for (b, h, n, d) on ``sm_count`` SMs: the
    fewest column splits that give every SM ``_BWD_BLOCKS_PER_SM`` blocks
    (at most 8 splits, one warp each), so that few (b, h) slices, as the 3-D
    step's 16, still fill the card. Raises where the staged rows exceed
    shared memory."""
    rows_per_warp = 32 * _BWD_ROWS_PER_LANE
    row_groups = -(-n // rows_per_warp)
    for splits in _BWD_SPLITS:
        groups = _BWD_WARPS // splits
        blocks = -(-row_groups // groups)
        if blocks * b * h >= _BWD_BLOCKS_PER_SM * sm_count:
            break
    per_split = -(-n // splits)
    span = -(-per_split // _BWD_STEP) * _BWD_STEP
    padded = splits * span
    # the rows whose sums splits 1, 2, ... park for split 0
    merge = (splits - 1) * groups * rows_per_warp
    plan = BwdLaunchPlan(
        rows_per_lane=_BWD_ROWS_PER_LANE, rows_per_warp=rows_per_warp, splits=splits,
        groups_per_block=groups, threads=32 * _BWD_WARPS, row_groups=row_groups, span=span,
        grid=(blocks, b * h), dq_smem_bytes=4 * (2 * padded * d + merge * d),
        dkv_smem_bytes=4 * (2 * padded * d + 2 * padded + merge * 2 * d),
    )
    if max(plan.dq_smem_bytes, plan.dkv_smem_bytes) > _SMEM_BYTES:
        raise ValueError(f"dense_attention: the backward's rows of {n} tokens exceed "
                         f"shared memory")
    return plan


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention, (B, H, N, D) -> (B, H, N, D) in ``v.dtype``."""
    d = q.shape[-1]
    scores = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    probs = torch.softmax(scores * (d**-0.5), dim=-1)
    return torch.einsum("bhij,bhjd->bhid", probs.to(v.dtype), v)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save: bool = False):
    """The forward kernel: (out, O in fp32, lse) with ``save``, else (out,
    None, None); without ``save`` it writes nothing but ``out``."""
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
    dev = q.device
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=dev)
    o32 = (torch.empty((b, h, n, d), dtype=torch.float32, device=dev)
           if save and q.dtype != torch.float32 else None)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev) if save else None
    with torch.cuda.device(dev):
        err = load_library().hdf_dense_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(o32), _ptr(lse),
            _DTYPES[q.dtype], b, h, n, d, q.stride(0), q.stride(1), q.stride(2),
            d**-0.5, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "dense_attention")
    dense_attention.launches += 1
    if not save:
        return out, None, None
    return out, (out if o32 is None else o32), lse


def _grad_views(b: int, h: int, n: int, d: int, dtype, device) -> tuple:
    """dQ, dK, dV as (B, H, N, D) views of one (B, N, 3, H, D) buffer: the
    model's head views (``qkv.split(...)``, ``.view(b, n, h, d)``,
    ``.transpose(1, 2)``) then take their gradients back to (B, N, H * D)
    without a copy, where contiguous (B, H, N, D) gradients are copied once
    each; the split's backward still concatenates the three."""
    grad = torch.empty((b, n, 3, h, d), dtype=dtype, device=device)
    return tuple(grad[:, :, i].transpose(1, 2) for i in range(3))


def _backward(q, k, v, o, lse, dout, plan: BwdLaunchPlan):
    """dQ, dK, dV from the backward kernels (``_grad_views``)."""
    b, h, n, d = q.shape
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    dq, dk, dv = _grad_views(b, h, n, d, q.dtype, q.device)
    with torch.cuda.device(q.device):
        err = load_library().hdf_dense_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype],
            b, h, n, d, *q.stride()[:3], *dout.stride()[:3], *dq.stride()[:3], plan.splits,
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(err, "dense_attention backward")
    dense_attention.backward_launches += 1
    return dq, dk, dv


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v)
    return _launch(q, k, v)[0]


class _DenseAttention(torch.autograd.Function):
    """CUDA: saves q, k, v (views, uncopied), O in fp32 and the log-sum-exp,
    and the backward kernels recompute P; no N x N tensor. CPU: saves q, k, v,
    and the backward recomputes the plain math."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return attention_ref(q, k, v)
        out, o, lse = _launch(q, k, v, save=True)
        # raises here, not in the backward, where the backward cannot run
        ctx.plan = bwd_launch_plan(
            *q.shape, torch.cuda.get_device_properties(q.device).multi_processor_count)
        ctx.save_for_backward(q, k, v, o, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors  # once: a checkpointed recompute unpacks each only once
        if len(saved) == 5:
            return _backward(*saved, dout, ctx.plan)
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in saved)
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
    function and its host cost, and writes nothing for a backward.

    Shared memory bounds N. The forward stages K and V of a (b, h): up to
    14,096 tokens in bf16 and 7,168 in fp32 at D = 4, 6,992 and 3,552 at
    D = 8. The backward stages the other side of a (b, h) in fp32, so a call
    that will be differentiated is refused in its forward past about 5,400
    tokens at D = 4 and 2,800 at D = 8 (5,808 and 3,228 where enough (b, h)
    slices fill the card with one column split; ``bwd_launch_plan``): a 3-D
    patch of 272^3 (4,913 tokens) trains, one of 288^3 (5,832) does not.
    """
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        return _forward(q, k, v)
    return _DenseAttention.apply(q, k, v)


# kernel launches since the last reset (forward; backward, each two kernels);
# chip_smoke.py reads them
dense_attention.launches = 0
dense_attention.backward_launches = 0
