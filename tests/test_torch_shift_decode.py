"""The shifted InstanceNorm kernels' pad decode, replayed on the CPU.

The kernels of ``csrc/instance_norm_relu.cu`` in their shifted mode decode
each row's pad status from its index: a thread's rows keep one parity block
and step by a constant number of cells, so ``PadWalk`` takes each packed
coordinate's residue once and then steps it without a division.
``ops/instance_norm.py::pad_walk`` mirrors that walk in numpy from the
constants ``Shift.walk`` gives the kernels. These tests replay every
thread's walk of the forward's and the backward's launch plans and hold it
against the pad mask (``_valid_rows``, itself held against JAX's
``shifted_mask_factors``): every valid row read once, no pad row read, and
each chunk's count of valid rows equal to the mask's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu.ops import s2d as jax_s2d  # noqa: E402
from hdenseformer_tpu_torch.ops.instance_norm import (  # noqa: E402
    _valid_rows,
    bwd_launch_plan,
    launch_plan,
    pad_walk,
    shift_of,
)

# (cells, packed dims, C) of every shifted InstanceNorm the models run at
# their presets: HDenseFormer_32's level 0 at 144^3 (packed over (H, W)),
# HDenseFormer_16's levels 0 and 1 (both of <= 32 channels), and the 2-D
# HDenseFormer_2D_32 / _16 at 384^2 (full rank)
ZOO = [((144, 73, 73), (1, 2), 32), ((144, 73, 73), (1, 2), 16), ((72, 37, 37), (1, 2), 32),
       ((193, 193), (0, 1), 32), ((193, 193), (0, 1), 16), ((97, 97), (0, 1), 32)]
# edge shapes: an extent of 2 along a packed dim, one, two and three packed
# dims, row counts that no chunk or unit divides
EDGE = [((2, 5, 6), (0, 2)), ((3, 2, 2), (1, 2)), ((4, 3, 5), (0, 1, 2)), ((6, 5, 7), (0, 1, 2)),
        ((33, 17), (1,)), ((4, 9, 5), (2,)), ((7, 9), (0, 1)), ((2, 2, 2), (0, 1, 2)),
        ((40, 37, 21), (1, 2)), ((129, 65), (0, 1))]
# C of bf16 rows whose 16-byte vectors take 1, 2, 4, 8, 16 and 32 threads a row
TV_CHANNELS = (8, 16, 32, 64, 128, 256)


def _shift(cells, dims, c=1):
    f = 2 ** len(dims)
    return shift_of(torch.empty((1, *cells, f * c)), dims)


def _pads(sh) -> np.ndarray:
    """The pad rows of the (S*f) view, from the port's mask."""
    return ~_valid_rows(sh, torch.device("cpu")).numpy().reshape(-1)


@pytest.mark.parametrize("cells,dims,c", ZOO + [(s, d, 4) for s, d in EDGE])
def test_valid_rows_are_jax_masks(cells, dims, c):
    """The mask the walk is held against: JAX's pad slots, and its count
    ``fused_norm._count``'s (the valid rows the kernels divide by)."""
    sh = _shift(cells, dims, c)
    f = sh.f
    valid = np.ones(cells + (f * c,), bool)
    for i, m in jax_s2d.shifted_mask_factors(cells, f * c, c, dims):
        valid &= m.reshape((1,) * i + (m.shape[0],) + (1,) * (len(cells) - 1 - i) + (f * c,)) > 0
    np.testing.assert_array_equal(~_pads(sh), valid[..., ::c].reshape(-1))
    assert sh.m == valid[..., ::c].sum()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("step", [1, 2, 3, 8, 16, 32, 4224])
@pytest.mark.parametrize("cells,dims", EDGE)
def test_pad_walk_follows_the_mask(cells, dims, step, reverse):
    """Any start row and any cell step, forwards and backwards: the walk's
    pad status equals the mask's at every row it reaches."""
    sh = _shift(cells, dims)
    pads = _pads(sh)
    s = pads.size
    starts = np.arange(s)
    count = 6
    walked = pad_walk(sh, step, starts, count, reverse)
    rows = starts[:, None] + (-1 if reverse else 1) * np.arange(count)[None, :] * step * sh.f
    inside = (rows >= 0) & (rows < s)
    np.testing.assert_array_equal(walked[inside], pads[rows[inside]])


def _forward_cases():
    cases = [(cells, dims, c, 2) for cells, dims, c in ZOO]
    cases += [(cells, dims, c, 2) for cells, dims in EDGE for c in TV_CHANNELS]
    cases += [(cells, dims, c, 4) for cells, dims in EDGE[:4] for c in (1, 4, 32)]
    return cases + [(cells, dims, 1, 2) for cells, dims in EDGE[:4]]  # 2-byte vectors


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("cells,dims,c,elem_bytes", _forward_cases())
def test_forward_walk_reads_each_valid_row_once(cells, dims, c, elem_bytes, n):
    """partial_stats_kernel's and normalize_kernel's pad masks: thread (g,
    lane) of chunk k walks rows k * chunk + g + i * rpb, i < its rows, by
    ``plan.cell_step(f)`` cells; at most 32 rows, the valid ones each read
    once, and every chunk's count of valid rows the mask's."""
    sh = _shift(cells, dims, c)
    pads = _pads(sh)
    s = pads.size
    plan = launch_plan(n, s, c, elem_bytes)
    rpb, m = plan.rows_per_block, plan.rows_per_thread
    assert rpb % sh.f == 0 and m <= 32  # the parity block fixed, the mask one word
    starts = (np.arange(plan.k)[:, None] * plan.chunk + np.arange(rpb)[None, :]).ravel()
    mask = pad_walk(sh, plan.cell_step(sh.f), starts, m)
    rows = starts[:, None] + np.arange(m)[None, :] * rpb
    chunk = np.repeat(np.arange(plan.k), rpb)[:, None] + 0 * rows
    mine = rows < np.minimum((chunk + 1) * plan.chunk, s)  # the kernel's `mine` rows
    np.testing.assert_array_equal(mask[mine], pads[rows[mine]])
    read = np.sort(rows[mine & ~mask])
    np.testing.assert_array_equal(read, np.flatnonzero(~pads))
    counts = np.bincount(chunk[mine & ~mask], minlength=plan.k)
    np.testing.assert_array_equal(counts, np.add.reduceat(~pads, np.arange(0, s, plan.chunk)))


def _backward_cases():
    cases = [(cells, dims, c, 2, n) for cells, dims, c in ZOO for n in (1, 2, 24)]
    cases += [(cells, dims, c, 2, 1) for cells, dims in EDGE for c in TV_CHANNELS]
    return cases + [(cells, dims, c, 4, 3) for cells, dims in EDGE for c in (1, 2, 32)]


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("cells,dims,c,elem_bytes,n", _backward_cases())
def test_backward_walk_reads_each_valid_row_once(cells, dims, c, elem_bytes, n, blocks_per_sm):
    """bwd_persistent_kernel's walk: thread g of part j reads row u * rpu + g
    of the units u = j, j + P, ... (pass a, forwards from unit j) and again
    in reverse (pass c, backwards from the last), by ``plan.cell_step(f)``
    cells a unit. Both passes see the mask's status at every row below S;
    the valid rows are read once over the parts, the pad rows never."""
    sh = _shift(cells, dims, c)
    pads = _pads(sh)
    s = pads.size
    plan = bwd_launch_plan(n, s, c, elem_bytes, sms=132, blocks_per_sm=blocks_per_sm)
    rpu, parts = plan.rows_per_unit, plan.parts
    assert rpu % sh.f == 0
    step = plan.cell_step(sh.f)
    read = []
    for j in range(parts):
        count = -(-(plan.units - j) // parts)
        g = np.arange(rpu)
        rows = (j + np.arange(count)[None, :] * parts) * rpu + g[:, None]
        ahead = pad_walk(sh, step, j * rpu + g, count)
        back = pad_walk(sh, step, (j + (count - 1) * parts) * rpu + g, count, reverse=True)
        np.testing.assert_array_equal(back[:, ::-1], ahead)
        inside = rows < s
        np.testing.assert_array_equal(ahead[inside], pads[rows[inside]])
        read.append(rows[inside & ~ahead])
    np.testing.assert_array_equal(np.sort(np.concatenate(read)), np.flatnonzero(~pads))


@pytest.mark.parametrize("cells,dims,c", ZOO)
def test_walk_constants_fit_the_kernel(cells, dims, c):
    """Shift.walk's constants as the C interface checks them (make_shift,
    walks_by): a period of at least two strides that the stride divides,
    within the cells, and each step residue below its period; both plans'
    rows a multiple of f apart."""
    sh = _shift(cells, dims, c)
    cells_n = int(np.prod(cells))
    for plan in (launch_plan(8, cells_n * sh.f, c, 2), bwd_launch_plan(1, cells_n * sh.f, c, 2)):
        step = plan.cell_step(sh.f)
        stride, period, dstep = sh.walk(step)
        assert len(stride) == len(period) == len(dstep) == len(dims)
        for st, p, d in zip(stride, period, dstep):
            assert p >= 2 * st and p % st == 0 and p <= cells_n and 0 <= d < p
            assert d == step % p
        npk, *arrays = sh.args(step)
        assert npk == len(dims) and [list(a)[:npk] for a in arrays] == [
            list(stride), list(period), list(dstep)]
