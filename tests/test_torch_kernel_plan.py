"""The launch plans of the port's InstanceNorm and attention kernels, on CPU.

``ops/instance_norm.py::launch_plan`` (the forward), ``bwd_launch_plan``
(the backward's persistent grid) and ``ops/dense_attention.py::launch_plan``
cut a call into the grid that the CUDA kernels in ``csrc/`` walk. The kernels
run only on the card (tests/test_torch_cuda.py), but their geometry is plain
arithmetic: these tests replay it in Python and check that every row, channel
and key is visited exactly once, that vectors fit the rows and addresses, and
that the grid and the scratch fit CUDA's limits and the kernels' needs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.ops.dense_attention import (  # noqa: E402
    launch_plan as attention_plan,
)
from hdenseformer_tpu_torch.ops.instance_norm import (  # noqa: E402
    bwd_launch_plan,
    launch_plan,
)

THREADS = 256  # kThreads in csrc/instance_norm_relu.cu
GRID_X, GRID_YZ = 2**31 - 1, 65535
SMEM = 227 * 1024  # shared memory a block can use on an H100

# (n, s, c): the serving shapes of HDenseFormer_32 and Hecktor20Top1 (8
# windows of 144^3; Hecktor's packed norms run on (8, 72^3 * 8, C) views),
# the k7 stem's C = 2, C = 16, and ragged row counts
SERVING = [
    (8, 144**3, 32), (8, 72**3, 64), (8, 36**3, 128), (8, 18**3, 256),
    (8, 72**3 * 8, 32), (8, 144**3, 16),
]
SMALL = [(3, 4099, 2), (3, 4099, 16), (3, 4099, 32), (3, 4099, 256), (1, 7, 3), (2, 1000, 32),
         (1, 5000, 300), (2, 9**3, 256), (1, 1, 8)]


def _rows_visited(plan, s):
    """Rows of one sample that the kernel's threads visit, as the kernel
    computes them: chunk k, row group g, step i -> k * chunk + g + i * rpb."""
    rpb, m = plan.rows_per_block, plan.rows_per_thread
    k = np.arange(plan.k)[:, None, None]
    g = np.arange(rpb)[None, :, None]
    i = np.arange(m)[None, None, :]
    rows = k * plan.chunk + g + i * rpb
    return rows[g + i * rpb < np.minimum(plan.chunk, s - k * plan.chunk)]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,s,c", SMALL)
def test_instance_norm_chunks_cover_every_row_once(n, s, c, elem_bytes):
    plan = launch_plan(n, s, c, elem_bytes)
    rows = _rows_visited(plan, s)
    np.testing.assert_array_equal(np.sort(rows), np.arange(s))


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,s,c", SERVING + SMALL)
def test_instance_norm_plan_fits_the_kernel(n, s, c, elem_bytes):
    plan = launch_plan(n, s, c, elem_bytes)
    # a vector holds whole elements of one row and divides the row
    assert plan.vec_bytes in (16, 8, 4, 2) and plan.vec_bytes >= elem_bytes
    assert (c * elem_bytes) % plan.vec_bytes == 0
    assert plan.cv * elem_bytes == plan.vec_bytes and plan.vectors_per_row * plan.cv == c
    # the widest such vector: 16 bytes wherever the row allows it
    if (c * elem_bytes) % 16 == 0:
        assert plan.vec_bytes == 16
    # threads of a row: a power of two <= 32; the tiles cover the row's vectors once
    rt = plan.row_threads
    assert rt & (rt - 1) == 0 and 1 <= rt <= 32 and plan.channel_tile == rt * plan.cv
    tiles = plan.grid[2]
    lanes = (np.arange(tiles)[:, None] * rt + np.arange(rt)[None, :]).ravel()
    np.testing.assert_array_equal(lanes[lanes < plan.vectors_per_row],
                                  np.arange(plan.vectors_per_row))
    assert (tiles - 1) * rt < plan.vectors_per_row
    # a block of 256 threads: rows per block times threads per row
    assert plan.rows_per_block * rt == THREADS
    assert 16 <= plan.rows_per_thread <= 64
    assert plan.chunk == plan.rows_per_block * plan.rows_per_thread
    # the chunks cover the sample, the last one possibly ragged
    assert plan.k * plan.chunk >= s > (plan.k - 1) * plan.chunk
    # CUDA's grid limits, and the scratch the three kernels index
    assert plan.grid == (plan.k, n, tiles)
    assert plan.grid[0] <= GRID_X and plan.grid[1] <= GRID_YZ and plan.grid[2] <= GRID_YZ
    assert plan.part_floats >= 2 * n * c * plan.k
    assert plan.stats_floats >= 2 * n * c
    # the chunk and K travel to the kernels as C ints
    assert plan.chunk < 2**31 and plan.k < 2**31


@pytest.mark.parametrize("addresses,c,elem_bytes,vec", [
    ((0, 256), 32, 2, 16),  # the serving case
    ((8, 256), 32, 2, 8),   # x 8-byte aligned: 8-byte vectors
    ((2, 256), 32, 2, 2),   # x at an odd bf16 offset: one element at a time
    ((0, 0), 2, 2, 4),      # the k7 stem: 4 bytes a row
    ((0, 0), 3, 4, 4),      # C = 3 fp32: one channel at a time
    ((4, 0), 16, 4, 4),
])
def test_instance_norm_vector_width_follows_row_and_addresses(addresses, c, elem_bytes, vec):
    plan = launch_plan(2, 100, c, elem_bytes, addresses)
    assert plan.vec_bytes == vec
    assert all(a % plan.vec_bytes == 0 for a in addresses)


def test_instance_norm_plan_fills_the_card_at_the_serving_shapes():
    # at least one wave of 256-thread blocks (132 SMs x 8) where the input allows
    for n, s, c in SERVING[:3]:
        plan = launch_plan(n, s, c, 2)
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 132 * 8


# The backward's shapes: a bench.py train step of HDenseFormer_32 (batch 1,
# its 18 InstanceNorms at 4 shapes), Hecktor20Top1's trainer step (batch 2,
# level 1 packed: the (2, 8 * 72^3, 32) view, then levels 2-5 and the vision
# heads' 32-channel norms), and chip_smoke.py's ragged and guard cases
TRAIN_STEP = [(1, 144**3, 32), (1, 72**3, 64), (1, 36**3, 128), (1, 18**3, 256)]
HECKTOR_STEP = [(2, 8 * 72**3, 32), (2, 72**3, 64), (2, 36**3, 128), (2, 18**3, 256),
                (2, 9**3, 512), (2, 72**3, 32), (2, 36**3, 32), (2, 18**3, 32)]
# odd C > 32: bf16 rows of 2-byte vectors, more than 32 of them
RAGGED = [(3, 4099, 2), (3, 4099, 32), (3, 4099, 256), (2, 4096, 32), (1, 1, 8), (1, 7, 3),
          (1, 5000, 300), (300, 64, 32), (2, 5 * 6 * 7, 6), (2, 4099, 33), (1, 5000, 301)]
RING_BYTES = 32768  # kRingBytes in the kernel: x and dy of the units in flight
RED_BYTES = 2 * 8 * 64 * 4  # s_red in the kernel
STATIC_LIMIT = 48 * 1024  # static shared memory a block may declare


def _bwd_rows(plan, n, s, c):
    """Replay bwd_persistent_kernel's walk: per block, the (n, row, channel)
    triples its threads read, in walk order.

    Item it -> part j = it % P, segment it // P = (n, tile z); its units
    j, j + P, ... < U; thread (g, lane) reads row u * rpu + g < S of each
    unit u, vector z * tv + lane < C / cv."""
    tv, cv, rpu = plan.row_threads, plan.cv, plan.rows_per_unit
    out = []
    for b in range(plan.grid):
        rows = []
        for it in range(b * plan.items // plan.grid, (b + 1) * plan.items // plan.grid):
            j, seg = it % plan.parts, it // plan.parts
            nn, z = seg // plan.tiles, seg % plan.tiles
            vi = z * tv + np.arange(tv)
            vi = vi[vi < plan.vectors_per_row]
            chans = (vi[:, None] * cv + np.arange(cv)[None, :]).ravel()
            for u in range(j, plan.units, plan.parts):
                r = u * rpu + np.arange(rpu)
                r = r[r < s]
                cells = np.stack(np.broadcast_arrays(nn, r[:, None], chans[None, :]), -1)
                rows.append(cells.reshape(-1, 3))
        out.append(np.concatenate(rows) if rows else np.zeros((0, 3), int))
    return out


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,s,c", TRAIN_STEP[2:] + HECKTOR_STEP[3:5] + RAGGED)
def test_bwd_plan_owns_every_row_once(n, s, c, elem_bytes, blocks_per_sm):
    plan = bwd_launch_plan(n, s, c, elem_bytes, sms=132, blocks_per_sm=blocks_per_sm)
    cells = np.concatenate(_bwd_rows(plan, n, s, c))
    flat = (cells[:, 0] * s + cells[:, 1]) * c + cells[:, 2]
    # every (n, row, channel) read by exactly one thread of one block
    np.testing.assert_array_equal(np.sort(flat), np.arange(n * s * c))


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,s,c", TRAIN_STEP + HECKTOR_STEP + RAGGED)
def test_bwd_plan_fits_the_card(n, s, c, elem_bytes, blocks_per_sm):
    plan = bwd_launch_plan(n, s, c, elem_bytes, sms=132, blocks_per_sm=blocks_per_sm)
    fwd = launch_plan(n, s, c, elem_bytes)
    # the forward's vector; a tile of at most 64 bytes of whole vectors
    assert (plan.vec_bytes, plan.cv, plan.vectors_per_row) == (
        fwd.vec_bytes, fwd.cv, fwd.vectors_per_row)
    tv = plan.row_threads
    assert tv & (tv - 1) == 0 and 1 <= tv <= 32 and plan.channel_tile == tv * plan.cv
    assert plan.channel_tile * elem_bytes <= 128 and plan.channel_tile <= 64
    assert plan.rows_per_unit * tv == THREADS
    assert plan.tiles == -(-plan.vectors_per_row // tv)
    assert plan.units == -(-s // plan.rows_per_unit)
    # a co-resident grid: never more blocks than the card holds at once
    assert 1 <= plan.grid <= min(plan.items, 132 * blocks_per_sm)
    assert 1 <= plan.parts <= plan.units and plan.items == n * plan.tiles * plan.parts
    if plan.items > plan.grid:  # several items a block only where N * tiles needs it
        assert plan.parts == 1 and n * plan.tiles > 132 * blocks_per_sm
    # the ring holds whole units of x and dy, and beside the tile's (t1, t2)
    # per warp it fits the static shared memory of a block
    unit_bytes = THREADS * plan.vec_bytes * 2
    assert RING_BYTES % unit_bytes == 0 and RING_BYTES // unit_bytes >= 1
    assert RING_BYTES + RED_BYTES <= STATIC_LIMIT
    # the scratch the C function indexes: (t1, t2) at ((n * C + c) * P + j), tsum (n, c, 2)
    assert plan.part_floats == 2 * n * c * plan.parts and plan.tsum_floats == 2 * n * c
    # the plan travels as C ints
    assert plan.grid < 2**31 and plan.parts < 2**31


@pytest.mark.parametrize("n,s,c,tile,parts", [
    (1, 144**3, 32, 32, 264), (1, 72**3, 64, 64, 264), (1, 36**3, 128, 64, 132),
    (1, 18**3, 256, 64, 66),
])
def test_bwd_plan_at_the_train_step(n, s, c, tile, parts):
    # bench.py's four shapes (bf16, 132 SMs, two blocks each): 16-byte
    # vectors, a 128-byte tile (a whole row at C = 32), and the 264 blocks
    # one item each
    plan = bwd_launch_plan(n, s, c, 2, sms=132, blocks_per_sm=2)
    assert (plan.vec_bytes, plan.channel_tile, plan.parts) == (16, tile, parts)
    assert plan.grid == plan.items == 264


ATTENTION = [(8, 8, 729, 4), (8, 8, 729, 8), (1, 2, 130, 4), (2, 2, 17, 8), (1, 1, 1, 4),
             (3, 5, 64, 4), (1, 1, 4096, 4)]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("b,h,n,d", ATTENTION)
def test_attention_plan_covers_every_row_and_key_once(b, h, n, d, elem_bytes):
    plan = attention_plan(b, h, n, d, elem_bytes)
    # rows: block x, row group -> row0 + [0, rows_per_warp), clipped at n
    starts = (np.arange(plan.grid[0])[:, None] * plan.groups_per_block
              + np.arange(plan.groups_per_block)[None, :]).ravel() * plan.rows_per_warp
    rows = (starts[:, None] + np.arange(plan.rows_per_warp)[None, :]).ravel()
    np.testing.assert_array_equal(np.sort(rows[rows < n]), np.arange(n))
    # keys: split sp takes the chunks of 16 keys sp, sp + splits, ... (the
    # last one possibly ragged); the quad's lane t takes keys 2t, 2t + 1 of
    # each of the chunk's two steps of 8
    chunks = -(-n // plan.keys_per_chunk)
    keys = [plan.keys_per_chunk * cc + 8 * step + 2 * t + e
            for sp in range(plan.key_splits) for cc in range(sp, chunks, plan.key_splits)
            for step in (0, 1) for t in range(plan.lanes_per_row) for e in (0, 1)]
    keys = np.array([j for j in keys if j < n])
    np.testing.assert_array_equal(np.sort(keys), np.arange(n))
    assert plan.keys_per_chunk == 16 and plan.padded_keys == 16 * chunks


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("b,h,n,d", ATTENTION)
def test_attention_plan_fits_the_card(b, h, n, d, elem_bytes):
    plan = attention_plan(b, h, n, d, elem_bytes)
    # a row is shared by 4-8 lanes: the quad of the mma layout times the splits
    assert 4 <= plan.lanes_per_row * plan.key_splits <= 8
    assert plan.rows_per_warp % 16 == 0  # whole m16 tiles
    assert plan.threads == 32 * plan.groups_per_block * plan.key_splits <= 1024
    assert plan.grid[1] == b * h <= GRID_YZ and plan.grid[0] <= GRID_X
    # K and V of one (b, h), padded, in the input type, in one block's shared memory
    assert plan.smem_bytes >= 2 * plan.padded_keys * d * elem_bytes
    assert plan.smem_bytes <= SMEM


def test_attention_plan_at_the_serving_shape():
    plan = attention_plan(8, 8, 729, 4, 2)
    # 6 blocks per (b, h); the last block's 89 rows fill three of its four
    # row groups, so no block is mostly empty
    assert plan.grid == (6, 64)
    assert 729 - (plan.grid[0] - 1) * plan.groups_per_block * plan.rows_per_warp > 64
