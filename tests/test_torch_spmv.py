"""The port's SpMV kernels and their plain versions.

On the CPU the plain versions are held against the JAX Pallas kernels run
in interpret mode (as ``tests/test_tiled_spmv.py`` runs them) and against
scipy, the plain block SpMM against the JAX package's ``_block_matmat``;
the port's df32 counterparts against ``ortools_tpu/ops/df32.py``.
The CUDA kernels are held against the plain versions on the card in
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.ops import df32 as jdf32
from ortools_tpu.ops.block_sparse import BlockSparseMatrix as JMatrix
from ortools_tpu.ops.block_sparse import _block_matmat as _jax_block_matmat
from ortools_tpu.ops.tiled_spmv import pack_tiled, tiled_matvec, tiled_matvec_fast

from ortools_tpu_torch.ops import df32 as tdf32
from ortools_tpu_torch.ops import tiled_spmv as T
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix as TMatrix

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)

# tests/test_tiled_spmv.py:31-39
TILED_CASES = [
    (300, 500, 0.02, (8, 128)),
    (1000, 700, 0.005, (8, 128)),
    (900, 1100, 0.002, (32, 128)),
    (17, 5, 0.5, (8, 128)),
    (128, 20000, 0.001, (8, 128)),  # many column blocks
]


def _make(m, n, density, block_shape, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=density, random_state=rng, format="csr")
    jm = JMatrix.from_scipy(a, block_shape=block_shape)
    jt = pack_tiled(np.asarray(jm.data), np.asarray(jm.block_rows),
                    np.asarray(jm.block_cols), jm.num_real_blocks,
                    jm.padded_shape).with_hi()
    tm = TMatrix.from_scipy(a, block_shape=block_shape, dtype=torch.float32,
                            device=device).with_tiled(hi=True)
    return a, jm, jt, tm


@pytest.mark.parametrize("m,n,density,block_shape", TILED_CASES)
def test_plain_exact_matches_jax_kernel(m, n, density, block_shape):
    a, jm, jt, tm = _make(m, n, density, block_shape, seed=m + n)
    x = np.random.default_rng(1).standard_normal(n)
    ref = np.asarray(tiled_matvec(jt, jm.pad_x(x), jm.padded_shape[0],
                                  interpret=True))[:m]
    y = T.tiled_matvec_plain(tm.tiled, tm.pad_x(x)).numpy()[:m]
    scale = 1 + np.abs(ref).max()
    assert np.abs(y - ref).max() <= 1e-5 * scale
    assert np.abs(y - a @ x).max() <= 1e-5 * (1 + np.abs(a @ x).max())
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(T.tiled_matvec(tm.tiled, tm.pad_x(x)).numpy()[:m], y)


@pytest.mark.parametrize("m,n,density,block_shape", [
    (300, 500, 0.02, (8, 128)),
    (900, 1100, 0.002, (32, 128)),
])
def test_plain_fast_matches_jax_kernel_and_scipy(m, n, density, block_shape):
    a, jm, jt, tm = _make(m, n, density, block_shape, seed=m + 2 * n)
    x = np.random.default_rng(4).standard_normal(n)
    ref_fast = np.asarray(tiled_matvec_fast(jt, jm.pad_x(x),
                                            jm.padded_shape[0],
                                            interpret=True))[:m]
    y = T.tiled_matvec_fast_plain(tm.tiled, tm.pad_x(x)).numpy()[:m]
    exact = a @ x
    scale = 1 + np.abs(exact).max()
    assert np.abs(y - ref_fast).max() <= 3e-2 * scale
    assert np.abs(y - exact).max() <= 3e-2 * scale
    y_exact = T.tiled_matvec_plain(tm.tiled, tm.pad_x(x)).numpy()[:m]
    assert np.abs(y - y_exact).max() > 0
    np.testing.assert_array_equal(
        T.tiled_matvec_fast(tm.tiled, tm.pad_x(x)).numpy()[:m], y)


def test_fast_without_bf16_copy_raises():
    _, _, _, tm = _make(300, 500, 0.02, (8, 128), seed=9)
    lay = tm.tiled._replace(data_hi=None)
    with pytest.raises(ValueError, match="bf16"):
        T.tiled_matvec_fast(lay, tm.pad_x(np.ones(500)))
    # matvec_fast on a matrix without the copy is the exact product
    plain = TMatrix.from_scipy(sp.random(300, 500, density=0.02,
                                         random_state=0),
                               device="cpu").with_tiled(hi=False)
    x = plain.pad_x(np.ones(500))
    np.testing.assert_array_equal(plain.matvec_fast(x).numpy(),
                                  plain.matvec(x).numpy())


def test_df32_counterparts_on_a_cancelling_sum():
    rng = np.random.default_rng(0)
    big = rng.uniform(1e3, 1e4, size=4096).astype(np.float32)
    small = rng.uniform(-1, 1, size=4096).astype(np.float32)
    x = np.concatenate([big, small, -big])
    rng.shuffle(x)
    y = rng.standard_normal(x.size).astype(np.float32)
    exact_sum = float(np.sum(x.astype(np.float64)))
    exact_dot = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    t_sum = float(tdf32.sum_df32(torch.from_numpy(x)))
    t_dot = float(tdf32.vdot_df32(torch.from_numpy(x), torch.from_numpy(y)))
    j_sum = float(jdf32.sum_df32(jnp.asarray(x)))
    j_dot = float(jdf32.vdot_df32(jnp.asarray(x), jnp.asarray(y)))
    for got, ref in ((t_sum, exact_sum), (t_dot, exact_dot),
                     (j_sum, exact_sum), (j_dot, exact_dot)):
        ulp = float(np.spacing(np.float32(abs(ref))))
        assert abs(got - ref) <= ulp, (got, ref, ulp)
    # a plain f32 sum misses it by far more than one ulp
    plain = float(torch.from_numpy(x).sum())
    assert abs(plain - exact_sum) > float(np.spacing(np.float32(exact_sum)))


def test_launch_counters_untouched_on_cpu():
    _, _, _, tm = _make(300, 500, 0.02, (8, 128), seed=3)
    before = (T.tiled_matvec.launches, T.tiled_matvec_fast.launches)
    x = tm.pad_x(np.ones(500))
    T.tiled_matvec(tm.tiled, x)
    T.tiled_matvec_fast(tm.tiled, x)
    assert (T.tiled_matvec.launches, T.tiled_matvec_fast.launches) == before


# ---------------------------------------------------------------------------
# The kernels' row schedule (make_layout)
# ---------------------------------------------------------------------------


def _row_lengths(lay):
    return np.diff(lay.row_ptr.numpy())


@pytest.mark.parametrize("m,n,density,block_shape", TILED_CASES)
def test_layout_schedule_covers_every_row_once(m, n, density, block_shape):
    a, jm, _, tm = _make(m, n, density, block_shape, seed=m + n)
    lay = tm.tiled
    table = lay.schedule.numpy()
    assert lay.schedule.dtype == torch.int32
    assert table.shape == (lay.num_block_rows, 4)
    sched = table[:, 0]
    np.testing.assert_array_equal(np.sort(sched),
                                  np.arange(lay.num_block_rows))
    # each entry holds its row's blocks: row_ptr[r] .. row_ptr[r + 1]
    row_ptr = lay.row_ptr.numpy()
    np.testing.assert_array_equal(table[:, 1], row_ptr[sched])
    np.testing.assert_array_equal(table[:, 2], row_ptr[sched + 1])
    assert not table[:, 3].any()
    # row_ptr counts the blocks the JAX package stores in each block-row
    bm = block_shape[0]
    jrows = np.asarray(jm.block_rows)[:jm.num_real_blocks]
    np.testing.assert_array_equal(
        _row_lengths(lay),
        np.bincount(jrows, minlength=jm.padded_shape[0] // bm))
    # long rows first, then short ones, each longest first
    lengths = _row_lengths(lay)[sched]
    block_bytes = bm * block_shape[1] * 4
    long_rows = ((lengths * block_bytes > T.WARP_ROW_BYTES)
                 | (block_bytes > T.WARP_BLOCK_BYTES))
    assert long_rows[:lay.num_long].all()
    assert not long_rows[lay.num_long:].any()
    assert np.all(np.diff(lengths[:lay.num_long]) <= 0)
    assert np.all(np.diff(lengths[lay.num_long:]) <= 0)


@pytest.mark.parametrize("counts,block_bytes,schedule,num_long", [
    # 4 KB blocks: a row of 17+ blocks (over 64 KB) is long; ties keep order
    ([0, 1, 96, 3, 20, 0, 4], 4096, [2, 4, 6, 3, 1, 0, 5], 2),
    # blocks over 4 KB are too large for a warp: every row is long
    ([0, 1, 96, 3], 8192, [2, 3, 1, 0], 4),
    # no long row
    ([2, 0, 2, 16], 4096, [3, 0, 2, 1], 0),
    # a row of exactly 64 KB is still a warp's; one block more is not
    ([6, 1, 17, 16], 4096, [2, 3, 0, 1], 1),
    # 128 long rows: one thread block each
    ([40] * 128, 4096, list(range(128)), 128),
])
def test_row_schedule_assigns_rows_by_length(counts, block_bytes, schedule,
                                             num_long):
    got = T.row_schedule(np.array(counts), block_bytes)
    np.testing.assert_array_equal(got[0], schedule)
    assert got[1] == num_long


def test_row_schedule_of_the_bench_lp():
    # block_random_lp(16384, 16384, 4096, (8, 128), seed=0) draws its block
    # cells first: A has 2048 block-rows, its transpose 128.
    cells = np.random.default_rng(0).choice(2048 * 128, size=4096,
                                            replace=False)
    counts_a = np.bincount(cells // 128, minlength=2048)
    counts_at = np.bincount(cells % 128, minlength=128)
    # A^T: 128 rows of 16-49 blocks of 4 KB, each a thread block's
    sched, num_long = T.row_schedule(counts_at, 128 * 8 * 4)
    assert counts_at.min() > 16 and num_long == 128
    # A: 2048 rows of 0-10 blocks, each a warp's, longest first
    sched, num_long = T.row_schedule(counts_a, 8 * 128 * 4)
    assert num_long == 0
    assert counts_a[sched[0]] == counts_a.max() and counts_a.max() <= 16


def test_make_layout_is_deterministic():
    a, _, _, tm = _make(1000, 700, 0.005, (8, 128), seed=1700)
    again = TMatrix.from_scipy(a, block_shape=(8, 128), dtype=torch.float32,
                               device="cpu").with_tiled(hi=True)
    for name in ("row_ptr", "schedule", "block_cols", "data", "data_hi"):
        assert torch.equal(getattr(tm.tiled, name),
                           getattr(again.tiled, name)), name
    assert tm.tiled.num_long == again.tiled.num_long


# ---------------------------------------------------------------------------
# The batched product (block SpMM) and its plain version
# ---------------------------------------------------------------------------

# Every block shape the kernels take, on a 256 x 384 matrix.
SPMM_SHAPES = [(bm, bn) for bm in (8, 32, 128) for bn in (8, 32, 128)]


def _spmm_pair(block_shape, seed, density=0.05, shape=(256, 384)):
    rng = np.random.default_rng(seed)
    a = sp.random(*shape, density=density, random_state=rng, format="csr")
    jm = JMatrix.from_scipy(a, block_shape=block_shape, dtype=jnp.float64)
    tm = TMatrix.from_scipy(a, block_shape=block_shape, dtype=torch.float64,
                            device="cpu")
    return a, jm, tm


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("block_shape", SPMM_SHAPES + ["empty"],
                         ids=[f"{bm}x{bn}" for bm, bn in SPMM_SHAPES]
                         + ["empty"])
def test_plain_spmm_matches_jax_block_matmat(block_shape, batch):
    """The plain SpMM (batch leading, [B, N] -> [B, M]) against the JAX
    package's ``_block_matmat`` ([N, k] -> [M, k]) in f64, at rtol 1e-12;
    with and without the kernel layout, and through ``matmat``."""
    if block_shape == "empty":
        a = sp.csr_matrix((50, 60))
        jm = JMatrix.from_scipy(a, dtype=jnp.float64)
        tm = TMatrix.from_scipy(a, dtype=torch.float64, device="cpu")
    else:
        a, jm, tm = _spmm_pair(block_shape, seed=batch + block_shape[0])
    rng = np.random.default_rng(batch)
    x = rng.standard_normal((batch, tm.padded_shape[1]))
    ref = np.asarray(_jax_block_matmat(jm.data, jm.block_rows, jm.block_cols,
                                       jnp.asarray(x.T),
                                       jm.padded_shape[0])).T
    scale = 1 + np.abs(ref).max(initial=0)
    for mat in (tm, tm.with_tiled()):
        y = mat.matvec(torch.tensor(x))
        assert y.shape == (batch, tm.padded_shape[0])
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * scale)
    lay = tm.with_tiled().tiled
    np.testing.assert_array_equal(T.tiled_matmat(lay, torch.tensor(x)),
                                  T.tiled_matmat_plain(lay, torch.tensor(x)))
    np.testing.assert_allclose(tm.matmat(torch.tensor(x.T)).numpy(), ref.T,
                               rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(ref[:, :a.shape[0]],
                               (a @ x[:, :a.shape[1]].T).T, rtol=1e-12,
                               atol=1e-12 * scale)


def _bench_counts():
    """Block-row lengths of the bench LP's A and Aᵀ (see
    test_row_schedule_of_the_bench_lp)."""
    cells = np.random.default_rng(0).choice(2048 * 128, size=4096,
                                            replace=False)
    return (np.bincount(cells // 128, minlength=2048),
            np.bincount(cells % 128, minlength=128))


def _skewed_counts():
    """One block-row of 96 blocks, every fourth of the others one block,
    the rest empty (chip_smoke.py's skewed matrix)."""
    counts = np.zeros(256, np.int64)
    counts[0] = 96
    counts[1::4] = 1
    return counts


def _assert_spmm_items(table, counts, block_shape):
    """Every row of every block-row lies in exactly one item, whose blocks
    are its block-rows' blocks in ascending order; each item within its
    limits."""
    bm, bn = block_shape
    rows = min(bm, T.SPMM_ROWS)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    assert table.dtype == np.int32 and table.shape[1] == 4
    assert not table[:, 3].any()
    covered = np.zeros((counts.size, bm), np.int64)
    for r0, r1, ro, _ in table:
        assert 0 <= r0 < r1 <= counts.size and ro % rows == 0
        covered[r0:r1, ro:ro + rows] += 1
        # the item's blocks: row_ptr[r0] .. row_ptr[r1], each row's in turn
        assert np.all(np.diff(row_ptr[r0:r1 + 1]) == counts[r0:r1])
        blocks = int(counts[r0:r1].sum())
        if rows < bm:
            assert r1 - r0 == 1
        else:
            assert r1 - r0 <= T.SPMM_ITEM_ROWS
            limit = max(1, T.SPMM_ITEM_ENTRIES // (bm * bn))
            assert r1 - r0 == 1 or blocks <= limit, (r0, r1)
    np.testing.assert_array_equal(covered, 1)
    # longest first
    sizes = np.array([counts[r0:r1].sum() for r0, r1, _, _ in table])
    assert np.all(np.diff(sizes) <= 0)


@pytest.mark.parametrize("block_shape", SPMM_SHAPES,
                         ids=[f"{bm}x{bn}" for bm, bn in SPMM_SHAPES])
@pytest.mark.parametrize("which", ["pair", "bench", "skewed"])
def test_spmm_schedule_covers_every_block_once(block_shape, which):
    """The SpMM's work items (``spmm_schedule``) on the ``_spmm_pair``
    matrices, the bench LP's row lengths (A and Aᵀ) and a skewed matrix:
    coverage, order within rows, limits; the layout's table is the
    function's."""
    if which == "pair":
        _, _, tm = _spmm_pair(block_shape, seed=11, density=0.1)
        lay = tm.with_tiled().tiled
        counts = _row_lengths(lay)
        table = lay.spmm_schedule.numpy()
        np.testing.assert_array_equal(
            table, T.spmm_schedule(counts, block_shape))
        assert lay.spmm_schedule.dtype == torch.int32
        _assert_spmm_items(table, counts, block_shape)
        return
    if which == "bench":
        cases = _bench_counts()
    else:
        cases = (_skewed_counts(), np.zeros(7, np.int64))
    for counts in cases:
        table = T.spmm_schedule(counts, block_shape)
        _assert_spmm_items(table, counts, block_shape)


def test_spmm_schedule_of_the_bench_lp():
    """A (8x128): consecutive rows grouped into items of at most
    SPMM_ITEM_ENTRIES / 1024 blocks (a longer row alone); Aᵀ (128x8): four
    32-row slices of each of its 128 rows, longest rows first."""
    counts_a, counts_at = _bench_counts()
    limit = T.SPMM_ITEM_ENTRIES // (8 * 128)
    table = T.spmm_schedule(counts_a, (8, 128))
    sizes = np.array([counts_a[r0:r1].sum() for r0, r1, _, _ in table])
    assert sizes.max() == counts_a.max() and counts_a.max() > limit
    assert np.all((sizes <= limit) | (table[:, 1] - table[:, 0] == 1))
    # every block-row in one item, several rows in most
    assert 4096 / max(limit, counts_a.max()) <= len(table) < 2048
    table = T.spmm_schedule(counts_at, (128, 8))
    assert len(table) == 4 * 128
    np.testing.assert_array_equal(table[:4, 2], [0, 32, 64, 96])
    assert counts_at[table[0, 0]] == counts_at.max()


def test_spmm_schedule_is_a_function_of_row_lengths():
    """Two matrices with the same block-row lengths but other columns and
    values get the same table; so does a second layout of one matrix."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 12, 200)
    mats = []
    for seed in (1, 2):
        g = np.random.default_rng(seed)
        rows = np.repeat(np.arange(counts.size), counts)
        cols = np.concatenate([g.choice(40, c, replace=False)
                               for c in counts])
        data = torch.tensor(g.standard_normal((rows.size, 8, 32)))
        mats.append(T.make_layout(
            data, torch.tensor(rows, dtype=torch.int32),
            torch.tensor(cols, dtype=torch.int32), (counts.size * 8, 40 * 32)))
    assert torch.equal(mats[0].spmm_schedule, mats[1].spmm_schedule)
    np.testing.assert_array_equal(mats[0].spmm_schedule.numpy(),
                                  T.spmm_schedule(counts, (8, 32)))
    # the limits follow the block shape, not the matrix's dtype or values
    assert np.array_equal(T.spmm_schedule(counts, (8, 32)),
                          T.spmm_schedule(counts.copy(), (8, 32)))


@pytest.mark.parametrize("block_shape", [(8, 128), (128, 8), (32, 32)])
def test_batched_matvec_is_the_rows_products(block_shape):
    """``matvec`` of a [B, N] input is, row for row, the 1-D product of
    each row (the plain versions sum in the same order)."""
    _, _, tm = _spmm_pair(block_shape, seed=7, density=0.1)
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (5, tm.padded_shape[1])))
    for mat in (tm, tm.with_tiled()):
        y = mat.matvec(x)
        for b in range(5):
            assert torch.equal(y[b], mat.matvec(x[b]))


def test_batched_padding_helpers_work_on_the_last_axis():
    _, _, tm = _spmm_pair((8, 128), seed=2, shape=(250, 300))
    assert tm.padded_shape == (256, 384)
    x = tm.pad_x(np.ones((3, 300)), value=2.0)
    assert x.shape == (3, 384) and float(x[1, 299]) == 1.0
    assert float(x[1, 300]) == 2.0
    y = tm.pad_y(np.ones((3, 250)), value=-1.0)
    assert y.shape == (3, 256) and float(y[2, 250]) == -1.0
    assert tm.unpad_y(y).shape == (3, 250)
    assert tm.unpad_x(x).shape == (3, 300)
    assert tm.matvec(x).shape == (3, 256)


def test_spmm_counter_untouched_on_cpu():
    _, _, tm = _spmm_pair((8, 128), seed=3)
    before = T.launch_counts()
    tm.with_tiled().matvec(torch.ones(4, tm.padded_shape[1],
                                      dtype=torch.float64))
    assert T.launch_counts() == before and len(before) == 5


# ---------------------------------------------------------------------------
# The row layout (make_row_layout) and its plain product
# ---------------------------------------------------------------------------


def _flow_matrix():
    """A multicommodity flow matrix of the benchmark's shape, small: every
    column holds 3 nonzeros (tail, head, capacity), the conservation rows
    about 47 and the 141 capacity rows 130, longer than a 32-lane team's
    pass of 128."""
    from ortools_tpu_torch.models.generators import multicommodity_flow_lp

    return multicommodity_flow_lp(6, 141, 130, seed=0).constraint_matrix


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("transpose", [False, True])
def test_row_product_matches_scipy_and_the_blocks(dtype, tol, transpose):
    """A and Aᵀ of the flow matrix: ``matvec`` takes the row layout once
    attached, and agrees with scipy and with the block product."""
    a = _flow_matrix()
    assert np.all(np.diff(a.tocsc().indptr) == 3)
    lengths = np.diff(a.indptr)
    assert np.median(lengths) == 47 and lengths.max() == 130
    mat = TMatrix.from_scipy(a, dtype=dtype, device="cpu")
    if transpose:
        mat, a = mat.block_transpose(), a.T.tocsr()
    mat = mat.with_tiled().with_rows(a)
    x = np.random.default_rng(2).standard_normal(mat.padded_shape[1])
    xt = torch.tensor(x, dtype=dtype)
    y = mat.matvec(xt)
    np.testing.assert_array_equal(y.numpy(),
                                  T.rows_matvec_plain(mat.rows, xt).numpy())
    blocks = T.tiled_matvec_plain(mat.tiled, xt).double().numpy()
    ref = a @ xt.double().numpy()[:a.shape[1]]
    scale = 1 + np.abs(ref).max()
    assert np.abs(y.double().numpy()[:a.shape[0]] - ref).max() <= tol * scale
    assert np.abs(y.double().numpy() - blocks).max() <= tol * scale
    assert not y[a.shape[0]:].any()


def _skewed_rows(seed=5):
    """400 x 1000: rows of 900, 129 and 128 nonzeros, 297 of 0-69 and 100
    empty (chip_smoke.py's)."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([[900, 129, 128], rng.integers(0, 70, 297),
                              np.zeros(100, np.int64)])
    rows = np.repeat(np.arange(lengths.size), lengths)
    cols = np.concatenate([rng.choice(1000, k, replace=False)
                           for k in lengths])
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(lengths.size, 1000))


ROW_EDGES = {
    "skewed": _skewed_rows,
    "skewed^T": lambda: _skewed_rows().T.tocsr(),
    "one row": lambda: sp.random(1, 1000, density=0.9, random_state=1,
                                 format="csr"),
    "one column": lambda: sp.random(1000, 1, density=0.9, random_state=2,
                                    format="csr"),
    "empty": lambda: sp.csr_matrix((50, 60)),
}


@pytest.mark.parametrize("case", list(ROW_EDGES))
def test_row_layout_edges(case):
    """Empty rows, padded rows and columns, rows longer than a team's
    pass, one-row, one-column and empty matrices: the layout lists every
    padded row once, in its bin, and the plain product is scipy's."""
    a = ROW_EDGES[case]()
    mat = TMatrix.from_scipy(a, dtype=torch.float64, device="cpu")
    lay = mat.with_rows(a).rows
    m_pad, n_pad = mat.padded_shape
    assert lay.num_rows == m_pad and lay.num_cols == n_pad
    assert lay.nnz == a.nnz and lay.values.dtype == torch.float64
    order = lay.order.numpy()
    assert lay.order.dtype == lay.row_ptr.dtype == lay.cols.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(m_pad))
    # stored bin by bin, each the matrix row order[i] with its nonzeros
    lengths = np.diff(lay.row_ptr.numpy())
    np.testing.assert_array_equal(lengths[order < a.shape[0]],
                                  np.diff(a.indptr)[order[order < a.shape[0]]])
    assert not lengths[order >= a.shape[0]].any()
    # widest teams first: each row's team is the fewest lanes that leave
    # each at most ROW_LANE_NNZ nonzeros, 32 at most
    lanes = np.repeat(T.ROW_LANES, lay.bin_rows)
    need = -(-lengths // T.ROW_LANE_NNZ)
    assert np.all((need <= lanes) | (lanes == 32))
    assert np.all((need > lanes // 2) | (lanes == 1))
    assert sum(lay.bin_rows) == m_pad
    x = np.random.default_rng(3).standard_normal(n_pad)
    y = T.rows_matvec(lay, torch.tensor(x)).numpy()
    np.testing.assert_allclose(y[:a.shape[0]], a @ x[:a.shape[1]],
                               rtol=1e-12, atol=1e-12)
    assert not y[a.shape[0]:].any()
    # the layout read back from the blocks is the same
    again = mat.with_rows().rows
    for name in ("row_ptr", "cols", "values", "order"):
        assert torch.equal(getattr(lay, name), getattr(again, name)), name


@pytest.mark.parametrize("lengths,order,bin_rows", [
    # 400 nonzeros: a warp; 47: 12 lanes at 4 -> 16; 3 and empty: one lane
    ([3, 47, 400, 0, 47], [2, 1, 4, 0, 3], (1, 2, 0, 0, 0, 2)),
    # the edges of each bin, 4 a lane: a warp past 64 nonzeros, each bin
    # in row order
    ([4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129],
     [9, 10, 11, 7, 8, 5, 6, 3, 4, 1, 2, 0], (3, 2, 2, 2, 2, 1)),
    ([], [], (0, 0, 0, 0, 0, 0)),
])
def test_row_bins_give_each_row_its_team(lengths, order, bin_rows):
    got_order, got_bins = T.row_bins(np.array(lengths, dtype=np.int64))
    np.testing.assert_array_equal(got_order, order)
    assert got_order.dtype == np.int32 and got_bins == bin_rows


def test_prefer_rows_at_half_the_block_bytes():
    # 1 block of 8x128 f64 is 8192 bytes; half of it is 4096
    rows = 8
    fits = (4096 - 4 * (rows + 1)) // 12
    assert T.prefer_rows(fits, rows, 1, (8, 128), 8)
    assert not T.prefer_rows(fits + 1, rows, 1, (8, 128), 8)


def _built(qp, dtype, block_shape=None):
    from ortools_tpu_torch.pdlp import PdhgParams
    from ortools_tpu_torch.pdlp import solver as S
    from ortools_tpu_torch.utils import tracing

    before = tracing.counters().get("row_layouts", 0)
    prob = S.build_device_problem(
        qp, PdhgParams(dtype=dtype, use_tiled_spmv=True,
                       block_shape=block_shape), "cpu")
    return prob, tracing.counters().get("row_layouts", 0) - before


@pytest.mark.parametrize("case", ["flow f64", "flow f32", "bench blocks",
                                  "density 0.5"])
def test_route_rule_attaches_rows_to_low_fill_matrices(case):
    """Set-up attaches the row layout to A and Aᵀ of the low-fill flow LP
    (counted twice as ``row_layouts``; no bf16 copy, so the fast stream
    is the exact product) and to neither of a bench-shaped LP of full
    8x128 blocks or a density-0.5 LP; the block layout is always there."""
    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.models.generators import multicommodity_flow_lp
    from ortools_tpu_torch.models.lp import random_lp

    dtype = torch.float32 if case != "flow f64" else torch.float64
    if case.startswith("flow"):
        qp = multicommodity_flow_lp(6, 141, 130, seed=0)
    elif case == "bench blocks":
        qp = block_random_lp(1024, 1024, 64, (8, 128), seed=0)
    else:
        qp = random_lp(256, 256, density=0.5, seed=11)
    # the bench and the density-0.5 tests give the block shape
    prob, row_layouts = _built(qp, dtype, None if case.startswith("flow")
                               else (8, 128))
    rows = case.startswith("flow")
    assert row_layouts == (2 if rows else 0)
    for mat in (prob.a, prob.at):
        assert mat.tiled is not None
        assert (mat.rows is not None) == rows
        if rows:
            assert mat.rows.values.dtype == dtype
            assert not mat.has_fast_stream
            x = torch.ones(mat.padded_shape[1], dtype=dtype)
            assert torch.equal(mat.matvec_fast(x), mat.matvec(x))
            assert torch.equal(mat.matvec(x),
                               T.rows_matvec_plain(mat.rows, x))
    if case == "flow f64":
        a = qp.constraint_matrix
        assert prob.a.rows.nnz == prob.at.rows.nnz == a.nnz


def test_row_launch_counter_untouched_on_cpu():
    a = _skewed_rows()
    lay = TMatrix.from_scipy(a, dtype=torch.float64,
                             device="cpu").with_rows(a).rows
    before = T.launch_counts()
    T.rows_matvec(lay, torch.ones(lay.num_cols, dtype=torch.float64))
    assert T.launch_counts() == before and T.rows_matvec.launches == before[3]


# ---------------------------------------------------------------------------
# The batched product over the row layout (rows_matmat) and its rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("case", list(ROW_EDGES))
def test_batched_row_product_matches_blocks_and_numpy(case, dtype, tol,
                                                      batch):
    """The plain batched row product ([B, N] -> [B, M]) against the plain
    block SpMM and a dense NumPy product, on empty and padded rows, a long
    row, one-row, one-column and empty matrices; the padded rows are
    zeros."""
    a = ROW_EDGES[case]()
    mat = TMatrix.from_scipy(a, dtype=dtype, device="cpu").with_rows(a)
    x = np.random.default_rng(batch).standard_normal(
        (batch, mat.padded_shape[1]))
    xt = torch.tensor(x, dtype=dtype)
    y = T.rows_matmat(mat.rows, xt)
    assert y.shape == (batch, mat.padded_shape[0]) and y.dtype == dtype
    assert torch.equal(y, T.rows_matmat_plain(mat.rows, xt))
    blocks = T.block_product_batched(
        mat.data, mat.block_rows, mat.block_cols, xt,
        mat.padded_shape[0] // mat.block_shape[0])
    ref = x[:, :a.shape[1]] @ a.toarray().T
    scale = 1 + np.abs(ref).max(initial=0.0)
    got = y.double().numpy()
    assert np.abs(got[:, :a.shape[0]] - ref).max(initial=0.0) <= tol * scale
    assert np.abs(got - blocks.double().numpy()).max(initial=0.0) <= (
        tol * scale)
    assert not y[:, a.shape[0]:].any()


# (nnz, rows of the row layout, blocks, block shape, value bytes, batch):
# the benchmark's node-LP relaxation (class C 30,520,100, f32, B = 64) at
# 8x128 (A) and 128x8 (Aᵀ), 1.17% full, and bench_torch's LP of dense
# 8x128 blocks (16384², 4,096 blocks) and its block transpose.
BATCHED_RULE_CASES = {
    "relaxation A": ((260520, 55552, 21727, (8, 128), 4, 64), True),
    "relaxation A^T": ((260520, 52608, 21727, (128, 8), 4, 64), True),
    "dense blocks A": ((4194304, 16384, 4096, (8, 128), 4, 64), False),
    "dense blocks A^T": ((4194304, 16384, 4096, (128, 8), 4, 64), False),
}


@pytest.mark.parametrize("case", list(BATCHED_RULE_CASES))
def test_batched_rule_on_the_census_shapes(case):
    args, rows = BATCHED_RULE_CASES[case]
    assert T.prefer_rows_batched(*args) == rows


def test_batched_rule_counts_the_gathers():
    """One 8x128 f32 block at B = 8: the blocks move 1024 entries and 8
    instances of one 128-entry segment; the rows 8 bytes a nonzero, its
    column for each instance and the row pointers."""
    blocks = 128 * (8 + 8) * 4
    rows = 8
    fits = int((T.ROWS_BATCHED_SHARE * blocks - 4 * (rows + 1))
               // (4 + 4 + 8 * 4))
    assert T.prefer_rows_batched(fits, rows, 1, (8, 128), 4, 8)
    assert not T.prefer_rows_batched(fits + 1, rows, 1, (8, 128), 4, 8)


@pytest.mark.parametrize("case", ["rows", "blocks", "no rows"])
def test_batched_matvec_takes_the_layout_the_rule_gives(case):
    """``matvec`` of [B, N] takes the batched row product where the row
    layout is attached and the rule says so, the block SpMM otherwise."""
    a = _flow_matrix() if case != "blocks" else sp.csr_matrix(
        np.random.default_rng(4).standard_normal((64, 256)))
    mat = TMatrix.from_scipy(a, dtype=torch.float64,
                             device="cpu").with_tiled()
    if case != "no rows":
        mat = mat.with_rows(a)
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (4, mat.padded_shape[1])))
    takes_rows = case == "rows"
    if mat.rows is not None:
        assert T.prefer_rows_batched(
            mat.rows.nnz, mat.rows.num_rows, mat.num_blocks,
            mat.block_shape, 8, 4) == takes_rows
    want = (T.rows_matmat_plain(mat.rows, x) if takes_rows
            else T.tiled_matmat_plain(mat.tiled, x))
    assert torch.equal(mat.matvec(x), want)
    # matmat ([N, k]) runs as matvec(X.T)
    assert torch.equal(mat.matmat(x.t().contiguous()), want.t())


def test_batched_row_launch_counter_untouched_on_cpu():
    a = _skewed_rows()
    lay = TMatrix.from_scipy(a, dtype=torch.float64,
                             device="cpu").with_rows(a).rows
    before = T.launch_counts()
    T.rows_matmat(lay, torch.ones(3, lay.num_cols, dtype=torch.float64))
    assert T.launch_counts() == before and T.rows_matmat.launches == before[4]


def test_batched_row_product_checks_its_input():
    a = _skewed_rows()
    lay = TMatrix.from_scipy(a, dtype=torch.float64,
                             device="cpu").with_rows(a).rows
    n = lay.num_cols
    with pytest.raises(ValueError, match=f"\\[B, {n}\\]"):
        T._check_rows(lay, torch.ones(n, dtype=torch.float64), batched=True)
    with pytest.raises(TypeError):
        T._check_rows(lay, torch.ones(2, n), batched=True)
    with pytest.raises(ValueError, match="contiguous"):
        T._check_rows(lay, torch.ones(n, 2, dtype=torch.float64).t(),
                      batched=True)
