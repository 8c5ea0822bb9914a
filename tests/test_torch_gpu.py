"""The port's CUDA kernels against their plain versions, and the solves
that run them, on the card.

Every test here is marked ``gpu`` and skips where no card is present; the
decision is made inside the ``cuda`` fixture, never at import.  The module
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu_torch.ops import tiled_spmv as T
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix as TMatrix


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# With the transposes, every block shape the kernels take; "skewed" is one
# block-row of 96 blocks (a long row, one thread block's), a quarter of
# the others with one block (short rows) and the rest empty.
GPU_SHAPES = [
    (2048, 2048, 256, (8, 128)),
    (2048, 2048, 128, (32, 128)),
    (2048, 2048, 64, (128, 128)),
    (2048, 2048, 4096, (8, 8)),
    (2048, 2048, 1024, (8, 32)),
    (2048, 2048, 1024, (32, 8)),
    (2048, 2048, 512, (32, 32)),
    (2048, 16384, "skewed", (8, 128)),
]


def _cells(rng, gm, gn, nblocks):
    if nblocks != "skewed":
        return rng.choice(gm * gn, size=nblocks, replace=False)
    rows = np.arange(1, gm, 4)
    return np.concatenate([rng.choice(gn, 96, replace=False),
                           rows * gn + rng.integers(0, gn, rows.size)])


def _gpu_pair(m, n, nblocks, block_shape, dtype, device):
    rng = np.random.default_rng(m + (nblocks if nblocks != "skewed" else 1))
    bm, bn = block_shape
    gm, gn = m // bm, n // bn
    cells = _cells(rng, gm, gn, nblocks)
    rows = (cells // gn)[:, None, None] * bm + np.arange(bm)[None, :, None]
    cols = (cells % gn)[:, None, None] * bn + np.arange(bn)[None, None, :]
    rows, cols = np.broadcast_arrays(rows, cols)
    a = sp.csr_matrix((rng.standard_normal(rows.size), (rows.ravel(),
                                                        cols.ravel())),
                      shape=(m, n))
    mat = TMatrix.from_scipy(a, block_shape=block_shape, dtype=dtype,
                             device=device)
    return mat


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,nblocks,block_shape", GPU_SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
def test_kernels_match_plain_on_card(cuda, m, n, nblocks, block_shape,
                                     transpose):
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        mat = _gpu_pair(m, n, nblocks, block_shape, dtype, cuda)
        if transpose:
            mat = mat.block_transpose()
        mat = mat.with_tiled(hi=dtype == torch.float32)
        g = torch.Generator(device="cpu").manual_seed(0)
        x = torch.randn(mat.padded_shape[1], generator=g,
                        dtype=torch.float64).to(dtype=dtype, device=cuda)
        y = T.tiled_matvec(mat.tiled, x)
        y2 = T.tiled_matvec(mat.tiled, x)
        ref = T.tiled_matvec_plain(mat.tiled, x)
        torch.cuda.synchronize()
        scale = 1 + float(ref.abs().max())
        assert float((y - ref).abs().max()) <= tol * scale
        assert torch.equal(y, y2)
        if dtype == torch.float32:
            f = T.tiled_matvec_fast(mat.tiled, x)
            f2 = T.tiled_matvec_fast(mat.tiled, x)
            fref = T.tiled_matvec_fast_plain(mat.tiled, x)
            assert float((f - fref).abs().max()) <= 1e-5 * scale
            assert float((f - ref).abs().max()) <= 3e-2 * scale
            assert not torch.equal(f, y)
            assert torch.equal(f, f2)


@pytest.mark.gpu
def test_kernels_on_empty_matrix_on_card(cuda):
    mat = TMatrix.from_scipy(sp.csr_matrix((50, 60)), device=cuda)
    for m in (mat.with_tiled(hi=True), mat.block_transpose().with_tiled(hi=True)):
        x = torch.ones(m.padded_shape[1], device=cuda)
        assert float(T.tiled_matvec(m.tiled, x).abs().max()) == 0.0
        assert float(T.tiled_matvec_fast(m.tiled, x).abs().max()) == 0.0


@pytest.mark.gpu
def test_solve_on_card_uses_both_kernels(cuda):
    from ortools_tpu_torch.models.lp import random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.utils.status import TerminationReason

    T.tiled_matvec.launches = T.tiled_matvec_fast.launches = 0
    r = solve(random_lp(256, 256, density=0.5, seed=11),
              PdhgParams(block_shape=(8, 128), iteration_limit=20000))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert T.tiled_matvec.launches > 0 and T.tiled_matvec_fast.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("lp", ["random", "flow", "dense"])
def test_f64_solve_on_card_uses_the_exact_kernel(cuda, lp):
    """f64 LPs to OPTIMAL at eps 1e-8 with the objective of the port's CPU
    f64 solve, each through the exact kernel its layout rule gives.  Low
    fill (a random LP in one 128x128 block of 720 nonzeros, a
    multicommodity flow LP): set-up gives A and Aᵀ the row layout
    (``row_layouts`` counts 2), and every 1-D product runs the row kernel
    and none the block kernels.  A dense LP at 8x128 blocks (half its
    entries nonzero) keeps its blocks: every 1-D product runs
    ``block_spmv_exact``, none the row kernel, and no row layout is
    made."""
    from ortools_tpu_torch.models.generators import multicommodity_flow_lp
    from ortools_tpu_torch.models.lp import random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.utils import tracing
    from ortools_tpu_torch.utils.status import TerminationReason

    qp = {"random": lambda: random_lp(60, 40, density=0.3, seed=3),
          "flow": lambda: multicommodity_flow_lp(12, 40, 4, seed=3),
          "dense": lambda: random_lp(256, 256, density=0.5, seed=11)}[lp]()
    params = PdhgParams(dtype=torch.float64, eps_optimal_absolute=1e-8,
                        eps_optimal_relative=1e-8,
                        **({"block_shape": (8, 128)} if lp == "dense"
                           else {}))
    before = T.launch_counts()
    layouts = tracing.counters().get("row_layouts", 0)
    r = solve(qp, params)
    torch.cuda.synchronize()
    exact, fast, spmm, rows, rows_spmm = (a - b for a, b in
                                          zip(T.launch_counts(), before))
    made = tracing.counters().get("row_layouts", 0) - layouts
    if lp == "dense":
        assert made == 0
        assert exact > 0 and rows == fast == spmm == rows_spmm == 0
    else:
        assert made == 2
        assert rows > 0 and exact == fast == spmm == rows_spmm == 0
    assert r.termination_reason == TerminationReason.OPTIMAL
    cpu = solve(qp, params, device="cpu")
    assert cpu.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - cpu.primal_objective) <= 1e-6 * (
        1 + abs(cpu.primal_objective))


@pytest.mark.gpu
def test_misaligned_input_raises_on_card(cuda):
    mat = _gpu_pair(2048, 2048, 256, (8, 128), torch.float32, cuda)
    mat = mat.with_tiled(hi=True)
    n = mat.padded_shape[1]
    x = torch.ones(n + 1, device=cuda)[1:]  # 4 bytes past an aligned start
    for fn in (T.tiled_matvec, T.tiled_matvec_fast):
        before = fn.launches
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(mat.tiled, x)
        assert fn.launches == before


# ---------------------------------------------------------------------------
# The row kernel
# ---------------------------------------------------------------------------


def _flow_matrix(transpose):
    """The benchmark's flow LP shape at 200 commodities: columns of 3
    nonzeros, conservation rows of about 47, capacity rows of 200; or its
    transpose (rows of 3)."""
    from ortools_tpu_torch.models.generators import multicommodity_flow_lp

    a = multicommodity_flow_lp(30, 700, 200, seed=0).constraint_matrix
    return a.T.tocsr() if transpose else a


def _skewed_rows():
    """400 x 1000: rows of 900, 129 and 128 nonzeros, 297 of 0-69 and 100
    empty (chip_smoke.py's)."""
    rng = np.random.default_rng(5)
    lengths = np.concatenate([[900, 129, 128], rng.integers(0, 70, 297),
                              np.zeros(100, np.int64)])
    rows = np.repeat(np.arange(lengths.size), lengths)
    cols = np.concatenate([rng.choice(1000, k, replace=False)
                           for k in lengths])
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(lengths.size, 1000))


ROW_CASES = {
    "flow A": lambda: _flow_matrix(False),
    "flow A^T": lambda: _flow_matrix(True),
    "skewed": _skewed_rows,
    "skewed^T": lambda: _skewed_rows().T.tocsr(),
    "one row": lambda: sp.random(1, 1000, density=0.9, random_state=1,
                                 format="csr"),
    "one column": lambda: sp.random(1000, 1, density=0.9, random_state=2,
                                    format="csr"),
    "empty": lambda: sp.csr_matrix((50, 60)),
}


def _row_pair(a, dtype, device):
    mat = TMatrix.from_scipy(a, dtype=dtype, device=device)
    return mat.with_tiled().with_rows(a)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ROW_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_row_kernel_matches_plain_on_card(cuda, case, dtype, tol):
    """The row kernel against its plain version and the block kernel, on
    teams of every width, empty and padded rows, rows longer than a
    team's pass, one-row, one-column and empty matrices; a repeated
    launch is bit-identical and each launch is counted."""
    a = ROW_CASES[case]()
    mat = _row_pair(a, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(mat.padded_shape[1], generator=g,
                    dtype=torch.float64).to(dtype=dtype, device=cuda)
    before = T.rows_matvec.launches
    y = mat.matvec(x)
    y2 = T.rows_matvec(mat.rows, x)
    ref = T.rows_matvec_plain(mat.rows, x)
    blk = T.tiled_matvec(mat.tiled, x)
    torch.cuda.synchronize()
    assert T.rows_matvec.launches == before + 2
    scale = 1 + float(ref.abs().max())
    assert float((y - ref).abs().max()) <= tol * scale
    assert float((y - blk).abs().max()) <= tol * scale
    assert torch.equal(y, y2)
    assert not y[a.shape[0]:].any()


@pytest.mark.gpu
def test_row_kernel_bad_input_raises_on_card(cuda):
    mat = _row_pair(_skewed_rows(), torch.float32, cuda)
    before = T.rows_matvec.launches
    n = mat.padded_shape[1]
    with pytest.raises(TypeError):
        T.rows_matvec(mat.rows, torch.ones(n, device=cuda,
                                           dtype=torch.float64))
    with pytest.raises(ValueError, match=f"length-{n}"):
        T.rows_matvec(mat.rows, torch.ones(n + 1, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        T.rows_matvec(mat.rows, torch.ones(2 * n, device=cuda)[::2])
    assert T.rows_matvec.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_kernel_in_a_graph_is_bit_identical_on_card(cuda, dtype):
    """A captured launch of the row kernel replays the eager launch bit
    for bit, replay after replay, for A and Aᵀ."""
    for transpose in (False, True):
        mat = _row_pair(_flow_matrix(transpose), dtype, cuda)
        g = torch.Generator(device="cpu").manual_seed(1)
        x = torch.randn(mat.padded_shape[1], generator=g,
                        dtype=torch.float64).to(dtype=dtype, device=cuda)
        eager = T.rows_matvec(mat.rows, x)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            T.rows_matvec(mat.rows, x)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = T.rows_matvec(mat.rows, x)
        for _ in range(3):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


# ---------------------------------------------------------------------------
# The batched row kernel
# ---------------------------------------------------------------------------


def _census_rows(seed=6):
    """3,000 columns and the node LP relaxation's row lengths: 300 rows of
    2 nonzeros, 300 of 4, 40 of 26-42, 20 of 101 (longer than a pass of
    32) and 10 empty, shuffled."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([np.full(300, 2), np.full(300, 4),
                              rng.integers(26, 43, 40), np.full(20, 101),
                              np.zeros(10, np.int64)])
    lengths = rng.permutation(lengths)
    rows = np.repeat(np.arange(lengths.size), lengths)
    cols = np.concatenate([rng.choice(3000, k, replace=False)
                           for k in lengths])
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(lengths.size, 3000))


ROWS_SPMM_CASES = {**ROW_CASES,
                   "census": _census_rows,
                   "census^T": lambda: _census_rows().T.tocsr(),
                   "random": lambda: sp.random(900, 2500, density=0.004,
                                               random_state=3,
                                               format="csr")}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ROWS_SPMM_CASES))
@pytest.mark.parametrize("batch", [1, 8, 64, 70])
def test_batched_row_kernel_matches_plain_on_card(cuda, case, batch):
    """Y = X Aᵀ over the row layout against its plain version, within
    1e-5·(1+‖Y‖∞) in f32 and 1e-12 in f64, on rows of 2, 4, 26-42 and 101
    nonzeros, empty and padded rows, one-row, one-column and empty
    matrices; every padded row is written (zeros); a repeated launch is
    bit-identical and each launch is counted.  B = 70 takes two tiles of
    64 instances."""
    a = ROWS_SPMM_CASES[case]()
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        mat = _row_pair(a, dtype, cuda)
        g = torch.Generator(device="cpu").manual_seed(batch)
        x = torch.randn(batch, mat.padded_shape[1], generator=g,
                        dtype=torch.float64).to(dtype=dtype, device=cuda)
        before = T.rows_matmat.launches
        y = T.rows_matmat(mat.rows, x)
        y2 = T.rows_matmat(mat.rows, x)
        ref = T.rows_matmat_plain(mat.rows, x)
        torch.cuda.synchronize()
        assert T.rows_matmat.launches == before + 2
        assert y.shape == (batch, mat.padded_shape[0]) and y.dtype == dtype
        scale = 1 + float(ref.abs().max())
        assert float((y - ref).abs().max()) <= tol * scale
        assert torch.equal(y, y2)
        assert not y[:, a.shape[0]:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_row_kernel_in_a_graph_on_card(cuda, dtype):
    """A captured launch of the batched row kernel replays the eager one
    bit for bit, replay after replay, and each replay adds the launch it
    captured to the counters, as the solver's majors count them."""
    for a in (_census_rows(), _census_rows().T.tocsr()):
        mat = _row_pair(a, dtype, cuda)
        g = torch.Generator(device="cpu").manual_seed(2)
        x = torch.randn(64, mat.padded_shape[1], generator=g,
                        dtype=torch.float64).to(dtype=dtype, device=cuda)
        eager = T.rows_matmat(mat.rows, x)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            T.rows_matmat(mat.rows, x)
        torch.cuda.current_stream().wait_stream(stream)
        before = T.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = T.rows_matmat(mat.rows, x)
        launches = tuple(a - b for a, b in zip(T.launch_counts(), before))
        assert launches == (0, 0, 0, 0, 1)
        T.count_launches(*(-n for n in launches))
        for k in range(3):
            out.zero_()
            graph.replay()
            T.count_launches(*launches)
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
            assert T.launch_counts()[4] == before[4] + k + 1


@pytest.mark.gpu
def test_batched_row_kernel_bad_input_raises_on_card(cuda):
    mat = _row_pair(_census_rows(), torch.float32, cuda)
    before = T.rows_matmat.launches
    n = mat.padded_shape[1]
    with pytest.raises(TypeError):
        T.rows_matmat(mat.rows, torch.ones(2, n, device=cuda,
                                           dtype=torch.float64))
    with pytest.raises(ValueError, match=rf"\[B, {n}\]"):
        T.rows_matmat(mat.rows, torch.ones(n, device=cuda))
    with pytest.raises(ValueError, match=rf"\[B, {n}\]"):
        T.rows_matmat(mat.rows, torch.ones(2, n + 1, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        T.rows_matmat(mat.rows, torch.ones(n, 2, device=cuda).t())
    with pytest.raises(ValueError, match="is on cpu"):
        T.rows_matmat(mat.rows._replace(cols=mat.rows.cols.cpu()),
                      torch.ones(2, n, device=cuda))
    assert T.rows_matmat.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("lp", ["flow", "dense blocks"])
def test_batched_products_take_the_layout_the_rule_gives_on_card(cuda, lp):
    """Set-up's matrices on the card: the low-fill flow LP's batched
    products go to the batched row kernel, one launch a product and no
    block SpMM; an LP of dense 8x128 blocks (bench_torch's kind) gets no
    row layout and keeps the block SpMM."""
    from ortools_tpu_torch.models.generators import (block_random_lp,
                                                     multicommodity_flow_lp)
    from ortools_tpu_torch.pdlp import PdhgParams
    from ortools_tpu_torch.pdlp import solver as S

    if lp == "flow":
        qp = multicommodity_flow_lp(30, 520, 100, seed=0)
        params = PdhgParams(dtype=torch.float32)
    else:
        qp = block_random_lp(4096, 4096, 256, (8, 128), seed=0)
        params = PdhgParams(dtype=torch.float32, block_shape=(8, 128))
    prob = S.build_device_problem(qp, params, cuda)
    for mat in (prob.a, prob.at):
        assert (mat.rows is not None) == (lp == "flow")
        x = torch.ones(64, mat.padded_shape[1], device=cuda)
        before = T.launch_counts()
        y = mat.matvec(x)
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(T.launch_counts(), before))
        if lp == "flow":
            assert launches == (0, 0, 0, 0, 1)
            ref = T.rows_matmat_plain(mat.rows, x)
        else:
            assert launches == (0, 0, 1, 0, 0)
            ref = T.tiled_matmat_plain(mat.tiled, x)
        scale = 1 + float(ref.abs().max())
        assert float((y - ref).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# The block SpMM
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,nblocks,block_shape", GPU_SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("batch", [1, 8, 40, 64])
def test_spmm_kernel_matches_plain_on_card(cuda, m, n, nblocks, block_shape,
                                           transpose, batch):
    """Y = X Aᵀ for X [B, N]: within 1e-5·(1+‖Y‖∞) of the plain version
    in f32 and 1e-12 in f64; a repeated launch is bit-identical; B = 1, 8
    and 40 fill part of the kernel's tile of 64 instances, B = 64 (the
    bench's batch) all of it."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        mat = _gpu_pair(m, n, nblocks, block_shape, dtype, cuda)
        if transpose:
            mat = mat.block_transpose()
        lay = mat.with_tiled().tiled
        g = torch.Generator(device="cpu").manual_seed(batch)
        x = torch.randn(batch, mat.padded_shape[1], generator=g,
                        dtype=torch.float64).to(dtype=dtype, device=cuda)
        before = T.tiled_matmat.launches
        y = T.tiled_matmat(lay, x)
        y2 = T.tiled_matmat(lay, x)
        ref = T.tiled_matmat_plain(lay, x)
        torch.cuda.synchronize()
        assert T.tiled_matmat.launches == before + 2
        assert y.shape == (batch, mat.padded_shape[0])
        scale = 1 + float(ref.abs().max())
        assert float((y - ref).abs().max()) <= tol * scale
        assert torch.equal(y, y2)
        # row b is the product of row b
        b = batch - 1
        ref_b = T.tiled_matvec_plain(lay, x[b].contiguous())
        assert float((y[b] - ref_b).abs().max()) <= tol * scale


@pytest.mark.gpu
def test_spmm_kernel_on_empty_matrix_and_bad_input_on_card(cuda):
    mat = TMatrix.from_scipy(sp.csr_matrix((50, 60)), device=cuda)
    for m in (mat.with_tiled(), mat.block_transpose().with_tiled()):
        x = torch.ones(3, m.padded_shape[1], device=cuda)
        assert float(T.tiled_matmat(m.tiled, x).abs().max()) == 0.0
    lay = mat.with_tiled().tiled
    before = T.tiled_matmat.launches
    with pytest.raises(ValueError, match=r"\[B, 128\]"):
        T.tiled_matmat(lay, torch.ones(128, device=cuda))
    with pytest.raises(TypeError):
        T.tiled_matmat(lay, torch.ones(2, 128, device=cuda,
                                       dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        T.tiled_matmat(lay, torch.ones(128, 2, device=cuda).t())
    assert T.tiled_matmat.launches == before


# ---------------------------------------------------------------------------
# Majors as CUDA graphs
# ---------------------------------------------------------------------------


def _moderate_start(cuda, step_scale=1.0, **kw):
    """The 2048^2 block LP (f32, 8x128 blocks, with the bf16 copy) on the
    card and its initial state; ``step_scale`` enlarges the first step so
    that attempts are rejected."""
    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.pdlp import PdhgParams
    from ortools_tpu_torch.pdlp import solver as S

    params = PdhgParams(block_shape=(8, 128), **kw)
    qp = block_random_lp(2048, 2048, 512, (8, 128), seed=0)
    prob = S.build_device_problem(qp, params, cuda)
    g = torch.Generator(device="cpu").manual_seed(0)
    v0 = torch.randn(prob.c.shape[0], generator=g,
                     dtype=torch.float64).to(prob.c)
    state = S._make_initial_state(params)(
        prob, S._make_power_iter(params)(prob, v0))
    return S, params, prob, state._replace(
        step_size=state.step_size * step_scale)


def _run_majors(S, params, prob, state, graphs, streams):
    majors = S._Majors(prob, params)
    majors.use_graphs = graphs  # False: the same slots, run eagerly
    majors.load(state)
    hosts = []
    S.host_syncs = 0
    for fast in streams:  # capture (graphs) or warm-up, then counted
        majors.major(fast)
    before = T.launch_counts()
    for fast in streams:
        hosts.append(majors.major(fast)[1])
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(T.launch_counts(), before))
    return majors.snapshot(), hosts, launches, S.host_syncs


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["adaptive", "malitsky_pock"])
@pytest.mark.parametrize("step_scale", [1.0, 30.0])
def test_graph_majors_equal_eager_slots_on_card(cuda, rule, step_scale):
    """A replayed major is the eagerly run slot sequence bit for bit, in
    both streams, with and without rejected attempts; each replay adds the
    launches it captured to the counters."""
    S, params, prob, state = _moderate_start(cuda, step_scale,
                                             linesearch_rule=rule)
    streams = (True, False)
    g_state, g_hosts, g_launches, g_syncs = _run_majors(
        S, params, prob, state, True, streams)
    e_state, e_hosts, e_launches, _ = _run_majors(
        S, params, prob, state, False, streams)
    for name, a, b in zip(S.PdhgState._fields, g_state, e_state):
        assert torch.equal(a, b), name
    assert g_hosts == e_hosts
    # (exact, fast, SpMM): one instance runs no SpMM
    assert g_launches == e_launches and min(g_launches[:2]) > 0
    assert g_launches[2] == 0
    if step_scale > 1.0:
        assert int(g_state.num_steps) > int(g_state.num_accepted)
    # four majors: one read each, and one more per round of tail slots
    assert 4 <= g_syncs <= 8


def _moderate_batch(cuda, batch=8, seed=3, **kw):
    """The 2048^2 block LP (f32, 8x128 blocks) and a batch of its variable
    bounds: in each instance a fifth of the variables boxed to within 1 of
    the generator's feasible point (so every instance stays feasible),
    drawn from a seed."""
    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.pdlp import PdhgParams

    qp = block_random_lp(2048, 2048, 512, (8, 128), seed=seed)
    # block_random_lp's draws: cells, values, then its feasible point x0
    g = np.random.default_rng(seed)
    g.choice(256 * 16, size=512, replace=False)
    g.standard_normal(512 * 8 * 128)
    x0 = g.uniform(0.0, 5.0, size=2048)
    assert np.all(qp.constraint_matrix @ x0 <= qp.constraint_upper)
    rng = np.random.default_rng(seed + 100)
    box = rng.random((batch, 2048)) < 0.2
    lbs = np.where(box, np.maximum(0.0, x0 - rng.uniform(0, 1, box.shape)),
                   qp.variable_lower)
    ubs = np.where(box, np.minimum(10.0, x0 + rng.uniform(0, 1, box.shape)),
                   qp.variable_upper)
    return qp, lbs, ubs, PdhgParams(block_shape=(8, 128), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("step_scale", [1.0, 30.0])
def test_batched_graph_majors_equal_eager_slots_on_card(cuda, step_scale):
    """A replayed batched major is the same slots run eagerly, bit for
    bit, with rejected attempts in some instances; each replay adds the
    SpMM launches it captured to the counters."""
    from ortools_tpu_torch.pdlp import batched as TB
    from ortools_tpu_torch.pdlp import solver as S

    qp, lbs, ubs, params = _moderate_batch(cuda)
    solver = TB.BatchSolver(qp, params, len(lbs), device=cuda)
    solver._start(lbs, ubs, None, None)
    state = solver.majors.snapshot()
    scale = torch.ones_like(state.step_size)
    scale[1::2] = step_scale
    state = state._replace(step_size=state.step_size * scale)
    runs = []
    for graphs in (True, False):
        majors = S._Majors(solver.majors.prob, params)
        majors.use_graphs = graphs
        majors.load(state)
        majors.major()  # capture (graphs) or warm-up
        before = T.launch_counts()
        S.host_syncs = 0
        hosts = [majors.major()[1] for _ in range(2)]
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(T.launch_counts(), before))
        runs.append((majors.snapshot(), hosts, launches, S.host_syncs))
    (g_state, g_hosts, g_launches, g_syncs), (e_state, e_hosts,
                                              e_launches, _) = runs
    for name, a, b in zip(S.PdhgState._fields, g_state, e_state):
        assert torch.equal(a, b), name
    for gh, eh in zip(g_hosts, e_hosts):
        assert gh.keys() == eh.keys()
        for k in ("kkt_current", "kkt_average", "step_size"):
            np.testing.assert_array_equal(gh[k], eh[k])
    assert g_launches == e_launches
    assert g_launches[2] > 0 and g_launches[1] == 0
    if step_scale > 1.0:
        steps = (g_state.num_steps - g_state.num_accepted).cpu().numpy()
        assert steps[1::2].min() > steps[0::2].min()
    assert 2 <= g_syncs <= 4


@pytest.mark.gpu
def test_node_backend_second_call_captures_nothing_on_card(cuda):
    """A backend keeps its solver: the second call captures no graph and
    gives what a fresh backend gives, bit for bit; every product of the
    batched path went through the SpMM kernel."""
    from ortools_tpu_torch.mip.node_lp import PdhgNodeBackend
    from ortools_tpu_torch.pdlp import solver as S

    qp, lbs, ubs, params = _moderate_batch(cuda, iteration_limit=64 * 6)
    backend = PdhgNodeBackend(qp, params, 8, device=cuda)
    S.capture_seconds = 0.0
    backend.solve(lbs[:6], ubs[:6])
    assert S.capture_seconds > 0
    S.capture_seconds = 0.0
    before = T.launch_counts()
    second = backend.solve(lbs[2:], ubs[2:])
    launches = tuple(a - b for a, b in zip(T.launch_counts(), before))
    assert S.capture_seconds == 0.0
    assert launches[2] > 0 and launches[1] == 0
    fresh = PdhgNodeBackend(qp, params, 8, device=cuda).solve(lbs[2:],
                                                             ubs[2:])
    for f in ("primal_solution", "dual_solution", "dual_bound", "optimal",
              "primal_infeasible"):
        np.testing.assert_array_equal(getattr(second, f), getattr(fresh, f))


@pytest.mark.gpu
def test_solve_batch_on_card_matches_highs(cuda):
    """Eight instances of the moderate LP with their own bounds, f64,
    each OPTIMAL within 1e-4·(1+|ref|) of HiGHS on its bounds."""
    from scipy.optimize import linprog

    from ortools_tpu_torch.pdlp.batched import solve_batch

    qp, lbs, ubs, params = _moderate_batch(cuda, dtype=torch.float64)
    r = solve_batch(qp, lbs, ubs, params)
    assert r.optimal.all()
    for i in range(len(lbs)):
        ref = linprog(qp.objective_vector, A_ub=qp.constraint_matrix,
                      b_ub=qp.constraint_upper,
                      bounds=list(zip(lbs[i], ubs[i])), method="highs")
        assert abs(r.primal_objective[i] - ref.fun) <= 1e-4 * (1 + abs(ref.fun))
        assert r.dual_bound[i] <= ref.fun + 1e-4 * (1 + abs(ref.fun))


@pytest.mark.gpu
def test_solve_on_card_reads_the_host_at_most_twice_a_major(cuda):
    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.pdlp import solver as S
    from ortools_tpu_torch.utils.status import TerminationReason

    S.host_syncs = 0
    r = solve(block_random_lp(2048, 2048, 512, (8, 128), seed=1),
              PdhgParams(block_shape=(8, 128), record_iteration_stats=True))
    assert r.termination_reason == TerminationReason.OPTIMAL
    majors = len(r.iteration_stats)
    assert S.host_syncs <= 2 * majors
    assert S.capture_seconds > 0


@pytest.mark.gpu
def test_graph_replays_are_counted_on_card(cuda):
    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.utils import tracing

    before = tracing.counters()
    r = solve(block_random_lp(2048, 2048, 512, (8, 128), seed=1),
              PdhgParams(block_shape=(8, 128), record_iteration_stats=True))
    after = tracing.counters()
    majors = after["majors"] - before.get("majors", 0)
    assert majors == len(r.iteration_stats) > 0
    assert after["replay_seconds"] > before.get("replay_seconds", 0.0)
    slots = after["slots"] - before.get("slots", 0)
    accepted = after["accepted"] - before.get("accepted", 0)
    assert accepted == r.iterations <= slots


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(restart_strategy="ADAPTIVE_HEURISTIC"),
    dict(linesearch_rule="malitsky_pock"),
    dict(use_feasibility_polishing=True),
    dict(presolve=True),
    dict(random_projection_seeds=(3,)),
], ids=["adaptive_heuristic", "malitsky_pock", "polishing", "presolve",
        "projections"])
def test_rest_of_the_solve_on_card(cuda, kw):
    """Each feature of this slice through ``solve`` on the card, OPTIMAL
    against HiGHS."""
    from scipy.optimize import linprog

    from ortools_tpu_torch.models.lp import random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.pdlp.params import RestartStrategy
    from ortools_tpu_torch.utils.status import TerminationReason

    if "restart_strategy" in kw:
        kw = dict(restart_strategy=RestartStrategy[kw["restart_strategy"]])
    qp = random_lp(256, 256, density=0.5, seed=11)
    ref = linprog(qp.objective_vector, A_ub=qp.constraint_matrix,
                  b_ub=qp.constraint_upper,
                  bounds=list(zip(qp.variable_lower, qp.variable_upper)),
                  method="highs")
    r = solve(qp, PdhgParams(block_shape=(8, 128), iteration_limit=40000,
                             record_iteration_stats=True, **kw))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref.fun) <= 1e-4 * (1 + abs(ref.fun))
    if "random_projection_seeds" in kw:
        assert set(r.iteration_stats[-1]["point_metadata"]) == {
            "primal_3", "dual_3"}


@pytest.mark.gpu
def test_polishing_on_card_runs_on_the_majors_buffers(cuda):
    """Polishing's majors run on the solve's own graphs, with the
    subproblem's vectors copied in.  On this LP the gate opens before the
    solve ends: a polished point ends it sooner, or the solve goes on from
    the state it had, bit for bit."""
    import dataclasses

    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.pdlp import solver as S
    from ortools_tpu_torch.utils.status import TerminationReason

    qp = block_random_lp(2048, 2048, 512, (8, 128), seed=3)
    params = PdhgParams(use_feasibility_polishing=True,
                        record_iteration_stats=True)
    S.host_syncs = 0
    r = solve(qp, params)
    # one read per major of the main loop; the rest are polishing's
    assert S.host_syncs > len(r.iteration_stats)
    S.host_syncs = 0
    plain = solve(qp, dataclasses.replace(params,
                                          use_feasibility_polishing=False))
    assert S.host_syncs == len(plain.iteration_stats)
    assert r.termination_reason == plain.termination_reason == \
        TerminationReason.OPTIMAL
    if r.iterations == plain.iterations:
        np.testing.assert_array_equal(r.primal_solution,
                                      plain.primal_solution)
        np.testing.assert_array_equal(r.dual_solution, plain.dual_solution)
    else:
        assert r.iterations < plain.iterations
        assert abs(r.primal_objective - plain.primal_objective) <= 1e-4 * (
            1 + abs(plain.primal_objective))


@pytest.mark.gpu
def test_repeated_solves_hold_no_more_device_memory(cuda):
    """Every solve captures its graphs on the card's one capture stream,
    so a later solve leaves no more memory held than the first (cuBLAS
    keeps a workspace for each stream it has run on)."""
    from ortools_tpu_torch.models.lp import random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve

    qp = random_lp(256, 256, density=0.5, seed=11)
    params = PdhgParams(block_shape=(8, 128), iteration_limit=640)
    solve(qp, params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for _ in range(3):
        solve(qp, params)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held


@pytest.mark.gpu
def test_failed_capture_raises_on_card(cuda, monkeypatch):
    """A slot that reads a device value cannot be captured: the majors
    raise and do not fall back to running slots eagerly.  (Last in the
    file: a failed capture may leave the card's state unusable for what
    follows in the process.)"""
    S, params, prob, state = _moderate_start(cuda)
    slot = S._make_iteration(params)

    def reading_slot(p, s):
        slot(p, s)
        float(s.state.step_size)

    monkeypatch.setattr(S, "_make_iteration", lambda *a, **k: reading_slot)
    majors = S._Majors(prob, params)
    majors.load(state)
    with pytest.raises(RuntimeError):
        majors.major(False)


def _cover_system(n=300, m=120, density=0.05, seed=3):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, n)) < density).astype(float)
    a[np.arange(m), rng.integers(0, n, m)] = 1.0
    cost = 1.0 + rng.random(n)
    return sp.csr_matrix(a), np.ones(m), np.full(m, np.inf), cost


@pytest.mark.gpu
def test_device_fj_round_reads_nothing_on_card(cuda):
    """A round of the device feasibility jump runs with no host read (the
    sync debug mode raises on one), and every solution the search returns
    passes a numpy check of the rows and the cutoff."""
    from ortools_tpu_torch.sat import fj_device as F

    a, rlo, rhi, cost = _cover_system()
    cutoff = 0.8 * float(cost.sum())
    a2, lb2, ub2 = F.objective_descent_system(a, rlo, rhi, cost, cutoff)
    a_d = np.asarray(a2.todense(), dtype=np.float32)
    sys_ = F.make_system(a_d, lb2, ub2, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    st = F.initial_state(sys_, 64, gen, np.ones(a.shape[1]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        F.run_round(sys_, st, gen, 128, 0.3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    x = st.x.cpu().numpy()
    np.testing.assert_allclose(st.act.cpu().numpy(), x @ a_d.T, rtol=1e-5,
                               atol=1e-3)
    res = F.device_feasibility_jump(a2, lb2, ub2, n_seeds=64,
                                    steps_per_round=128, max_rounds=40,
                                    x0=np.ones(a.shape[1]), device=cuda)
    assert res.solutions
    for xs in res.solutions:
        ax = a @ xs
        assert (ax >= rlo - 1e-6).all() and float(cost @ xs) <= cutoff + 1e-6
        assert set(np.unique(xs)) <= {0.0, 1.0}


@pytest.mark.gpu
def test_mip_solve_with_pdhg_node_lps_on_card(cuda, monkeypatch):
    """A small knapsack MIP through the PDHG node backend on the card, to
    OPTIMAL against HiGHS."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    from ortools_tpu_torch.mip import MipParams, solve
    from ortools_tpu_torch.mip.node_lp import PdhgNodeBackend
    from ortools_tpu_torch.models.lp import QuadraticProgram

    rng = np.random.default_rng(2)
    n = 14
    w = rng.integers(1, 20, size=n).astype(float)
    v = rng.integers(1, 30, size=n).astype(float)
    qp = QuadraticProgram(
        objective_vector=v, constraint_matrix=sp.csr_matrix(w[None]),
        constraint_lower=np.array([-np.inf]),
        constraint_upper=np.array([0.4 * w.sum()]),
        variable_lower=np.zeros(n), variable_upper=np.ones(n),
        maximize=True, integrality=np.ones(n, dtype=bool))
    ref = milp(-v, constraints=LinearConstraint(w[None], -np.inf,
                                                0.4 * w.sum()),
               bounds=Bounds(0, 1), integrality=np.ones(n))
    batches = []
    backend_solve = PdhgNodeBackend.solve

    def counted(backend, lbs, *args, **kw):
        batches.append(lbs.shape[0])
        return backend_solve(backend, lbs, *args, **kw)

    monkeypatch.setattr(PdhgNodeBackend, "solve", counted)
    r = solve(qp, MipParams(node_lp="pdhg", node_batch_size=8,
                            time_limit_sec=120.0), device=cuda)
    assert batches
    assert r.status.name == "OPTIMAL"
    assert abs(r.objective_value - (-ref.fun)) <= 1e-4 * (1 + abs(ref.fun))


@pytest.mark.gpu
def test_front_end_pdlp_on_card_equals_pdlp_solve(cuda):
    """``Solver("pdlp")`` on a Model, on the card, against ``pdlp.solve``
    on the same QP with the route's parameters (float32): the same
    termination and iterations, and the solutions bit for bit."""
    from ortools_tpu_torch.linear_solver import Model, MPSolverStatus, Solver
    from ortools_tpu_torch.models.lp import random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve

    qp = random_lp(256, 256, density=0.5, seed=11)
    model = Model.from_qp(qp)
    s = Solver("pdlp", device=cuda)
    status = s.solve(model, block_shape=(8, 128), iteration_limit=40000)
    ref = solve(model.to_qp(), PdhgParams(dtype=torch.float32,
                                          block_shape=(8, 128),
                                          iteration_limit=40000),
                device=cuda)
    assert status == MPSolverStatus.OPTIMAL
    assert ref.termination_reason.name == "OPTIMAL"
    np.testing.assert_array_equal(s._values, ref.primal_solution)
    np.testing.assert_array_equal(s._duals, ref.dual_solution)
    np.testing.assert_array_equal(s._reduced_costs, ref.reduced_costs)
    assert s.objective_value == ref.primal_objective


@pytest.mark.gpu
def test_one_rank_nccl_mesh_solve_equals_the_single_path(cuda, tmp_path):
    """A mesh of one NCCL rank, 1-D and 2-D (1, 1): the padding, the block
    order and the collectives are the identity, so the solve equals the
    single path's exact stream bit for bit (the fast stream is exact under
    a mesh).  The collectives are captured in the majors' graphs: the
    host calls them while the graphs are captured, and replayed majors
    call none."""
    import torch.distributed as dist

    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.parallel import make_mesh
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.pdlp import solver as S

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        qp = block_random_lp(2048, 2048, 512, (8, 128), seed=1)
        params = PdhgParams(iteration_limit=512)
        single = solve(qp, PdhgParams(iteration_limit=512,
                                      stream_precision="exact"))
        for shape, names in (((1,), ("shards",)), ((1, 1), ("row", "col"))):
            mesh = make_mesh(shape, names)
            r = solve(qp, params, mesh=mesh)
            assert r.termination_reason == single.termination_reason
            assert r.iterations == single.iterations
            assert r.primal_objective == single.primal_objective
            assert r.dual_objective == single.dual_objective
            np.testing.assert_array_equal(r.primal_solution,
                                          single.primal_solution)
            np.testing.assert_array_equal(r.dual_solution,
                                          single.dual_solution)
            prob, psum = S.build_mesh_problem(qp, params, mesh)
            g = torch.Generator(device="cpu").manual_seed(0)
            v0 = torch.randn(prob.c.shape[0], generator=g,
                             dtype=torch.float64).to(prob.c)
            sigma = S._make_power_iter(params, psum)(prob, v0)
            majors = S._Majors(prob, params, psum)
            majors.load(S._make_initial_state(params, psum)(prob, sigma))
            assert majors.use_graphs
            mesh.calls = 0
            majors.major()
            captured = mesh.calls
            assert captured > 0 and len(majors._graphs) == 3
            majors.major()
            majors.major()
            torch.cuda.synchronize()
            assert mesh.calls == captured
            assert bool(torch.isfinite(majors.state.x).all())
        # A finite time limit agrees on the clock through the card once a
        # major: the same result, one more counted host read per agreement.
        agreed = []
        mesh_any = mesh.any

        def counted_any(flag):
            agreed.append(flag)
            return mesh_any(flag)

        mesh.any = counted_any
        S.host_syncs = 0
        r = solve(qp, params, mesh=mesh)
        unlimited = S.host_syncs
        S.host_syncs = 0
        timed = solve(qp, dataclasses.replace(params, time_sec_limit=3600.0),
                      mesh=mesh)
        assert len(agreed) > 0 and not any(agreed)
        assert S.host_syncs == unlimited + len(agreed)
        assert timed.iterations == r.iterations
        np.testing.assert_array_equal(timed.primal_solution,
                                      r.primal_solution)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cp_sat_max_hs_on_card_equals_the_cpu_solve(cuda):
    """CP-SAT's MaxHS route runs its hitting-set MIPs on the card, and
    proves the brute-force optimum, as the CPU solve does
    (tests/test_max_hs.py's model, seed 7)."""
    import itertools

    from ortools_tpu_torch.sat import CpModel, CpSolver
    from ortools_tpu_torch.sat.checker import solution_is_feasible

    rng = np.random.default_rng(7)
    model = CpModel()
    xs = [model.new_bool_var(f"x{i}") for i in range(10)]
    for _ in range(18):
        vs = rng.choice(10, 3, replace=False)
        signs = rng.integers(0, 2, 3)
        model.add_bool_or([xs[v] if s else ~xs[v]
                           for v, s in zip(vs, signs)])
    w = rng.integers(1, 9, 10)
    model.minimize(sum(int(wi) * x for wi, x in zip(w, xs)))
    best = min(int(w @ np.array(bits))
               for bits in itertools.product([0, 1], repeat=10)
               if solution_is_feasible(model.ir, list(bits)))
    out = {}
    for device in ("cuda", "cpu"):
        solver = CpSolver(device=device)
        solver.parameters.core_algorithm = "max_hs"
        assert solver.solve(model).name == "OPTIMAL"
        out[device] = solver.response
    for r in out.values():
        assert r.objective_value == r.best_objective_bound == best
        assert solution_is_feasible(model.ir, r.solution)


@pytest.mark.gpu
def test_forked_portfolio_beside_a_cuda_context(cuda):
    """A CUDA op, then a forked ``ParallelPortfolio`` solve (the workers
    are forked from a process that holds a CUDA context and never touch
    it), then a CUDA op again: the objective equals the CPU solve's, every
    worker is joined, and the card still computes."""
    import multiprocessing as mp

    from ortools_tpu_torch.sat import CpModel, CpSolver

    x = torch.arange(1 << 16, device=cuda, dtype=torch.float32)
    assert float((x * 2).sum()) == float((x.cpu() * 2).sum())

    def knapsack():
        rng = np.random.default_rng(5)
        m = CpModel()
        xs = [m.new_bool_var(f"x{i}") for i in range(14)]
        w = rng.integers(1, 20, 14)
        v = rng.integers(1, 30, 14)
        m.add(sum(int(a) * b for a, b in zip(w, xs)) <= int(w.sum() * 0.4))
        m.maximize(sum(int(a) * b for a, b in zip(v, xs)))
        return m

    out = {}
    for device in ("cuda", "cpu"):
        solver = CpSolver(device=device)
        solver.parameters.num_workers = 4
        solver.parameters.interleave_search = False
        solver.parameters.max_time_in_seconds = 60.0
        assert solver.solve(knapsack()).name == "OPTIMAL"
        out[device] = solver.objective_value
    assert out["cuda"] == out["cpu"]
    assert not mp.active_children()
    y = torch.ones(1 << 20, device=cuda, dtype=torch.float64)
    assert float(y.sum()) == float(1 << 20)


@pytest.mark.gpu
def test_lp_file_solve_on_card_equals_the_solve_of_the_lp(cuda, tmp_path):
    """A moderate LP written with ``write_lp`` and read back with
    ``read_lp`` (its empty rows come back as explicit zeros, which the
    scaling drops) solves on the card bit for bit as the LP itself, at
    the bench's parameters (float32, 8x128 blocks, both streams)."""
    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.models.lp_format import read_lp, write_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve

    qp = block_random_lp(2048, 2048, 512, (8, 128), seed=1)
    path = tmp_path / "m.lp"
    write_lp(qp, str(path))
    read = read_lp(str(path))
    params = PdhgParams(dtype=torch.float32, block_shape=(8, 128))
    r, rr = (solve(q, params, device=cuda) for q in (qp, read))
    assert r.termination_reason.name == "OPTIMAL"
    assert rr.termination_reason == r.termination_reason
    assert rr.iterations == r.iterations
    assert (rr.primal_objective, rr.dual_objective) == (
        r.primal_objective, r.dual_objective)
    np.testing.assert_array_equal(rr.primal_solution, r.primal_solution)
    np.testing.assert_array_equal(rr.dual_solution, r.dual_solution)


@pytest.mark.gpu
def test_roofline_step_is_one_kernel_on_card(cuda):
    """``scripts/bench_roofline_torch.py``'s step, y ← x·(1 + 1e-9·i) + y,
    launches one kernel on the card (``torch.profiler``), and a graph of
    steps gives the eager steps' result bit for bit."""
    import importlib.util
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "bench_roofline_torch.py")
    spec = importlib.util.spec_from_file_location("bench_roofline_torch",
                                                  path)
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(1 << 20, generator=gen).to(cuda)
    y0 = torch.randn(1 << 20, generator=gen).to(cuda)
    y = y0.clone()
    roofline.step(x, y, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        roofline.step(x, y, 5)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1, kernels
    eager = y0.clone()
    roofline.steps(x, eager, 16)
    y = torch.empty_like(y0)
    roofline.best_sec(x, y0, y, 16, reps=1)
    assert torch.equal(y, eager)
