"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where no card is present; the
decision is made inside the ``cuda`` fixture, never at import.  The module
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

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
def test_f64_solve_on_card_uses_the_exact_kernel(cuda):
    from ortools_tpu_torch.models.lp import random_lp
    from ortools_tpu_torch.pdlp import PdhgParams, solve
    from ortools_tpu_torch.utils.status import TerminationReason

    T.tiled_matvec.launches = T.tiled_matvec_fast.launches = 0
    r = solve(random_lp(60, 40, density=0.3, seed=3),
              PdhgParams(dtype=torch.float64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert T.tiled_matvec.launches > 0 and T.tiled_matvec_fast.launches == 0


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
