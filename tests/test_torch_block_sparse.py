"""The port's BlockSparseMatrix against the JAX package's.

Host packing (``from_scipy``), the block transpose and the block-row
layout are compared array for array with the JAX objects; the plain
product against JAX's ``_block_matvec`` and scipy on the cases of
``tests/test_block_sparse.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.ops.block_sparse import BlockSparseMatrix as JMatrix
from ortools_tpu.ops.block_sparse import _block_matvec as j_block_matvec

from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix as TMatrix
from ortools_tpu_torch.ops.block_sparse import auto_block_shape

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)


def _pair(a, **kw):
    j = JMatrix.from_scipy(a, dtype=jnp.float64, **kw)
    t = TMatrix.from_scipy(a, dtype=torch.float64, device="cpu", **kw)
    return j, t


def _assert_same_arrays(t: TMatrix, j: JMatrix):
    assert t.shape == j.shape
    assert t.padded_shape == j.padded_shape
    assert t.num_real_blocks == j.num_real_blocks
    assert t.block_shape == j.block_shape
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.block_rows.numpy(),
                                  np.asarray(j.block_rows))
    np.testing.assert_array_equal(t.block_cols.numpy(),
                                  np.asarray(j.block_cols))


CASES = [
    (10, 17, 0.3, (8, 128)),
    (100, 250, 0.02, (8, 128)),
    (257, 129, 0.05, (32, 128)),
    (5, 5, 1.0, (8, 128)),
    (300, 200, 0.2, (128, 128)),
]


@pytest.mark.parametrize("m,n,density,block", CASES)
def test_from_scipy_and_matvec_match_jax(m, n, density, block):
    a = sp.random(m, n, density=density,
                  random_state=np.random.RandomState(1), format="csr")
    j, t = _pair(a, block_shape=block)
    _assert_same_arrays(t, j)
    x = np.random.default_rng(42).standard_normal(n)
    y = t.unpad_y(t.matvec(t.pad_x(x))).numpy()
    yj = np.asarray(j_block_matvec(j.data, j.block_rows, j.block_cols,
                                   j.pad_x(x), j.padded_shape[0]))[:m]
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, yj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n,density,block", CASES)
def test_block_transpose_matches_jax(m, n, density, block):
    a = sp.random(m, n, density=density,
                  random_state=np.random.RandomState(3), format="csr")
    j, t = _pair(a, block_shape=block)
    jt, tt = j.block_transpose(), t.block_transpose()
    _assert_same_arrays(tt, jt)
    np.testing.assert_allclose(tt.to_dense(), a.T.toarray(), atol=0)
    y = np.random.default_rng(4).standard_normal(m)
    out = tt.unpad_y(tt.matvec(tt.pad_x(y))).numpy()
    np.testing.assert_allclose(out, a.T @ y, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n,density,block", CASES)
def test_block_row_layout(m, n, density, block):
    """with_tiled sorts the transpose's blocks by (row, col); row_ptr
    delimits each block-row; the product is unchanged."""
    a = sp.random(m, n, density=density,
                  random_state=np.random.RandomState(5), format="csr")
    _, t = _pair(a, block_shape=block)
    for mat in (t, t.block_transpose()):
        tiled = mat.with_tiled(hi=True)
        lay = tiled.tiled
        rows = lay.block_rows.numpy()
        cols = lay.block_cols.numpy()
        key = rows.astype(np.int64) * 100000 + cols
        assert np.all(np.diff(key) > 0) or len(key) == 1
        ptr = lay.row_ptr.numpy()
        assert lay.row_ptr.dtype == torch.int32
        assert len(ptr) == mat.padded_shape[0] // mat.block_shape[0] + 1
        assert ptr[0] == 0 and ptr[-1] == mat.num_blocks
        for r in range(len(ptr) - 1):
            assert np.all(rows[ptr[r]:ptr[r + 1]] == r)
        # the layout shares the matrix's (sorted) tensors
        assert lay.data is tiled.data and lay.block_cols is tiled.block_cols
        assert lay.data_hi.dtype == torch.bfloat16
        np.testing.assert_array_equal(tiled.to_dense(), mat.to_dense())
        x = mat.pad_x(np.random.default_rng(6).standard_normal(mat.shape[1]))
        np.testing.assert_allclose(tiled.matvec(x).numpy(),
                                   mat.matvec(x).numpy(), rtol=1e-12,
                                   atol=1e-12)
    # A from from_scipy is sorted already: no copy of its blocks
    assert t.with_tiled().data is t.data


def test_empty_matrix():
    a = sp.csr_matrix((8, 16))
    j, t = _pair(a)
    _assert_same_arrays(t, j)
    assert t.num_blocks == 1 and t.num_real_blocks == 1
    for mat in (t, t.with_tiled(hi=True), t.block_transpose().with_tiled()):
        y = mat.matvec(mat.pad_x(np.ones(mat.shape[1])))
        assert float(y.abs().max()) == 0.0


def test_block_padding_multiple():
    a = sp.random(64, 256, density=0.02, random_state=np.random.RandomState(9))
    j, t = _pair(a, pad_blocks_to_multiple_of=8)
    _assert_same_arrays(t, j)
    assert t.num_blocks % 8 == 0
    x = np.random.default_rng(2).standard_normal(256)
    y = t.unpad_y(t.with_tiled().matvec(t.pad_x(x))).numpy()
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)


def test_to_dense_roundtrip_and_padding_helpers():
    a = sp.random(33, 65, density=0.08, random_state=np.random.RandomState(7),
                  format="csr")
    _, t = _pair(a)
    np.testing.assert_allclose(t.to_dense(), a.toarray(), rtol=0, atol=0)
    x = t.pad_x(np.ones(65), value=2.0)
    assert x.shape == (128,) and float(x[64]) == 1.0 and float(x[65]) == 2.0
    assert t.unpad_x(x).shape == (65,)
    assert t.pad_y(np.ones(33)).shape == (40,)


def test_auto_block_shape():
    assert auto_block_shape(1000, 1000, 100_000) == (128, 128)
    assert auto_block_shape(1000, 1000, 10_000) == (32, 128)
    assert auto_block_shape(10_000, 10_000, 10_000) == (8, 128)


def test_product_off_cpu_needs_the_layout():
    """Nothing on a card runs the plain product; the check is made before
    any CUDA tensor is touched, so it is seen here on a meta tensor."""
    a = sp.random(20, 20, density=0.2, random_state=np.random.RandomState(0))
    _, t = _pair(a)
    x = torch.empty(128, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="with_tiled"):
        t.matvec(x)
