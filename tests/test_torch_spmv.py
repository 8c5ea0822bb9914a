"""The port's SpMV kernels and their plain versions.

On the CPU the plain versions are held against the JAX Pallas kernels run
in interpret mode (as ``tests/test_tiled_spmv.py`` runs them) and against
scipy; the port's df32 counterparts against ``ortools_tpu/ops/df32.py``.
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
