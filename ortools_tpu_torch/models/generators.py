"""Synthetic problem generators (copy of ``block_random_lp`` from
``ortools_tpu/models/generators.py``): scale-controllable instances with
block-friendly sparsity for tests and benchmarks."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.models.lp import QuadraticProgram


def block_random_lp(
    m: int,
    n: int,
    num_blocks: int,
    block_shape: Tuple[int, int] = (8, 128),
    seed: int = 0,
) -> QuadraticProgram:
    """Random LP whose nonzeros are dense (bm, bn) blocks at random block
    positions — zero padding waste in BlockSparseMatrix form, so benchmarks
    measure the kernel, not the packing heuristic.

    Feasibility by construction: A x0 <= b with margin; 0 <= x <= 10.
    """
    bm, bn = block_shape
    assert m % bm == 0 and n % bn == 0
    gm, gn = m // bm, n // bn
    rng = np.random.default_rng(seed)
    num_blocks = min(num_blocks, gm * gn)
    cells = rng.choice(gm * gn, size=num_blocks, replace=False)
    brows, bcols = cells // gn, cells % gn
    rows = (brows[:, None, None] * bm
            + np.arange(bm)[None, :, None]
            + np.zeros(bn, np.int64)[None, None, :]).ravel()
    cols = (bcols[:, None, None] * bn
            + np.zeros(bm, np.int64)[None, :, None]
            + np.arange(bn)[None, None, :]).ravel()
    vals = rng.standard_normal(num_blocks * bm * bn) / np.sqrt(bn)
    a = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    x0 = rng.uniform(0.0, 5.0, size=n)
    b = a @ x0 + rng.uniform(0.1, 1.0, size=m)
    return QuadraticProgram(
        objective_vector=rng.standard_normal(n),
        constraint_matrix=a,
        constraint_lower=np.full(m, -np.inf),
        constraint_upper=b,
        variable_lower=np.zeros(n),
        variable_upper=np.full(n, 10.0),
        name=f"block_random_lp_{m}x{n}_{num_blocks}b",
    )
