"""The port's copy of the LP presolve (``ortools_tpu_torch.glop.presolve``)
against the JAX package's (``ortools_tpu.glop.presolve``), on the cases of
``tests/test_presolve.py``: the same status, the same reduced problem and
index maps, and the same postsolved primal and dual vectors, exactly.
Both are numpy and scipy code, so nothing may differ by a bit.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from ortools_tpu.glop import presolve as JP
from ortools_tpu.models.lp import QuadraticProgram, random_lp

from ortools_tpu_torch.glop import presolve as TP
from ortools_tpu_torch.models.lp import QuadraticProgram as TQuadraticProgram


def port_qp(qp):
    return TQuadraticProgram(**{f.name: getattr(qp, f.name)
                                for f in dataclasses.fields(qp)})


def _qp(c, a, cl, cu, vl, vu, **kw):
    return QuadraticProgram(
        objective_vector=np.asarray(c, float),
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=np.asarray(cl, float),
        constraint_upper=np.asarray(cu, float),
        variable_lower=np.asarray(vl, float),
        variable_upper=np.asarray(vu, float), **kw)


INF = np.inf


def _pdhg_case(seed):
    qp = random_lp(50, 40, density=0.2, seed=seed)
    qp.variable_lower[0] = qp.variable_upper[0] = 1.5
    extra = sp.lil_matrix((1, 40))
    extra[0, 3] = 1.0
    qp.constraint_matrix = sp.vstack([qp.constraint_matrix,
                                      sp.csr_matrix(extra)])
    qp.constraint_lower = np.append(qp.constraint_lower, -INF)
    qp.constraint_upper = np.append(qp.constraint_upper, 4.0)
    return qp


def _substitution_case(seed):
    """tests/test_presolve.py:291: equality rows, a doubleton, a column
    singleton and a duplicate row planted in a random LP."""
    rng = np.random.default_rng(seed)
    m, n = 14, 18
    a = sp.random(m, n, density=0.35, random_state=rng.integers(1 << 30),
                  data_rvs=lambda k: rng.uniform(-2, 2, k))
    cl = np.full(m, -INF)
    cu = rng.uniform(1, 6, m)
    cl[:3] = cu[:3] = rng.uniform(1, 4, 3)
    lil = sp.csr_matrix(a).tolil()
    lil[0, :] = 0.0
    lil[0, 0] = 1.0
    lil[0, 1] = rng.uniform(0.5, 2.0)
    lil[1, 5] = rng.uniform(0.5, 2.0)
    lil[2:, 5] = 0.0
    lil[m - 1, :] = 3.0 * lil[m - 2, :]
    cl[m - 1] = -INF
    cu[m - 1] = 3.0 * cu[m - 2] - rng.uniform(0, 1)
    return _qp(rng.uniform(-1, 2, n), sp.csr_matrix(lil), cl, cu,
               np.zeros(n), np.full(n, 20.0))


CASES = {
    "singleton_row": lambda: _qp([-1, 0], [[2, 0], [1, 1]], [-INF, -INF],
                                 [6, 10], [0, 0], [100, 100]),
    "fixed_variable": lambda: _qp([1, 2], [[1, 1]], [4], [4], [2, 0],
                                  [2, 10]),
    "empty_column": lambda: _qp([5], sp.csr_matrix((1, 1)), [-INF], [INF],
                                [1], [3]),
    "infeasible": lambda: _qp([0, 0], [[1, 1]], [10], [INF], [0, 0],
                              [3, 3]),
    "unbounded_empty_col": lambda: _qp([-1], sp.csr_matrix((1, 1)), [-INF],
                                       [INF], [0], [INF]),
    "pdhg_3": lambda: _pdhg_case(3),
    "pdhg_9": lambda: _pdhg_case(9),
    "maximize": lambda: _qp([3, 1], [[1, 0]], [-INF], [5], [0, 0], [INF, 2],
                            maximize=True),
    "binding_singleton_row": lambda: _qp([3, 1], [[2, 0], [1, 1]], [4, 5],
                                         [INF, INF], [0, 0], [100, 100]),
    "doubleton_equality": lambda: _qp(
        [1, 3, 0.5], [[1, 1, 0], [0, 2, 1], [1, 0, 1]], [4, -INF, 2],
        [4, 7, INF], [0, 0, 0], [10, 10, 10]),
    "implied_free_singleton": lambda: _qp(
        [2, 1, 0.3], [[1, 1, 1], [1, 2, 0]], [5, 3], [5, INF],
        [0, 0, -100], [4, 4, 100]),
    "duplicate_row": lambda: _qp(
        [-1, -1], [[1, 1], [2, 2], [1, -1]], [-INF, -INF, -1], [10, 8, 1],
        [0, 0], [100, 100]),
    **{f"substitution_{s}": (lambda s=s: _substitution_case(s))
       for s in range(6)},
}


def _same(a, b, what):
    if isinstance(a, (QuadraticProgram, TQuadraticProgram)):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif sp.issparse(a):
        assert sp.issparse(b), what
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.shape == b.shape, what
        np.testing.assert_array_equal(a.toarray(), b.toarray(), err_msg=what)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(CASES))
def test_presolve_matches_jax(name):
    qp = CASES[name]()
    jr = JP.presolve(qp.as_minimization())
    tr = TP.presolve(port_qp(qp).as_minimization())
    assert type(jr).__name__ == type(tr).__name__
    assert jr.status.name == tr.status.name
    if jr.reduced is None:
        assert tr.reduced is None
        return
    for field in ("kept_rows", "kept_cols", "fixed_values"):
        _same(getattr(jr, field), getattr(tr, field), field)
    _same(jr.reduced, tr.reduced, "reduced")
    rng = np.random.default_rng(len(name))
    x_red = rng.uniform(0.0, 1.0, jr.reduced.num_variables)
    y_red = rng.standard_normal(jr.reduced.num_constraints)
    x_j, x_t = jr.postsolve(x_red), tr.postsolve(x_red)
    np.testing.assert_array_equal(x_j, x_t)
    yj, rcj = jr.postsolve_duals(qp.as_minimization(), x_j, y_red)
    yt, rct = tr.postsolve_duals(port_qp(qp).as_minimization(), x_t, y_red)
    np.testing.assert_array_equal(yj, yt)
    np.testing.assert_array_equal(rcj, rct)
