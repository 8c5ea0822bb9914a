"""The port's own copies of the JAX package's host modules against the
originals: ``models/lp.py``, ``models/generators.py::block_random_lp`` and
``utils/status.py::TerminationReason``.  The port imports nothing of the
JAX package, so these copies must stay equal to what they copy."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from ortools_tpu.models import generators as jgen
from ortools_tpu.models import lp as jlp
from ortools_tpu.utils.status import TerminationReason as JReason

from ortools_tpu_torch.models import generators as tgen
from ortools_tpu_torch.models import lp as tlp
from ortools_tpu_torch.utils.status import TerminationReason as TReason


def _assert_same_qp(t, j):
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if sp.issparse(jv):
            assert (tv != jv).nnz == 0 and tv.shape == jv.shape, f.name
        elif isinstance(jv, np.ndarray):
            np.testing.assert_array_equal(tv, jv, err_msg=f.name)
        else:
            assert tv == jv, f.name


@pytest.mark.parametrize("m,n,density,seed", [
    (20, 30, 0.2, 0), (60, 40, 0.3, 3), (100, 100, 0.05, 11)])
def test_random_lp_copy_matches(m, n, density, seed):
    _assert_same_qp(tlp.random_lp(m, n, density=density, seed=seed),
                    jlp.random_lp(m, n, density=density, seed=seed))


@pytest.mark.parametrize("m,n,nb,block_shape,seed", [
    (256, 256, 16, (8, 128), 0),
    (512, 384, 24, (32, 128), 1),
    (2048, 2048, 512, (8, 128), 0),
])
def test_block_random_lp_copy_matches(m, n, nb, block_shape, seed):
    _assert_same_qp(tgen.block_random_lp(m, n, nb, block_shape, seed=seed),
                    jgen.block_random_lp(m, n, nb, block_shape, seed=seed))


def test_quadratic_program_methods_match():
    kw = dict(
        objective_vector=np.array([1.0, -2.0, 0.5]),
        objective_matrix_diagonal=np.array([0.0, 1.0, 2.0]),
        objective_constant=3.0,
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 0.0, 2.0],
                                                  [0.0, -1.0, 1.0]])),
        constraint_lower=np.array([-np.inf, 1.0]),
        constraint_upper=np.array([4.0, 1.0]),
        variable_lower=np.array([0.0, -np.inf, 0.0]),
        variable_upper=np.array([1.0, 5.0, np.inf]),
        maximize=True,
    )
    t, j = tlp.QuadraticProgram(**kw), jlp.QuadraticProgram(**kw)
    _assert_same_qp(t.as_minimization(), j.as_minimization())
    assert (t.num_variables, t.num_constraints, t.num_nonzeros, t.is_lp()) == (
        j.num_variables, j.num_constraints, j.num_nonzeros, j.is_lp())
    x = np.array([0.5, 1.0, 2.0])
    assert t.objective_value(x) == j.objective_value(x)
    assert (t.transpose_matrix() != j.transpose_matrix()).nnz == 0
    assert t.validate() == j.validate() == []
    bad = dict(kw, constraint_lower=np.array([5.0, 1.0]),
               variable_upper=np.array([1.0, 5.0, np.nan]))
    assert tlp.QuadraticProgram(**bad).validate() == \
        jlp.QuadraticProgram(**bad).validate() != []


def test_termination_reason_copy_matches():
    assert [(r.name, r.value) for r in TReason] == [
        (r.name, r.value) for r in JReason]
    for r in TReason:
        assert r.is_optimal == JReason[r.name].is_optimal
