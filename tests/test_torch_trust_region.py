"""The port's trust-region functions (``ortools_tpu_torch.pdlp.trust_region``)
against the JAX package's, on the CPU in float64 at rtol 1e-12, and the
port's ADAPTIVE_HEURISTIC solve against HiGHS.

The instances are those of ``tests/test_trust_region.py``, made with numpy
and handed to both.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from ortools_tpu.pdlp import solver as J
from ortools_tpu.pdlp import trust_region as JT
from ortools_tpu.pdlp.params import PdhgParams as JParams

from ortools_tpu_torch.models.lp import QuadraticProgram, random_lp
from ortools_tpu_torch.pdlp import PdhgParams, convert, solve
from ortools_tpu_torch.pdlp import solver as T
from ortools_tpu_torch.pdlp import trust_region as TT
from ortools_tpu_torch.pdlp.params import RestartStrategy

torch.set_num_threads(1)

RTOL = 1e-12


def close(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * (1 + np.abs(ref).max(initial=0)))


def f64(v):
    return torch.tensor(v, dtype=torch.float64)


def _instance(rng, n=5, m=4):
    gx, gy = rng.standard_normal(n), rng.standard_normal(m)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    lb, ub = x - rng.uniform(0.1, 2, n), x + rng.uniform(0.1, 2, n)
    ylb, yub = y - rng.uniform(0.1, 2, m), y + rng.uniform(0.1, 2, m)
    lb[rng.random(n) < 0.3] = -np.inf
    ub[rng.random(n) < 0.3] = np.inf
    omega = float(rng.uniform(0.3, 3))
    r = float(rng.uniform(0.2, 2))
    return (gx, gy, x, y, lb, ub, ylb, yub), omega, r


@pytest.mark.parametrize("seed", range(6))
def test_solve_joint_trust_region_matches(seed):
    """The instances of tests/test_trust_region.py:21, and a large radius
    (box optimum inside the ball) for even seeds."""
    rng = np.random.default_rng(seed)
    for _ in range(5):
        vecs, omega, r = _instance(rng, n=rng.integers(3, 9),
                                   m=rng.integers(2, 7))
        if seed % 2 == 0 and rng.random() < 0.5:
            r = 100.0
        ref = JT.solve_joint_trust_region(
            *[jnp.asarray(v) for v in vecs], omega, r)
        got = TT.solve_joint_trust_region(
            *[torch.tensor(v) for v in vecs], f64(omega), f64(r))
        for a, b in zip(got, ref):
            close(a, b)


def test_ball_inactive_when_box_small():
    """tests/test_trust_region.py:63: a tiny box far inside the ball."""
    t = f64
    res = TT.solve_joint_trust_region(
        t([1.0, -2.0]), t([3.0]), t([0.0, 0.0]), t([0.0]), t([-0.1, -0.1]),
        t([0.1, 0.1]), t([-0.1]), t([0.1]), 1.0, 100.0)
    assert float(res.primal_delta_objective) == pytest.approx(-0.3)
    assert float(res.dual_delta_objective) == pytest.approx(0.3)
    assert float(res.gap) == pytest.approx(0.6)


def test_dual_bounds_and_subgradient_match():
    lb = np.array([0.0, -np.inf, 1.0, -np.inf, 2.0])
    ub = np.array([np.inf, 5.0, 2.0, np.inf, 2.0])
    y = np.array([0.5, -0.5, 0.0, 0.0, 0.0])
    ax = np.array([1.0, 1.0, 1.5, 1.0, 3.0])
    for a, b in zip(TT.dual_bounds(torch.tensor(lb), torch.tensor(ub)),
                    JT.dual_bounds(jnp.asarray(lb), jnp.asarray(ub))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.float64
    s = TT.dual_subgradient(*[torch.tensor(v) for v in (lb, ub, y, ax)])
    np.testing.assert_array_equal(s.numpy(), np.asarray(
        JT.dual_subgradient(*[jnp.asarray(v) for v in (lb, ub, y, ax)])))
    assert list(s.numpy()) == [0.0, 5.0, 1.5, 0.0, 2.0]


def test_localized_gap_matches():
    """The localized gap of an iterate of a two-sided LP with free and
    boxed variables, at its distance from an earlier iterate."""
    from ortools_tpu.models.lp import random_lp as jrandom_lp

    qp = jrandom_lp(90, 70, density=0.1, seed=5)
    qp.constraint_lower = qp.constraint_upper - 3.0
    qp.variable_lower = np.where(np.arange(70) % 7 == 0, -np.inf, 0.0)
    jp = JParams(dtype=jnp.float64)
    jprob = J.build_device_problem(qp, jp)
    arrays = {}
    for name in J.DeviceProblem._fields:
        v = getattr(jprob, name)
        if name in ("a", "at"):
            arrays[name] = dict(
                data=np.asarray(v.data), block_rows=np.asarray(v.block_rows),
                block_cols=np.asarray(v.block_cols), shape=v.shape,
                padded_shape=v.padded_shape,
                num_real_blocks=v.num_real_blocks)
        else:
            arrays[name] = np.asarray(v)
    tprob = convert.device_problem_from_arrays(arrays, "cpu")
    rng = np.random.default_rng(1)
    n, m = jprob.c.shape[0], jprob.con_lb.shape[0]
    x = np.clip(rng.standard_normal(n), np.asarray(jprob.var_lb),
                np.asarray(jprob.var_ub))
    y = rng.standard_normal(m)
    x0 = np.clip(x + 0.1 * rng.standard_normal(n), np.asarray(jprob.var_lb),
                 np.asarray(jprob.var_ub))
    y0 = y + 0.1 * rng.standard_normal(m)
    ax = np.asarray(jprob.a.matvec(jnp.asarray(x)))
    aty = np.asarray(jprob.at.matvec(jnp.asarray(y)))
    for omega in (0.7, 2.5):
        ref = JT.localized_gap(jprob, *[jnp.asarray(v) for v in
                                        (x, y, ax, aty, x0, y0)],
                               jnp.asarray(omega))
        got = TT.localized_gap(tprob, *[torch.tensor(v) for v in
                                        (x, y, ax, aty, x0, y0)],
                               f64(omega))
        assert got._fields == ref._fields
        for a, b in zip(got, ref):
            close(a, b)


def test_adaptive_heuristic_solves_lp():
    """tests/test_trust_region.py:96 on the port."""
    from scipy.optimize import linprog

    rng = np.random.default_rng(9)
    m, n = 20, 30
    a = sp.random(m, n, density=0.4, random_state=rng, format="csr")
    x0 = rng.uniform(0, 1, n)
    qp = QuadraticProgram(
        objective_vector=rng.standard_normal(n),
        constraint_matrix=a,
        constraint_lower=a @ x0 - 0.3,
        constraint_upper=np.full(m, np.inf),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )
    res = solve(qp, PdhgParams(
        dtype=torch.float64,
        restart_strategy=RestartStrategy.ADAPTIVE_HEURISTIC,
        eps_optimal_absolute=1e-7, eps_optimal_relative=1e-7,
        iteration_limit=100_000,
    ), device="cpu")
    ref = linprog(qp.objective_vector, A_ub=-a.toarray(),
                  b_ub=-qp.constraint_lower,
                  bounds=[(0, 1)] * n, method="highs")
    assert ref.status == 0
    assert res.termination_reason.name == "OPTIMAL"
    assert res.primal_objective == pytest.approx(ref.fun, abs=1e-5)


def test_adaptive_heuristic_restarts_differ_from_adaptive_kkt():
    """The heuristic rule decides restarts from the localized gaps, so its
    trajectory is not ADAPTIVE_KKT's; both reach the optimum."""
    qp = random_lp(60, 40, density=0.3, seed=3)
    runs = {}
    for rule in (RestartStrategy.ADAPTIVE_HEURISTIC,
                 RestartStrategy.ADAPTIVE_KKT):
        runs[rule] = solve(qp, PdhgParams(
            dtype=torch.float64, restart_strategy=rule,
            record_iteration_stats=True), device="cpu")
    h = runs[RestartStrategy.ADAPTIVE_HEURISTIC]
    k = runs[RestartStrategy.ADAPTIVE_KKT]
    assert h.termination_reason.name == k.termination_reason.name == "OPTIMAL"
    assert [r["primal_weight"] for r in h.iteration_stats] != [
        r["primal_weight"] for r in k.iteration_stats]
    assert h.primal_objective == pytest.approx(k.primal_objective, rel=1e-5)


def test_params_defaults_match_jax():
    """The port's PdhgParams has the JAX package's fields and defaults,
    the Malitsky-Pock constants and the mesh fields included, except
    ``adaptive_step_size``, which no solver code reads."""
    import dataclasses

    jp, tp = JParams(), PdhgParams()
    left_out = {"adaptive_step_size", "dtype"}
    jfields = {f.name for f in dataclasses.fields(jp)} - left_out
    assert {f.name for f in dataclasses.fields(tp)} - {"dtype"} == jfields
    for name in jfields:
        jv, tv = getattr(jp, name), getattr(tp, name)
        if hasattr(jv, "name"):  # enums
            jv, tv = jv.name, tv.name
        assert jv == tv, name
    assert tp.mp_step_downscaling == 0.7 and tp.mp_contraction == 0.99
    assert T.RestartStrategy is RestartStrategy
