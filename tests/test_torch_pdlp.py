"""The port's PDLP solver (``ortools_tpu_torch.pdlp``) against its JAX twin.

Both run on the CPU: JAX under x64 as ``tests/conftest.py`` sets it, the
port with ``device="cpu"`` (its SpMV wrappers then run their plain
versions).  Problems come from the JAX package's fixtures and are handed
to the port as numpy arrays; problem data and states go across through
``ortools_tpu_torch.pdlp.convert``.

Precision of the comparison: each function is held against its twin at
rtol 1e-12 in f64.  Whole solves are not compared step for step, because
the adaptive step-size rule amplifies rounding: JAX's own trajectory,
restarted from a step size one ulp away, departs from itself as fast as
the port's does (``test_trajectory_sensitivity_matches_jax_self_noise``),
and over a whole solve that moves JAX's own iteration count by majors
(``test_jax_iteration_count_moves_with_one_ulp``).  Solves that end in
their first major agree on the iteration count and on the objectives to
1e-9; longer ones on the termination reason, on the objective to the
solve's own tolerance and on the iteration count to within a quarter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.models.lp import QuadraticProgram, random_lp
from ortools_tpu.pdlp import PdhgParams as JParams
from ortools_tpu.pdlp import solve as jsolve
from ortools_tpu.pdlp import solver as J
from ortools_tpu.pdlp.params import OptimalityNorm as JNorm
from ortools_tpu.pdlp.params import RestartStrategy as JRestart
from ortools_tpu.utils.status import TerminationReason as JReason

from ortools_tpu_torch.models.lp import QuadraticProgram as TQuadraticProgram
from ortools_tpu_torch.models.lp import random_lp as trandom_lp
from ortools_tpu_torch.ops import tiled_spmv
from ortools_tpu_torch.pdlp import PdhgParams as TParams
from ortools_tpu_torch.pdlp import convert
from ortools_tpu_torch.pdlp import solve as tsolve
from ortools_tpu_torch.pdlp import solver as T
from ortools_tpu_torch.pdlp.params import OptimalityNorm as TNorm
from ortools_tpu_torch.pdlp.params import RestartStrategy as TRestart
from ortools_tpu_torch.utils.status import TerminationReason as TReason

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)

RTOL = 1e-12


def scipy_solve(qp) -> float:
    """HiGHS's optimal objective of the same LP (as tests/test_pdlp.py's
    helper; kept here so the module does not import the ``tests`` name,
    which an installed package may shadow)."""
    from scipy.optimize import linprog

    qp = qp.as_minimization()
    a = sp.csr_matrix(qp.constraint_matrix)
    lo, hi = qp.constraint_lower, qp.constraint_upper
    eq = lo == hi
    up, down = np.isfinite(hi) & ~eq, np.isfinite(lo) & ~eq
    kw = {}
    if up.any() or down.any():
        kw["A_ub"] = sp.vstack([a[up], -a[down]])
        kw["b_ub"] = np.concatenate([hi[up], -lo[down]])
    if eq.any():
        kw["A_eq"], kw["b_eq"] = a[eq], lo[eq]
    res = linprog(qp.objective_vector, method="highs",
                  bounds=list(zip(qp.variable_lower, qp.variable_upper)), **kw)
    assert res.status == 0, res.message
    return res.fun + qp.objective_constant


# ---------------------------------------------------------------------------
# Bridges: JAX objects -> numpy -> port
# ---------------------------------------------------------------------------


def port_qp(qp: QuadraticProgram) -> TQuadraticProgram:
    return TQuadraticProgram(**{f.name: getattr(qp, f.name)
                                for f in dataclasses.fields(qp)})


def problem_arrays(prob: J.DeviceProblem) -> dict:
    out = {}
    for name in J.DeviceProblem._fields:
        v = getattr(prob, name)
        if name in ("a", "at"):
            out[name] = dict(
                data=np.asarray(v.data), block_rows=np.asarray(v.block_rows),
                block_cols=np.asarray(v.block_cols), shape=v.shape,
                padded_shape=v.padded_shape,
                num_real_blocks=v.num_real_blocks)
        else:
            out[name] = np.asarray(v)
    return out


def state_arrays(state: J.PdhgState) -> dict:
    return {name: np.asarray(getattr(state, name))
            for name in J.PdhgState._fields}


def jax_v0(n_padded: int) -> np.ndarray:
    """The power-iteration start of the JAX solve (solver.py:1098)."""
    return np.array(jax.random.normal(
        jax.random.PRNGKey(0), (n_padded,), dtype=jnp.float64))


def assert_close(port, ref, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * (1 + np.abs(ref).max(initial=0)),
                               err_msg=what)


def assert_state_close(ts: T.PdhgState, js: J.PdhgState):
    for name in J.PdhgState._fields:
        assert_close(getattr(ts, name), getattr(js, name), name)


def assert_tree_close(t, j, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            assert_tree_close(t[k], j[k], f"{path}.{k}")
    else:
        assert_close(t, j, path)


# ---------------------------------------------------------------------------
# One shared f64 problem and state
# ---------------------------------------------------------------------------


JP64 = JParams(dtype=jnp.float64)
TP64 = TParams(dtype=torch.float64)


@pytest.fixture(scope="module")
def shared():
    """A QP with two-sided rows, free and boxed variables, on which the
    JAX package ran its power iteration, initial state and 40 steps."""
    qp = random_lp(90, 70, density=0.1, seed=5)
    qp.constraint_lower = qp.constraint_upper - 3.0
    qp.variable_lower = np.where(np.arange(70) % 7 == 0, -np.inf, 0.0)
    qp.objective_matrix_diagonal = np.where(np.arange(70) % 3 == 0, 0.5, 0.0)
    jprob = J.build_device_problem(qp, JP64)
    tprob = convert.device_problem_from_arrays(problem_arrays(jprob), "cpu")
    v0 = jax_v0(jprob.c.shape[0])
    sigma = J._make_power_iter(JP64)(jprob, jnp.asarray(v0))
    jstate = J._make_initial_state(JP64)(jprob, sigma)
    it = jax.jit(J._make_iteration(JP64))
    for _ in range(40):
        jstate = it(jprob, jstate)
    return dict(qp=qp, jprob=jprob, tprob=tprob, v0=v0, sigma=sigma,
                jstate=jstate,
                tstate=convert.state_from_arrays(state_arrays(jstate), "cpu"))


def test_build_device_problem_matches(shared):
    tprob = T.build_device_problem(port_qp(shared["qp"]), TP64, "cpu")
    jarr = problem_arrays(shared["jprob"])
    for name in J.DeviceProblem._fields:
        if name in ("a", "at"):
            m = getattr(tprob, name)
            ref = jarr[name]
            assert m.shape == ref["shape"]
            assert m.padded_shape == ref["padded_shape"]
            assert m.num_real_blocks == ref["num_real_blocks"]
            for k in ("data", "block_rows", "block_cols"):
                np.testing.assert_array_equal(getattr(m, k).numpy(), ref[k])
        else:
            np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                          jarr[name], err_msg=name)


def test_power_iter_matches(shared):
    s = T._make_power_iter(TP64)(shared["tprob"],
                                 torch.tensor(shared["v0"]))
    assert_close(s, shared["sigma"])


def test_initial_state_matches(shared):
    sigma = torch.tensor(np.asarray(shared["sigma"]))
    ts = T._make_initial_state(TP64)(shared["tprob"], sigma)
    js = J._make_initial_state(JP64)(shared["jprob"], shared["sigma"])
    assert_state_close(ts, js)


def test_one_iteration_matches(shared):
    ts = T._make_iteration(TP64)(shared["tprob"], shared["tstate"])
    js = J._make_iteration(JP64)(shared["jprob"], shared["jstate"])
    assert_state_close(ts, js)


def test_run_major_matches(shared):
    # 16 steps: long enough to cross restarts of the attempt loop, short
    # enough that rounding has not been amplified past 1e-12 (see the
    # module docstring).
    jp = dataclasses.replace(JP64, termination_check_frequency=16)
    tp = dataclasses.replace(TP64, termination_check_frequency=16)
    ts = T._make_run_major(tp)(shared["tprob"], shared["tstate"])
    js = jax.jit(J._make_run_major(jp))(shared["jprob"], shared["jstate"])
    assert_state_close(ts, js)


@pytest.mark.parametrize("norm", ["L2", "L_INF"])
@pytest.mark.parametrize("exact_refresh", [False, True])
def test_compute_stats_matches(shared, norm, exact_refresh):
    jp = dataclasses.replace(JP64, optimality_norm=JNorm[norm])
    tp = dataclasses.replace(TP64, optimality_norm=TNorm[norm])
    js = J._make_compute_stats(jp, exact_refresh=exact_refresh)(
        shared["jprob"], shared["jstate"])
    ts = T._make_compute_stats(tp, exact_refresh=exact_refresh)(
        shared["tprob"], shared["tstate"])
    assert_tree_close(ts, js)
    host = T._stats_to_host(ts)
    for group in ("current", "average", "infeas_diff", "infeas_current"):
        for k, v in host[group].items():
            assert v == pytest.approx(float(js[group][k]), rel=RTOL,
                                      abs=RTOL), (group, k)


@pytest.mark.parametrize("use_avg", [False, True])
def test_apply_restart_matches(shared, use_avg):
    js = J._make_compute_stats(JP64)(shared["jprob"], shared["jstate"])
    ts = T._make_compute_stats(TP64)(shared["tprob"], shared["tstate"])
    jr = J._make_apply_restart(JP64)(shared["jprob"], shared["jstate"],
                                     jnp.asarray(use_avg), js["x_avg"],
                                     js["y_avg"])
    tr = T._make_apply_restart(TP64)(shared["tprob"], shared["tstate"],
                                     use_avg, ts["x_avg"], ts["y_avg"])
    assert_state_close(tr, jr)


def test_final_iterate_matches(shared):
    js = shared["jstate"]
    jf = J._make_final_iterate(JNorm.L2)(shared["jprob"], js.x, js.y)
    tf = T._make_final_iterate(TNorm.L2)(
        shared["tprob"], shared["tstate"].x, shared["tstate"].y)
    assert_tree_close(tf, jf)


def test_trajectory_sensitivity_matches_jax_self_noise(shared):
    """Why whole solves are compared by outcome: after 200 steps the port
    is as far from JAX as JAX is from itself restarted with its step size
    moved by one ulp (both far above 1e-12)."""
    jprob, tprob = shared["jprob"], shared["tprob"]
    js = shared["jstate"]
    js2 = js._replace(step_size=jnp.nextafter(js.step_size, jnp.inf))
    ts = shared["tstate"]
    jit = jax.jit(J._make_iteration(JP64))
    tit = T._make_iteration(TP64)
    for _ in range(200):
        js, js2, ts = jit(jprob, js), jit(jprob, js2), tit(tprob, ts)
    self_noise = float(jnp.abs(js.x - js2.x).max())
    port_gap = float(np.abs(ts.x.numpy() - np.asarray(js.x)).max())
    assert self_noise > 1e-11
    assert port_gap <= 100 * self_noise


# ---------------------------------------------------------------------------
# Whole f64 solves on the tests/test_pdlp.py fixtures
# ---------------------------------------------------------------------------


def _tiny_lp():
    return QuadraticProgram(
        objective_vector=np.array([-1.0, -2.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 0.0]])),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([4.0, 2.0]),
        variable_lower=np.zeros(2),
        variable_upper=np.full(2, 10.0),
    )


def _equality():
    rng = np.random.default_rng(5)
    n = 30
    cost = rng.uniform(1, 10, size=n)
    a = sp.vstack([
        sp.csr_matrix(np.ones((1, n))),
        sp.random(10, n, density=0.3, random_state=np.random.RandomState(2)),
    ])
    return QuadraticProgram(
        objective_vector=cost,
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=np.concatenate([[1.0], np.full(10, -np.inf)]),
        constraint_upper=np.concatenate([[1.0], rng.uniform(1, 5, size=10)]),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )


def _two_sided():
    qp = random_lp(40, 30, density=0.3, seed=13)
    qp.constraint_lower = qp.constraint_upper - 2.0
    return qp


def _box_qp():
    a = np.array([-0.5, 0.3, 1.7, 0.9])
    n = 4
    return QuadraticProgram(
        objective_vector=-a,
        objective_matrix_diagonal=np.ones(n),
        objective_constant=0.5 * float(a @ a),
        constraint_matrix=sp.csr_matrix((1, n)),
        constraint_lower=np.array([-np.inf]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )


def _constrained_qp():
    n = 4
    return QuadraticProgram(
        objective_vector=np.zeros(n),
        objective_matrix_diagonal=np.ones(n),
        constraint_matrix=sp.csr_matrix(np.ones((1, n))),
        constraint_lower=np.array([4.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.full(n, -np.inf),
        variable_upper=np.full(n, np.inf),
    )


def _primal_infeasible():
    return QuadraticProgram(
        objective_vector=np.ones(2),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 1.0]])),
        constraint_lower=np.array([4.0, -np.inf]),
        constraint_upper=np.array([np.inf, -1.0]),
        variable_lower=np.zeros(2),
        variable_upper=np.full(2, 10.0),
    )


def _dual_infeasible():
    return QuadraticProgram(
        objective_vector=np.array([-1.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0]])),
        constraint_lower=np.array([0.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.zeros(1),
        variable_upper=np.array([np.inf]),
    )


def _invalid_problem():
    return QuadraticProgram(
        objective_vector=np.zeros(2),
        constraint_matrix=sp.csr_matrix((1, 2)),
        constraint_lower=np.array([3.0]),
        constraint_upper=np.array([1.0]),  # crossed
        variable_lower=np.zeros(2),
        variable_upper=np.ones(2),
    )


FIXTURES = {
    "tiny_lp": (_tiny_lp, {}),
    "random_3": (lambda: random_lp(60, 40, density=0.3, seed=3), {}),
    "random_7": (lambda: random_lp(30, 80, density=0.2, seed=7), {}),
    "random_11": (lambda: random_lp(100, 100, density=0.05, seed=11), {}),
    "equality": (_equality, {}),
    "two_sided": (_two_sided, {}),
    "box_qp": (_box_qp, {}),
    "constrained_qp": (_constrained_qp, {}),
    "primal_infeasible": (_primal_infeasible, dict(iteration_limit=20000)),
    "dual_infeasible": (_dual_infeasible, dict(iteration_limit=20000)),
    "iteration_limit": (lambda: random_lp(50, 50, density=0.2, seed=1),
                        dict(iteration_limit=64)),
    "invalid_problem": (_invalid_problem, {}),
    "invalid_params": (lambda: random_lp(5, 5, density=0.5, seed=0),
                       dict(termination_check_frequency=0)),
    "linf_no_restarts": (
        lambda: random_lp(40, 30, density=0.3, seed=21),
        dict(optimality_norm="L_INF", restart_strategy="NO_RESTARTS",
             iteration_limit=20000)),
}


def _params(kw, norm_enum, restart_enum, param_cls, dtype):
    kw = dict(kw)
    if "optimality_norm" in kw:
        kw["optimality_norm"] = norm_enum[kw["optimality_norm"]]
    if "restart_strategy" in kw:
        kw["restart_strategy"] = restart_enum[kw["restart_strategy"]]
    return param_cls(dtype=dtype, **kw)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_f64_solve_matches_jax(name):
    """Same termination reason everywhere.  A solve that ends with its
    first major has not yet amplified rounding: same iteration count and
    objectives within 1e-9 relative.  A longer one has (see
    ``test_jax_iteration_count_moves_with_one_ulp``): objectives within
    the optimality tolerance, iteration count within a quarter of JAX's
    plus one major."""
    make, kw = FIXTURES[name]
    qp = make()
    jp = _params(kw, JNorm, JRestart, JParams, jnp.float64)
    jr = jsolve(qp, jp)
    n_padded = -(-max(qp.num_variables, 1) // 128) * 128
    tr = tsolve(port_qp(qp),
                _params(kw, TNorm, TRestart, TParams, torch.float64),
                device="cpu", v0=jax_v0(n_padded))
    assert tr.termination_reason.name == jr.termination_reason.name
    print(f"{name}: {jr.termination_reason.name} iterations jax "
          f"{jr.iterations} port {tr.iterations}; objective jax "
          f"{jr.primal_objective!r} port {tr.primal_objective!r}")
    freq = jp.termination_check_frequency
    ref_p, ref_d = jr.primal_objective, jr.dual_objective
    if jr.iterations <= freq:
        assert tr.iterations == jr.iterations
        if np.isfinite(ref_p):
            assert abs(tr.primal_objective - ref_p) <= 1e-9 * (1 + abs(ref_p))
            assert abs(tr.dual_objective - ref_d) <= 1e-9 * (1 + abs(ref_d))
    else:
        assert abs(tr.iterations - jr.iterations) <= jr.iterations // 4 + freq
        # Both points meet the optimality criteria at eps 1e-6 relative,
        # so their objectives agree to that order.
        assert abs(tr.primal_objective - ref_p) <= 1e-5 * (1 + abs(ref_p))
        assert abs(tr.dual_objective - ref_d) <= 1e-5 * (1 + abs(ref_p))


def test_jax_iteration_count_moves_with_one_ulp():
    """Why longer solves are not held to JAX's iteration count: JAX's own
    count on random_11 moves by majors when its initial step size moves by
    one ulp.  The port cannot repeat JAX's rounding bit for bit (XLA on
    the CPU fuses multiply-adds and sums in another order), so its count
    is as far from JAX's as JAX's is from itself."""
    qp = FIXTURES["random_11"][0]()
    base = jsolve(qp, JP64)
    moved = jsolve(qp, dataclasses.replace(
        JP64, initial_step_size_scaling=float(np.nextafter(1.0, 2.0))))
    assert base.termination_reason == moved.termination_reason == JReason.OPTIMAL
    assert base.iterations != moved.iterations


# ---------------------------------------------------------------------------
# The mixed-precision controller (tests/test_fast_stream_control.py), f32
# ---------------------------------------------------------------------------


def _mixed_params(**kw):
    base = dict(
        dtype=torch.float32,
        use_tiled_spmv=True,  # the kernel layout with its bf16 copy on CPU
        block_shape=(8, 128),
        stream_precision="mixed",
        record_iteration_stats=True,
        iteration_limit=20000,
    )
    base.update(kw)
    return TParams(**base)


def test_fast_stream_runs_then_switches_and_solves():
    qp = trandom_lp(256, 256, density=0.5, seed=11)
    ref = scipy_solve(qp)
    r = tsolve(qp, _mixed_params(), device="cpu")
    assert r.termination_reason == TReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))
    streams = [rec["stream"] for rec in r.iteration_stats]
    assert streams and streams[0] == "fast"
    if "exact" in streams:
        first_exact = streams.index("exact")
        assert all(s == "exact" for s in streams[first_exact:])


def test_fast_stream_stall_switches_to_exact():
    qp = trandom_lp(256, 256, density=0.5, seed=7)
    r = tsolve(qp, _mixed_params(eps_optimal_absolute=1e-6,
                                 eps_optimal_relative=1e-6), device="cpu")
    streams = [rec["stream"] for rec in r.iteration_stats]
    assert r.termination_reason == TReason.OPTIMAL
    assert "fast" in streams and "exact" in streams, streams
    assert streams[-1] == "exact"


def test_fast_stream_nonfinite_retries_exactly(monkeypatch):
    def poisoned_fast(t, x):
        return torch.full((t.num_block_rows * t.block_shape[0],), np.nan,
                          dtype=x.dtype)

    monkeypatch.setattr(tiled_spmv, "tiled_matvec_fast", poisoned_fast)
    qp = trandom_lp(256, 256, density=0.5, seed=3)
    ref = scipy_solve(qp)
    r = tsolve(qp, _mixed_params(termination_check_frequency=48),
               device="cpu")
    assert r.termination_reason == TReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))
    streams = [rec["stream"] for rec in r.iteration_stats]
    assert streams and all(s == "exact" for s in streams), streams


def test_exact_precision_param_never_uses_fast():
    qp = trandom_lp(256, 256, density=0.5, seed=5)
    r = tsolve(qp, _mixed_params(stream_precision="exact"), device="cpu")
    assert r.termination_reason == TReason.OPTIMAL
    assert all(rec["stream"] == "exact" for rec in r.iteration_stats)


def test_f64_solve_with_kernel_layout_stays_exact():
    """The bf16 copy serves the f32 fast stream only: an f64 solve with
    the kernel layout attached runs every major on the exact stream."""
    qp = trandom_lp(60, 40, density=0.3, seed=3)
    r = tsolve(qp, TParams(dtype=torch.float64, use_tiled_spmv=True,
                           record_iteration_stats=True), device="cpu")
    assert r.termination_reason == TReason.OPTIMAL
    assert all(rec["stream"] == "exact" for rec in r.iteration_stats)
    assert abs(r.primal_objective - scipy_solve(qp)) <= 1e-5 * (
        1 + abs(r.primal_objective))


def test_stats_come_to_host_in_one_copy():
    """One device-to-host read per step attempt and one per major."""
    qp = trandom_lp(30, 20, density=0.4, seed=2)
    T.host_syncs = 0
    r = tsolve(qp, TParams(dtype=torch.float64, iteration_limit=128),
               device="cpu")
    majors = r.iterations // 64
    assert T.host_syncs >= r.iterations + majors
    # every attempt beyond the accepted one is a rejected step
    assert T.host_syncs <= 40 * r.iterations + majors + 1


# ---------------------------------------------------------------------------
# Deferred features raise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(restart_strategy=TRestart.ADAPTIVE_HEURISTIC),
    dict(linesearch_rule="malitsky_pock"),
    dict(use_feasibility_polishing=True),
    dict(presolve=True),
    dict(random_projection_seeds=(7,)),
], ids=["adaptive_heuristic", "malitsky_pock", "polishing", "presolve",
        "random_projections"])
def test_deferred_features_raise(kw):
    qp = trandom_lp(10, 10, density=0.3, seed=0)
    with pytest.raises(NotImplementedError, match="later slice|not ported"):
        tsolve(qp, TParams(dtype=torch.float64, **kw), device="cpu")


def test_mesh_raises():
    qp = trandom_lp(10, 10, density=0.3, seed=0)
    with pytest.raises(NotImplementedError, match="multi-device"):
        tsolve(qp, TParams(dtype=torch.float64), device="cpu", mesh=object())
