"""The port's batched PDLP solve (``ortools_tpu_torch.pdlp.batched``,
``ortools_tpu_torch.mip.node_lp``) against the JAX package's.

Both run on the CPU in float64: JAX under x64 as ``tests/conftest.py``
sets it, the port with ``device="cpu"`` (its products then run the plain
SpMM).  The JAX package batches by ``jax.vmap``; the port writes the batch
axis out, so each batched device function of the port is held against
``jax.vmap`` of its JAX twin on one shared batched problem and state, at
rtol 1e-12.  JAX's per-instance scalars are [B], the port's [B, 1].

Whole batched solves follow the rules of the single solve
(``tests/test_torch_pdlp.py``): the same flags per instance, objectives
at the solve's tolerance, iterations within a quarter plus one major.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from ortools_tpu.mip.node_lp import PdhgNodeBackend as JNodeBackend
from ortools_tpu.models.lp import QuadraticProgram, random_lp
from ortools_tpu.ops import df32 as jdf32
from ortools_tpu.pdlp import PdhgParams as JParams
from ortools_tpu.pdlp import batched as JB
from ortools_tpu.pdlp import solver as J
from ortools_tpu.pdlp import trust_region as JT
from ortools_tpu.pdlp.params import OptimalityNorm as JNorm
from ortools_tpu.pdlp.params import RestartStrategy as JRestart

from ortools_tpu_torch.mip.node_lp import PdhgNodeBackend as TNodeBackend
from ortools_tpu_torch.models.lp import QuadraticProgram as TQuadraticProgram
from ortools_tpu_torch.ops import df32 as tdf32
from ortools_tpu_torch.pdlp import PdhgParams as TParams
from ortools_tpu_torch.pdlp import batched as TB
from ortools_tpu_torch.pdlp import convert
from ortools_tpu_torch.pdlp import solver as T
from ortools_tpu_torch.pdlp import trust_region as TT
from ortools_tpu_torch.pdlp.params import OptimalityNorm as TNorm
from ortools_tpu_torch.pdlp.params import RestartStrategy as TRestart

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)

RTOL = 1e-12
B = 4
JP64 = JParams(dtype=jnp.float64)
TP64 = TParams(dtype=torch.float64)


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
    """The power-iteration start of the JAX solves (batched.py:181)."""
    return np.array(jax.random.normal(
        jax.random.PRNGKey(0), (n_padded,), dtype=jnp.float64))


def assert_close(port, ref, what=""):
    """``port`` against ``ref``; a port [B, 1] scalar against JAX's [B]."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    port = np.asarray(port).reshape(ref.shape)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * (1 + np.abs(ref).max(initial=0)),
                               err_msg=what)


def assert_state_close(ts, js):
    for name in J.PdhgState._fields:
        assert_close(getattr(ts, name), getattr(js, name), name)


def assert_tree_close(t, j, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            assert_tree_close(t[k], j[k], f"{path}.{k}")
    else:
        assert_close(t, j, path)


def jax_batched_problem(jprob, lbs, ubs):
    """The batched problem of ``ortools_tpu.pdlp.batched.solve_batch``
    (:159-173): the instances' bounds, original and scaled, padded."""
    bsz, n = lbs.shape
    nn = jprob.c.shape[0]
    col_scale = np.asarray(jprob.col_scale, dtype=np.float64)

    def pad(vb):
        out = np.zeros((bsz, nn))
        out[:, :n] = vb
        return jnp.asarray(out, dtype=jprob.c.dtype)

    return jprob._replace(
        var_lb=pad(lbs / col_scale[:n]), var_ub=pad(ubs / col_scale[:n]),
        orig_var_lb=pad(lbs), orig_var_ub=pad(ubs))


# ---------------------------------------------------------------------------
# One shared batched f64 problem and state
# ---------------------------------------------------------------------------


def _instance_bounds(qp, seed=1):
    """B sets of variable bounds: the problem's own, then each tightened
    around a random point of the box (some upper bounds finite, some
    lower bounds raised)."""
    rng = np.random.default_rng(seed)
    n = qp.num_variables
    lbs = np.tile(qp.variable_lower, (B, 1))
    ubs = np.tile(qp.variable_upper, (B, 1))
    for i in range(1, B):
        pick = rng.random(n) < 0.4
        lo = np.where(np.isfinite(lbs[i]), lbs[i], -2.0)
        ubs[i] = np.where(pick, lo + rng.uniform(0.5, 2.0, n), ubs[i])
        raise_ = (rng.random(n) < 0.2) & np.isfinite(lbs[i])
        lbs[i] = np.where(raise_, lbs[i] + rng.uniform(0.0, 0.3, n), lbs[i])
    return lbs, ubs


@pytest.fixture(scope="module")
def shared():
    """A QP with two-sided rows, free and boxed variables (as the single
    solve's shared fixture), B instances with their own bounds, on which
    JAX ran its power iteration, initial state and 40 vmapped steps."""
    qp = random_lp(90, 70, density=0.1, seed=5)
    qp.constraint_lower = qp.constraint_upper - 3.0
    qp.variable_lower = np.where(np.arange(70) % 7 == 0, -np.inf, 0.0)
    qp.objective_matrix_diagonal = np.where(np.arange(70) % 3 == 0, 0.5, 0.0)
    lbs, ubs = _instance_bounds(qp)
    jprob = J.build_device_problem(qp, JP64)
    vprob = jax_batched_problem(jprob, lbs, ubs)
    axes = JB._prob_axes(jprob)
    v0 = jax_v0(jprob.c.shape[0])
    sigma = J._make_power_iter(JP64)(jprob, jnp.asarray(v0))
    jstate = jax.vmap(J._make_initial_state(JP64),
                      in_axes=(axes, None))(vprob, sigma)
    it = jax.jit(jax.vmap(J._make_iteration(JP64), in_axes=(axes, 0)))
    for _ in range(40):
        jstate = it(vprob, jstate)
    tprob = convert.device_problem_from_arrays(problem_arrays(vprob), "cpu")
    return dict(qp=qp, lbs=lbs, ubs=ubs, jprob=jprob, vprob=vprob,
                axes=axes, v0=v0, sigma=sigma, jstate=jstate, tprob=tprob,
                tstate=convert.state_from_arrays(state_arrays(jstate), "cpu",
                                                 batched=True))


def _vmap(fn, shared, *in_axes):
    return jax.vmap(fn, in_axes=(shared["axes"],) + in_axes)


def test_batched_state_crosses_with_per_instance_scalars(shared):
    ts = shared["tstate"]
    n = shared["tprob"].c.shape[0]
    assert ts.x.shape == (B, n) and ts.step_size.shape == (B, 1)
    assert ts.num_steps.dtype == torch.int32 and ts.num_steps.shape == (B, 1)
    # the instances differ
    assert len(set(ts.step_size[:, 0].tolist())) == B


def test_batched_initial_state_matches(shared):
    sigma = torch.tensor(np.asarray(shared["sigma"]))
    ts = T._make_initial_state(TP64)(shared["tprob"], sigma)
    js = _vmap(J._make_initial_state(JP64), shared, None)(
        shared["vprob"], shared["sigma"])
    assert ts.x.shape == tuple(js.x.shape)
    assert ts.step_size.shape == (B, 1)
    assert_state_close(ts, js)


def test_batched_power_iteration_matches(shared):
    """Each row of a [B, N] start runs its own power iteration."""
    rng = np.random.default_rng(3)
    v0 = rng.standard_normal((B, shared["jprob"].c.shape[0]))
    js = jax.vmap(J._make_power_iter(JP64), in_axes=(None, 0))(
        shared["jprob"], jnp.asarray(v0))
    tprob1 = convert.device_problem_from_arrays(
        problem_arrays(shared["jprob"]), "cpu")
    ts = T._make_power_iter(TP64)(tprob1, torch.tensor(v0))
    assert_close(ts, js)


def _big_steps(shared, which=(1, 3)):
    """The shared state with the step size of instances ``which`` 30 times
    too large, so that their first attempts are rejected."""
    js = shared["jstate"]
    scale = np.ones(B)
    scale[list(which)] = 30.0
    js = js._replace(step_size=js.step_size * jnp.asarray(scale))
    return js, convert.state_from_arrays(state_arrays(js), "cpu",
                                         batched=True)


@pytest.mark.parametrize("max_step_attempts", [40, 2])
def test_batched_major_with_rejections_in_some_instances_matches(
        shared, max_step_attempts):
    """One 16-step major: instances 1 and 3 reject more attempts than 0
    and 2 (with ``max_step_attempts=2`` they hit the cap); each instance is
    the vmapped attempt loop's."""
    js, ts = _big_steps(shared)
    jp = dataclasses.replace(JP64, termination_check_frequency=16,
                             max_step_attempts=max_step_attempts)
    tp = dataclasses.replace(TP64, termination_check_frequency=16,
                             max_step_attempts=max_step_attempts)
    jr = jax.jit(_vmap(J._make_run_major(jp), shared, 0))(shared["vprob"], js)
    tr = T._make_run_major(tp)(shared["tprob"], ts)
    attempts = np.asarray(jr.num_steps) - np.asarray(js.num_steps)
    accepted = np.asarray(jr.num_accepted) - np.asarray(js.num_accepted)
    assert np.all(accepted == 16)
    assert attempts[1] > 16 and attempts[3] > 16
    assert attempts[1] > attempts[0] and attempts[3] > attempts[2]
    if max_step_attempts == 2:
        assert np.all(attempts <= 32)
    np.testing.assert_array_equal(tr.num_steps.numpy()[:, 0],
                                  np.asarray(jr.num_steps))
    assert_state_close(tr, jr)


@pytest.mark.parametrize("big_step", [False, True])
def test_batched_mp_major_matches(shared, big_step):
    """A 16-step Malitsky-Pock major; with large steps in two instances
    their dual linesearch shrinks tau over several attempts."""
    js, ts = ((shared["jstate"], shared["tstate"]) if not big_step
              else _big_steps(shared))
    mp = dict(termination_check_frequency=16, linesearch_rule="malitsky_pock")
    jp = dataclasses.replace(JP64, **mp)
    tp = dataclasses.replace(TP64, **mp)
    jr = jax.jit(_vmap(J._make_run_major(jp), shared, 0))(shared["vprob"], js)
    tr = T._make_run_major(tp)(shared["tprob"], ts)
    if big_step:
        steps = np.asarray(jr.num_steps) - np.asarray(js.num_steps)
        assert steps[1] > steps[0] >= 16
    assert_state_close(tr, jr)


@pytest.mark.parametrize("norm", ["L2", "L_INF"])
@pytest.mark.parametrize("restart", ["ADAPTIVE_KKT", "ADAPTIVE_HEURISTIC"])
def test_batched_compute_stats_matches(shared, norm, restart):
    """Every statistic per instance, with the ``tr_*`` localized gaps
    under ADAPTIVE_HEURISTIC; the host gets them in one [K, B] copy."""
    jp = dataclasses.replace(JP64, optimality_norm=JNorm[norm],
                             restart_strategy=JRestart[restart])
    tp = dataclasses.replace(TP64, optimality_norm=TNorm[norm],
                             restart_strategy=TRestart[restart])
    js = _vmap(J._make_compute_stats(jp), shared, 0)(shared["vprob"],
                                                     shared["jstate"])
    ts = T._make_compute_stats(tp)(shared["tprob"], shared["tstate"])
    assert_tree_close(ts, js)
    if restart == "ADAPTIVE_HEURISTIC":
        assert set(ts["tr_current"]) == {"radius", "gap", "normalized_gap",
                                         "potential"}
    syncs = T.host_syncs
    groups, names, flat = T._stats_scalars(ts)
    assert flat.shape == (len(names), B)
    host = T._read_scalars(groups, names, flat)
    assert T.host_syncs == syncs + 1
    for group in ("current", "average", "infeas_diff", "infeas_current"):
        for k, v in host[group].items():
            assert v.shape == (B,)
            np.testing.assert_allclose(v, np.asarray(js[group][k]),
                                       rtol=RTOL, atol=RTOL)


def test_batched_apply_restart_with_mixed_choice_matches(shared):
    """Instances 0 and 2 restart to their average, 1 and 3 to their
    current iterate (a [B, 1] bool tensor, as JAX's jnp.where)."""
    use_avg = np.array([True, False, True, False])
    js = _vmap(J._make_compute_stats(JP64), shared, 0)(shared["vprob"],
                                                       shared["jstate"])
    ts = T._make_compute_stats(TP64)(shared["tprob"], shared["tstate"])
    jr = _vmap(J._make_apply_restart(JP64), shared, 0, 0, 0, 0)(
        shared["vprob"], shared["jstate"], jnp.asarray(use_avg),
        js["x_avg"], js["y_avg"])
    tr = T._make_apply_restart(TP64)(
        shared["tprob"], shared["tstate"], torch.tensor(use_avg[:, None]),
        ts["x_avg"], ts["y_avg"])
    assert_state_close(tr, jr)
    torch.testing.assert_close(tr.x[0], ts["x_avg"][0], rtol=0, atol=0)
    torch.testing.assert_close(tr.x[1], shared["tstate"].x[1], rtol=0,
                               atol=0)


def test_batched_final_iterate_matches(shared):
    js = shared["jstate"]
    jf = _vmap(J._make_final_iterate(JNorm.L2), shared, 0, 0)(
        shared["vprob"], js.x, js.y)
    tf = T._make_final_iterate(TNorm.L2)(
        shared["tprob"], shared["tstate"].x, shared["tstate"].y)
    assert_tree_close(tf, jf)


def test_batched_majors_stop_each_instance_at_its_iterations(shared):
    """Slots past an instance's last iteration change nothing in it: a
    tail run after the major leaves every buffer as it was."""
    js, ts = _big_steps(shared)
    tp = dataclasses.replace(TP64, termination_check_frequency=4)
    majors = T._Majors(shared["tprob"], tp)
    majors.load(ts)
    majors.major()
    assert majors.slots.accepted.shape == (B, 1)
    assert bool((majors.slots.accepted == 4).all())
    before = T._clone_slots(majors.slots)
    majors._tail(False)
    for a, b in zip(before.state, majors.state):
        assert torch.equal(a, b)


def test_batched_trust_region_matches_vmap():
    """``solve_joint_trust_region`` on [B, n] vectors with [B, 1] omega and
    radius, shared dual bounds, against vmap of the JAX function."""
    rng = np.random.default_rng(11)
    n, m = 7, 5
    gx, gy = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    x, y = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    lb, ub = x - rng.uniform(0.1, 2, (B, n)), x + rng.uniform(0.1, 2, (B, n))
    lb[rng.random((B, n)) < 0.3] = -np.inf
    ylb = np.where(rng.random(m) < 0.5, -np.inf, 0.0)
    yub = np.where(ylb == 0.0, np.inf, 0.0)
    y = np.clip(y, ylb, yub)
    omega = rng.uniform(0.3, 3, B)
    radius = np.array([0.3, 1.0, 100.0, 0.05])  # one ball inactive
    ref = jax.vmap(JT.solve_joint_trust_region,
                   in_axes=(0, 0, 0, 0, 0, 0, None, None, 0, 0))(
        *[jnp.asarray(v) for v in (gx, gy, x, y, lb, ub, ylb, yub, omega,
                                   radius)])
    got = TT.solve_joint_trust_region(
        *[torch.tensor(v) for v in (gx, gy, x, y, lb, ub, ylb, yub)],
        torch.tensor(omega[:, None]), torch.tensor(radius[:, None]))
    for a, b in zip(got, ref):
        assert a.shape == (B, 1)
        assert_close(a, b)


def test_batched_df32_reductions_match_vmap():
    rng = np.random.default_rng(0)
    big = rng.uniform(1e3, 1e4, size=(B, 1024)).astype(np.float32)
    x = np.concatenate([big, rng.uniform(-1, 1, (B, 1024)).astype(np.float32),
                        -big], axis=1)
    y = rng.standard_normal(x.shape).astype(np.float32)
    t_sum = tdf32.sum_df32(torch.from_numpy(x))
    t_dot = tdf32.vdot_df32(torch.from_numpy(x), torch.from_numpy(y))
    assert t_sum.shape == t_dot.shape == (B, 1)
    j_sum = jax.vmap(jdf32.sum_df32)(jnp.asarray(x))
    j_dot = jax.vmap(jdf32.vdot_df32)(jnp.asarray(x), jnp.asarray(y))
    exact_sum = x.astype(np.float64).sum(axis=1)
    exact_dot = (x.astype(np.float64) * y.astype(np.float64)).sum(axis=1)
    for got, ref in ((t_sum[:, 0].numpy(), exact_sum),
                     (t_dot[:, 0].numpy(), exact_dot),
                     (np.asarray(j_sum), exact_sum),
                     (np.asarray(j_dot), exact_dot)):
        ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(got - ref) <= ulp)
    # the 1-D forms are the single solve's calls
    assert torch.equal(tdf32.sum_df32(torch.from_numpy(x[1])), t_sum[1, 0])


# ---------------------------------------------------------------------------
# solve_batch against the JAX package's
# ---------------------------------------------------------------------------


def _infeasible_pair():
    """tests/test_mip.py:183: x1 + x2 >= 4 with x in [0,1]^2 (infeasible)
    and in [0,5]^2 (feasible, optimum 4)."""
    qp = QuadraticProgram(
        objective_vector=np.array([1.0, 1.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 1.0]])),
        constraint_lower=np.array([4.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.zeros(2),
        variable_upper=np.ones(2),
    )
    return qp, np.zeros((2, 2)), np.array([[1.0, 1.0], [5.0, 5.0]])


def _starved():
    """tests/test_mip.py:211: 40 iterations only."""
    rng = np.random.default_rng(7)
    m, n = 8, 14
    a = rng.standard_normal((m, n))
    qp = QuadraticProgram(
        objective_vector=rng.standard_normal(n),
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=a @ np.clip(rng.standard_normal(n), 0, 1) - 1.0,
        constraint_upper=np.full(m, np.inf),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )
    return qp, qp.variable_lower[None, :], qp.variable_upper[None, :]


def _random_batch():
    """Six instances of one random LP with their own bounds; instance 4
    forces x0 + x1 + x2 below the lower bound of a row that needs them
    (infeasible)."""
    rng = np.random.default_rng(21)
    m, n = 12, 18
    a = rng.uniform(0.0, 1.0, (m, n)) * (rng.random((m, n)) < 0.5)
    a[0, :3] = 1.0
    a[0, 3:] = 0.0
    x0 = rng.uniform(0.2, 0.8, n)
    qp = QuadraticProgram(
        objective_vector=rng.uniform(0.1, 1.0, n),
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=a @ x0,
        constraint_upper=np.full(m, np.inf),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )
    bsz = 6
    lbs = np.zeros((bsz, n))
    ubs = np.ones((bsz, n))
    for i in range(1, bsz):
        cut = rng.random(n) < 0.25
        ubs[i, cut] = rng.uniform(0.85, 1.0, cut.sum())
        up = rng.random(n) < 0.2
        lbs[i, up] = rng.uniform(0.0, 0.15, up.sum())
    ubs[4, :3] = 0.1  # row 0 needs x0 + x1 + x2 >= a[0] @ x0 > 0.3
    return qp, lbs, ubs


def highs(qp, lb, ub):
    qp = qp.as_minimization()
    a = sp.csr_matrix(qp.constraint_matrix)
    res = linprog(qp.objective_vector, A_ub=-a,
                  b_ub=-qp.constraint_lower, bounds=list(zip(lb, ub)),
                  method="highs")
    return res.status, (res.fun if res.status == 0 else None)


def _both(qp, lbs, ubs, **kw):
    jp = JParams(dtype=jnp.float64, **kw)
    tp = TParams(dtype=torch.float64, **kw)
    jr = JB.solve_batch(qp, lbs, ubs, jp)
    n_padded = -(-max(qp.num_variables, 1) // 128) * 128
    tr = TB.solve_batch(port_qp(qp), lbs, ubs, tp, device="cpu",
                        v0=jax_v0(n_padded))
    return jp, jr, tr


def _assert_batch_like_jax(jp, jr, tr):
    for flag in ("optimal", "primal_infeasible", "dual_infeasible"):
        np.testing.assert_array_equal(getattr(tr, flag), getattr(jr, flag),
                                      err_msg=flag)
    freq = jp.termination_check_frequency
    if jr.iterations <= freq:
        assert tr.iterations == jr.iterations
    else:
        assert abs(tr.iterations - jr.iterations) <= jr.iterations // 4 + freq
    assert tr.primal_solution.shape == jr.primal_solution.shape
    assert tr.dual_solution.shape == jr.dual_solution.shape
    for i in np.nonzero(jr.optimal)[0]:
        ref_p, ref_d = jr.primal_objective[i], jr.dual_objective[i]
        assert abs(tr.primal_objective[i] - ref_p) <= 1e-5 * (1 + abs(ref_p))
        assert abs(tr.dual_objective[i] - ref_d) <= 1e-5 * (1 + abs(ref_p))
        assert tr.dual_bound[i] <= ref_p + 1e-5 * (1 + abs(ref_p))


def test_solve_batch_certifies_the_infeasible_instance_like_jax():
    """tests/test_mip.py:183 on the port, against JAX's solve_batch."""
    qp, lbs, ubs = _infeasible_pair()
    jp, jr, tr = _both(qp, lbs, ubs, iteration_limit=20_000)
    assert bool(tr.primal_infeasible[0])
    assert not bool(tr.primal_infeasible[1])
    assert bool(tr.optimal[1])
    assert tr.primal_objective[1] == pytest.approx(4.0, abs=1e-4)
    assert tr.dual_bound[1] <= 4.0 + 1e-4
    _assert_batch_like_jax(jp, jr, tr)


def test_solve_batch_dual_bound_of_a_starved_solve_like_jax():
    """tests/test_mip.py:211 on the port: after 40 iterations the dual
    bound still lies below the HiGHS optimum; one major, so the port's
    numbers are JAX's to 1e-9."""
    qp, lbs, ubs = _starved()
    _, ref = highs(qp, lbs[0], ubs[0])
    jp, jr, tr = _both(qp, lbs, ubs, iteration_limit=40,
                       termination_check_frequency=40)
    assert tr.dual_bound[0] <= ref + 1e-6
    assert tr.iterations == jr.iterations == 40
    for k in ("primal_objective", "dual_objective", "dual_bound"):
        np.testing.assert_allclose(getattr(tr, k), getattr(jr, k), rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(tr.primal_solution, jr.primal_solution,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("restart", ["ADAPTIVE_KKT", "ADAPTIVE_HEURISTIC"])
def test_solve_batch_random_instances_like_jax_and_highs(restart):
    """Six instances with their own bounds, instance 4 infeasible: the
    flags are JAX's, and every optimal objective is HiGHS's on the same
    bounds, with its dual bound below."""
    qp, lbs, ubs = _random_batch()
    kw = dict(iteration_limit=40_000)
    jp = JParams(dtype=jnp.float64, restart_strategy=JRestart[restart], **kw)
    tp = TParams(dtype=torch.float64, restart_strategy=TRestart[restart],
                 **kw)
    jr = JB.solve_batch(qp, lbs, ubs, jp)
    tr = TB.solve_batch(port_qp(qp), lbs, ubs, tp, device="cpu",
                        v0=jax_v0(128))
    assert bool(tr.primal_infeasible[4])
    assert tr.optimal.sum() == len(lbs) - 1
    _assert_batch_like_jax(jp, jr, tr)
    for i in np.nonzero(tr.optimal)[0]:
        status, ref = highs(qp, lbs[i], ubs[i])
        assert status == 0
        assert abs(tr.primal_objective[i] - ref) <= 1e-4 * (1 + abs(ref))
        assert tr.dual_bound[i] <= ref + 1e-4 * (1 + abs(ref))
    assert highs(qp, lbs[4], ubs[4])[0] == 2  # HiGHS: infeasible too


def test_solve_batch_with_warm_start_like_jax():
    """Warm starts in the original space, clipped to each instance's box."""
    qp, lbs, ubs = _random_batch()
    rng = np.random.default_rng(2)
    wx = rng.uniform(-0.2, 1.2, lbs.shape)
    wy = rng.uniform(0.0, 0.5, (len(lbs), qp.num_constraints))
    jp = JParams(dtype=jnp.float64, iteration_limit=40_000)
    tp = TParams(dtype=torch.float64, iteration_limit=40_000)
    jr = JB.solve_batch(qp, lbs, ubs, jp, warm_start_x=wx, warm_start_y=wy)
    tr = TB.solve_batch(port_qp(qp), lbs, ubs, tp, warm_start_x=wx,
                        warm_start_y=wy, device="cpu", v0=jax_v0(128))
    _assert_batch_like_jax(jp, jr, tr)


def test_batch_solver_start_matches_jax_warm_state():
    """The port's warm-started batch state is JAX's (batched.py:184-195)."""
    qp, lbs, ubs = _random_batch()
    rng = np.random.default_rng(2)
    wx = rng.uniform(-0.2, 1.2, lbs.shape)
    wy = rng.uniform(0.0, 0.5, (len(lbs), qp.num_constraints))
    jprob = J.build_device_problem(qp.as_minimization(), JP64)
    vprob = jax_batched_problem(jprob, lbs, ubs)
    axes = JB._prob_axes(jprob)
    sigma = J._make_power_iter(JP64)(jprob, jnp.asarray(jax_v0(128)))
    js = jax.vmap(J._make_initial_state(JP64), in_axes=(axes, None))(
        vprob, sigma)
    col = np.asarray(jprob.col_scale)
    row = np.asarray(jprob.row_scale)
    xw = np.zeros((len(lbs), 128))
    xw[:, :qp.num_variables] = np.clip(wx, lbs, ubs)
    yw = np.zeros((len(lbs), 128))
    yw[:, :qp.num_constraints] = wy
    xs, ys = jnp.asarray(xw / col), jnp.asarray(yw / row)
    ax, aty = jax.vmap(lambda p, x, y: (p.a.matvec(x), p.at.matvec(y)),
                       in_axes=(axes, 0, 0))(vprob, xs, ys)
    js = js._replace(x=xs, y=ys, ax=ax, aty=aty, x_restart=xs, y_restart=ys)
    solver = TB.BatchSolver(port_qp(qp), TP64, len(lbs), device="cpu",
                            v0=jax_v0(128))
    solver._start(lbs, ubs, wx, wy)
    assert_state_close(solver.majors.state, js)


# ---------------------------------------------------------------------------
# PdhgNodeBackend
# ---------------------------------------------------------------------------


def _assert_nodes_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


def test_node_backend_pads_a_short_batch_like_jax():
    """Three nodes on a backend of batch size 8: padded by repeating the
    first node; the results are JAX's backend's."""
    qp, lbs, ubs = _random_batch()
    qp = qp.as_minimization()
    nodes = [0, 2, 4]
    jb = JNodeBackend(qp, JParams(dtype=jnp.float64, iteration_limit=40_000),
                      8)
    tb = TNodeBackend(port_qp(qp), TParams(dtype=torch.float64,
                                           iteration_limit=40_000), 8,
                      device="cpu", v0=jax_v0(128))
    jr = jb.solve(lbs[nodes], ubs[nodes])
    tr = tb.solve(lbs[nodes], ubs[nodes])
    assert tr.primal_solution.shape == (3, qp.num_variables)
    assert tr.dual_solution.shape == (3, qp.num_constraints)
    np.testing.assert_array_equal(tr.optimal, jr.optimal)
    np.testing.assert_array_equal(tr.primal_infeasible, jr.primal_infeasible)
    assert not tr.skipped.any()
    assert list(tr.primal_infeasible) == [False, False, True]
    for i in np.nonzero(tr.optimal)[0]:
        _, ref = highs(qp, lbs[nodes[i]], ubs[nodes[i]])
        assert tr.dual_bound[i] <= ref + 1e-4 * (1 + abs(ref))
        np.testing.assert_allclose(tr.primal_solution[i],
                                   jr.primal_solution[i], atol=1e-3)


def test_node_backend_second_call_gives_a_fresh_backends_result():
    """The backend keeps its solver (scaled problem, σ_max, majors)
    across calls; a call after another batch, with warm starts, is bit
    for bit what a fresh backend gives."""
    qp, lbs, ubs = _random_batch()
    qp = port_qp(qp.as_minimization())
    tp = TParams(dtype=torch.float64, iteration_limit=40_000)
    rng = np.random.default_rng(5)
    wx = rng.uniform(0.0, 1.0, (4, qp.num_variables))
    wy = rng.uniform(0.0, 0.3, (4, qp.num_constraints))
    kept = TNodeBackend(qp, tp, 6, device="cpu")
    kept.solve(lbs, ubs)
    solver = kept._solver
    second = kept.solve(lbs[2:], ubs[2:], warm_x=wx, warm_y=wy)
    assert kept._solver is solver
    fresh = TNodeBackend(qp, tp, 6, device="cpu").solve(
        lbs[2:], ubs[2:], warm_x=wx, warm_y=wy)
    _assert_nodes_equal(second, fresh)
    assert second.optimal.sum() == 3 and second.primal_infeasible[2]


def test_node_backend_keeps_its_solver_across_iteration_limits():
    """The branch-and-bound raises only ``iteration_limit`` (×4 per retry):
    the backend keeps its ``BatchSolver``; the raised call is bit for bit
    a fresh backend's on the raised params, and JAX's backend's on them."""
    qp, lbs, ubs = _random_batch()
    qp = qp.as_minimization()
    tqp = port_qp(qp)
    low = TParams(dtype=torch.float64, iteration_limit=10_000)
    high = dataclasses.replace(low, iteration_limit=4 * low.iteration_limit)
    kept = TNodeBackend(tqp, low, 6, device="cpu", v0=jax_v0(128))
    kept.solve(lbs, ubs)
    solver = kept._solver
    raised = kept.solve(lbs, ubs, lp_params=high)
    assert kept._solver is solver
    assert solver.params == low
    fresh = TNodeBackend(tqp, high, 6, device="cpu", v0=jax_v0(128))
    _assert_nodes_equal(raised, fresh.solve(lbs, ubs))
    # another field than the limit builds a new solver
    kept.solve(lbs, ubs, lp_params=dataclasses.replace(
        high, termination_check_frequency=32))
    assert kept._solver is not solver
    jr = JNodeBackend(qp, JParams(dtype=jnp.float64, iteration_limit=40_000),
                      6).solve(lbs, ubs)
    np.testing.assert_array_equal(raised.optimal, jr.optimal)
    np.testing.assert_array_equal(raised.primal_infeasible,
                                  jr.primal_infeasible)
    assert bool(raised.primal_infeasible[4])
    for i in np.nonzero(raised.optimal)[0]:
        _, ref = highs(qp, lbs[i], ubs[i])
        assert raised.dual_bound[i] <= ref + 1e-4 * (1 + abs(ref))
        np.testing.assert_allclose(raised.primal_solution[i],
                                   jr.primal_solution[i], atol=1e-3)
