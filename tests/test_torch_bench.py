"""The bench port (``bench_torch.py``, ``bench_large_torch.py``,
``bench_miplib_torch.py``) against the JAX package's bench scripts.

The scripts' ``main`` runs on the card only; their functions take
``device``, and here they run on the CPU at small sizes (the kernel
wrappers then run their plain versions and the majors their attempt slots
eagerly).  The timed body is held against ``bench.py``'s in f64 at rtol
1e-12 over one major of 64 accepted steps: over two, the adaptive step
rule amplifies the two packages' different rounding past that
(ROADMAP's parity rules).
"""

import importlib
import io
import json
import re
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.models.generators import block_random_lp as jblock_random_lp
from ortools_tpu.pdlp import solver as J
from ortools_tpu.pdlp.params import PdhgParams as JParams

from ortools_tpu_torch.models.generators import block_random_lp
from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.pdlp import convert
from ortools_tpu_torch.pdlp import solver as T
from ortools_tpu_torch.pdlp.params import PdhgParams as TParams
from ortools_tpu_torch.utils.status import MPSolverStatus

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

bench_torch = importlib.import_module("bench_torch")
bench_large_torch = importlib.import_module("bench_large_torch")
bench_miplib_torch = importlib.import_module("bench_miplib_torch")

CPU = torch.device("cpu")
RTOL = 1e-12
BLOCK = (8, 128)
JP64 = JParams(dtype=jnp.float64, block_shape=BLOCK)
TP64 = TParams(dtype=torch.float64, block_shape=BLOCK)


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


def jax_bench_body(jprob, jstate, majors: int):
    """bench.py:110-117: a fori_loop of ``_make_run_major`` majors."""
    major = J._make_run_major(JP64)
    return jax.jit(lambda p, s: jax.lax.fori_loop(
        0, majors, lambda _, st: major(p, st), s))(jprob, jstate)


def shared_start(m, n, num_blocks, seed):
    """One f64 LP and one host σ, in both packages: the JAX problem and
    initial state, and the port's majors loaded with the same start."""
    qp = jblock_random_lp(m, n, num_blocks, BLOCK, seed=seed)
    sigma = bench_torch.host_sigma(qp)
    jprob = J.build_device_problem(qp, JP64)
    jstate = J._make_initial_state(JP64)(jprob, jnp.asarray(sigma))
    tprob = convert.device_problem_from_arrays(problem_arrays(jprob), "cpu")
    majors = bench_torch.load_majors(tprob, TP64,
                                     torch.tensor(sigma, dtype=torch.float64))
    return jprob, jstate, majors


@pytest.mark.parametrize("m,n,num_blocks,seed",
                         [(64, 256, 8, 0), (256, 256, 32, 1),
                          (512, 384, 40, 2)])
def test_host_sigma_is_bench_py_formula(m, n, num_blocks, seed):
    qp = block_random_lp(m, n, num_blocks, BLOCK, seed=seed)
    # bench.py:122-126, as it stands
    a_csr = sp.csr_matrix(abs(qp.constraint_matrix))
    norm_inf = float(a_csr.sum(axis=1).max())
    norm_1 = float(a_csr.sum(axis=0).max())
    ref = np.sqrt(norm_inf * norm_1)
    got = bench_torch.host_sigma(qp)
    assert got == ref
    assert got == bench_torch.host_sigma(
        jblock_random_lp(m, n, num_blocks, BLOCK, seed=seed))


def test_headline_body_matches_bench_py():
    """One timed major: the port's main-graph body (64 attempt slots) and
    bench.py's major (64 accepted steps) are the same computation when
    every attempt is accepted."""
    jprob, jstate, majors = shared_start(128, 256, 8, seed=6)
    acc0 = int(majors.state.num_accepted)
    bench_torch.run_block(majors, False, 1)
    ts = majors.state
    assert int(ts.num_accepted) - acc0 == 64 * 1
    assert int(ts.num_steps) == 64
    js = jax_bench_body(jprob, jstate, 1)
    for name in J.PdhgState._fields:
        ref = np.asarray(getattr(js, name))
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), ref, rtol=RTOL,
            atol=RTOL * (1 + np.abs(ref).max(initial=0)), err_msg=name)


def test_rate_counts_accepted_iterations_not_slots():
    """With rejected attempts a main graph accepts fewer than its 64
    slots: the reported count is Δnum_accepted, the attempts Δnum_steps."""
    _, _, majors = shared_start(64, 256, 8, seed=5)
    _, _, twin = shared_start(64, 256, 8, seed=5)
    bench_torch.run_block(twin, False, 1)  # the warm-up block
    acc0, steps0 = bench_torch.counts(twin.state)
    bench_torch.run_block(twin, False, 1)  # the timed block
    acc1, steps1 = bench_torch.counts(twin.state)
    accepted = int((acc1 - acc0).sum())
    assert accepted < 64 and int((steps1 - steps0).sum()) == 64
    out = bench_torch.timed_blocks(majors, False, 1, 1, "seed 5")
    assert out["accepted"] == accepted
    assert out["attempts"] == 64
    assert out["rate"] == accepted / out["seconds"]


def test_batched_body_gives_equal_rows_and_sums_the_instances(monkeypatch):
    for name, v in (("BATCH", 4), ("BATCH_MAJORS", 1), ("TIMING_REPS", 1)):
        monkeypatch.setattr(bench_torch, name, v)
    qp = block_random_lp(128, 256, 8, BLOCK, seed=6)
    params = TParams(dtype=torch.float64, block_shape=BLOCK)
    prob = T.build_device_problem(qp, params, CPU)
    sigma = torch.tensor(bench_torch.host_sigma(qp), dtype=torch.float64)
    out = bench_torch.batched_rate(prob, params, sigma)
    # the same blocks run alone: warm-up, then the timed block
    majors = bench_torch.load_majors(bench_torch.batched_problem(prob, 4),
                                     params, sigma)
    bench_torch.run_block(majors, False, 1)
    acc0, _ = bench_torch.counts(majors.state)
    bench_torch.run_block(majors, False, 1)
    acc1, _ = bench_torch.counts(majors.state)
    assert bench_torch.rows_equal(majors.state)
    assert acc0.shape == (4,) and len(set(acc1 - acc0)) == 1
    assert out["accepted"] == int((acc1 - acc0).sum()) == 4 * 64
    single = bench_torch.load_majors(prob, params, sigma)
    bench_torch.run_block(single, False, 2)
    assert int(single.state.num_accepted) == int(acc1[0])


def test_rows_equal_sees_one_instance_apart():
    qp = block_random_lp(64, 256, 8, BLOCK, seed=0)
    params = TParams(dtype=torch.float64, block_shape=BLOCK)
    prob = T.build_device_problem(qp, params, CPU)
    majors = bench_torch.load_majors(
        bench_torch.batched_problem(prob, 3), params,
        torch.tensor(bench_torch.host_sigma(qp), dtype=torch.float64))
    assert bench_torch.rows_equal(majors.state)
    majors.state.x[2, 0] += 1.0
    assert not bench_torch.rows_equal(majors.state)


def test_chain_is_repeated_scaled_products():
    qp = block_random_lp(256, 256, 16, BLOCK, seed=3)
    params = TParams(dtype=torch.float32, block_shape=BLOCK,
                     use_tiled_spmv=True)
    prob = T.build_device_problem(qp, params, CPU)
    a = prob.a.to_dense().astype(np.float64)
    x0 = bench_torch.chain_start(prob)
    inv = 0.5
    y = bench_torch.chain(lambda v: prob.a.matvec(v), x0,
                          torch.tensor(inv), 3)
    ref = x0.double().numpy()
    for _ in range(3):
        ref = (a @ ref) * inv
    np.testing.assert_allclose(y.double().numpy(), ref,
                               rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _jax_spmv_keys() -> set:
    """The keys bench.py's main puts in its ``spmv`` object."""
    src = (ROOT / "bench.py").read_text()
    literal = re.search(r"spmv = \{(.*?)\}", src, re.S).group(1)
    return (set(re.findall(r'"(\w+)":', literal))
            | set(re.findall(r'spmv\["(\w+)"\]', src)))


def test_emit_has_bench_py_keys_and_only_the_named_additions(monkeypatch):
    bench = importlib.import_module("bench")
    stub_jax = types.SimpleNamespace(devices=lambda: ["TPU_0"])
    jspmv = {k: 1.0 for k in _jax_spmv_keys()}
    with redirect_stdout(io.StringIO()) as f:
        bench._emit(1.0, 2.0, 3.0, 10, stub_jax, 4.0, jspmv)
    jout = json.loads(f.getvalue())

    qp = block_random_lp(256, 256, 16, BLOCK, seed=6)
    params = TParams(dtype=torch.float32, block_shape=BLOCK,
                     use_tiled_spmv=True)
    prob = T.build_device_problem(qp, params, CPU)
    for name, v in (("KERNEL_SPMV_ITERS", 2), ("STREAM_SHAPE", (16, 16)),
                    ("FLOOR_LAUNCHES", 2)):
        monkeypatch.setattr(bench_torch, name, v)
    spmv = bench_torch.spmv_numbers(prob, bench_torch.host_sigma(qp), CPU)
    with redirect_stdout(io.StringIO()) as f:
        out = bench_torch._emit(1.0, 2.0, 3.0, 10, "card", 700.0, 4.0, spmv,
                                {"exact": 1.0, "fast": 1.0})
    assert json.loads(f.getvalue()) == out
    assert set(out) - set(jout) == {"power_limit_w",
                                    "attempts_per_iteration"}
    assert set(jout) <= set(out)
    assert set(out["spmv"]) - set(jout["spmv"]) == {"launch_floor_us"}
    assert set(jout["spmv"]) <= set(out["spmv"])
    assert set(out["spmv"]["launch_floor_us"]) == {
        "block_spmv_exact", "block_spmv_fast", "block_spmm_exact"}
    for k in ("metric", "unit", "baseline_cpu_iter_per_sec_pinned"):
        assert out[k] == jout[k]
    assert out["problem"] == jout["problem"]
    assert out["device"] == "card"


def test_large_sigma_is_the_power_iteration_from_its_start():
    """σ of bench_large_torch: the solver's power iteration from the
    seeded torch start, equal to JAX's power iteration from that start."""
    qp = jblock_random_lp(128, 256, 8, BLOCK, seed=1)
    jprob = J.build_device_problem(qp, JP64)
    tprob = convert.device_problem_from_arrays(problem_arrays(jprob), "cpu")
    sigma = bench_large_torch.power_iteration_sigma(tprob, TP64)
    gen = torch.Generator(device="cpu").manual_seed(bench_large_torch.SEED)
    v0 = torch.randn(tprob.c.shape[0], generator=gen, dtype=torch.float64)
    ref = J._make_power_iter(JP64)(jprob, jnp.asarray(v0.numpy()))
    np.testing.assert_allclose(float(sigma), float(ref), rtol=RTOL)


# ---------------------------------------------------------------------------
# bench_miplib_torch.instance_record
# ---------------------------------------------------------------------------


def _mip(maximize=False) -> QuadraticProgram:
    """x0 + x1 + y <= 3 (x binary, y continuous in [0, 2]); objective
    x0 + 2 x1 + y (minimized, or maximized)."""
    return QuadraticProgram(
        objective_vector=np.array([1.0, 2.0, 1.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 1.0, 1.0]])),
        constraint_lower=np.array([-np.inf]),
        constraint_upper=np.array([3.0]),
        variable_lower=np.zeros(3),
        variable_upper=np.array([1.0, 1.0, 2.0]),
        integrality=np.array([True, True, False]),
        maximize=maximize, name="tiny")


def _result(status, x, obj):
    return types.SimpleNamespace(status=status, solution=np.asarray(x),
                                 objective_value=obj, num_nodes=7)


def _highs(fun, status=0):
    return types.SimpleNamespace(fun=fun, status=status)


OPT, FEAS = MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE
RECORD_CASES = {
    # ours 1.0 beats HiGHS's 1.5 at its limit
    "better_than_highs": (False, _result(FEAS, [1, 0, 0], 1.0), _highs(1.5),
                          dict(obj=1.0, highs_obj=1.5, matched=True,
                               feasible=True, status="FEASIBLE")),
    # the row is violated: no objective, not matched
    "infeasible_x": (False, _result(OPT, [1, 1, 2], 5.0), _highs(0.0),
                     dict(obj=None, highs_obj=0.0, matched=False,
                          feasible=False)),
    # x1 = 0.5 on a binary
    "non_integral_x": (False, _result(OPT, [0, 0.5, 0], 1.0), _highs(0.0),
                       dict(obj=None, matched=False, feasible=False)),
    # HiGHS found nothing (status 2): no reference, not matched
    "nan_reference": (False, _result(OPT, [0, 0, 0], 0.0),
                      _highs(None, status=2),
                      dict(obj=0.0, highs_obj=None, matched=False,
                           feasible=True)),
    # maximize: our 4 (original sense) is -4 in milp's sense, as good as
    # HiGHS's -4
    "maximization": (True, _result(OPT, [1, 1, 1], 4.0), _highs(-4.0),
                     dict(obj=-4.0, highs_obj=-4.0, matched=True,
                          feasible=True)),
    "maximization_worse": (True, _result(FEAS, [1, 0, 1], 2.0), _highs(-4.0),
                           dict(obj=-2.0, matched=False, feasible=True)),
    # no solution: nothing to check
    "not_solved": (False, _result(MPSolverStatus.NOT_SOLVED, [0, 0, 0],
                                  float("nan")), _highs(0.0),
                   dict(obj=None, matched=False, feasible=None,
                        status="NOT_SOLVED")),
}


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_instance_record(case):
    maximize, result, highs, want = RECORD_CASES[case]
    rec = bench_miplib_torch.instance_record(_mip(maximize), result, highs,
                                             2.345)
    assert set(rec) == {"name", "n_bin", "status", "obj", "highs_obj",
                        "matched", "feasible", "nodes", "sec"}
    assert rec["name"] == "tiny" and rec["n_bin"] == 2
    assert rec["nodes"] == 7 and rec["sec"] == 2.3
    for k, v in want.items():
        assert rec[k] == v, (k, rec)


def test_instance_record_matches_highs_on_the_battery():
    """A battery MIP solved by milp itself is matched, with its own
    objective."""
    from ortools_tpu_torch.models.mip_generators import miplib_like_battery

    qp = miplib_like_battery(0.3)[0]
    s = bench_miplib_torch.highs(qp, 30.0)
    assert s.status == 0
    result = _result(OPT, s.x, (-1.0 if qp.maximize else 1.0) * s.fun)
    rec = bench_miplib_torch.instance_record(qp, result, s, 1.0)
    assert rec["matched"] and rec["feasible"]
    assert rec["obj"] == rec["highs_obj"] == round(s.fun, 6)
