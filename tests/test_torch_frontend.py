"""The port's modelling front end against the JAX package's, on the CPU.

``linear_solver`` (``Model``/``Solver``), ``math_opt``, ``models/mps.py``
and the CLI of ``ortools_tpu_torch`` run with ``device="cpu"`` (the pdlp
and mip routes then solve in float64) against ``ortools_tpu``'s under x64
(tests/conftest.py), on the same models:

- pdlp: the same status, objectives within ten times the solve's relative
  tolerance (1e-6), values, duals and reduced costs within
  1e-4·(1 + their largest magnitude), and iteration counts within a
  quarter or one major of 64 (ROADMAP's parity rules: XLA and torch sum in
  another order, and a count moves by whole majors);
- glop: bit for bit (both run copies of one host simplex);
- mip: the same status and objectives within 1e-9·(1+|obj|).
"""

import dataclasses
import gzip
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ortools_tpu.pdlp as JP
from ortools_tpu import cli as JCLI
from ortools_tpu import linear_solver as JLS
from ortools_tpu import math_opt as JMO
from ortools_tpu.math_opt import model as JMOM
from ortools_tpu.models import mps as JMPS
from ortools_tpu.models.lp import random_lp

import ortools_tpu_torch.pdlp as TP
from ortools_tpu_torch import cli as TCLI
from ortools_tpu_torch import linear_solver as TLS
from ortools_tpu_torch import math_opt as TMO
from ortools_tpu_torch.math_opt import model as TMOM
from ortools_tpu_torch.models import mps as TMPS

from tests.test_torch_mip_host import assert_same
from tests.test_torch_presolve import port_qp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PDLP_TOL = 1e-6  # PdhgParams' eps_optimal_absolute and _relative


def _solver(ls, backend):
    return (ls.Solver(backend, device="cpu") if ls is TLS
            else ls.Solver(backend))


# ---------------------------------------------------------------------------
# Models, each built the same way through either package
# ---------------------------------------------------------------------------


def sample_model(ls):
    """tests/test_linear_solver.py's: max 3x + 4y, optimum 34 at (6, 4)."""
    m = ls.Model("sample")
    x = m.new_num_var(0, math.inf, "x")
    y = m.new_num_var(0, math.inf, "y")
    m.add(x + 2 * y <= 14)
    m.add(3 * x - y >= 0)
    m.add(x - y <= 2)
    m.maximize(3 * x + 4 * y)
    return m


def duals_model(ls):
    """tests/test_linear_solver.py's dual-value case."""
    m = ls.Model("duals")
    x = m.new_num_var(0, 10, "x")
    y = m.new_num_var(0, 10, "y")
    m.add(x + y <= 4)
    m.minimize(-x - 2 * y)
    return m


def offset_model(ls):
    """Offsets in rows and the objective, an equality and a range row."""
    m = ls.Model("offsets")
    x = m.new_num_var(-2, 8, "x")
    y = m.new_num_var(0, 5, "y")
    z = m.new_num_var(1, math.inf, "z")
    m.add(2 * x - y + 3 == 7)
    m.add_linear_constraint(x + y + z, 2, 9)
    m.add(ls.LinearExpr.weighted_sum([x, y, z], [1, 2, -1]) >= -4)
    m.minimize(x + 3 * y + 2 * z - 5)
    return m


def random_model(ls, seed):
    """``random_lp`` (bounded, feasible) as a Model."""
    qp = random_lp(30, 20, density=0.3, seed=seed)
    return ls.Model.from_qp(qp if ls is JLS else port_qp(qp))


def knapsack_model(ls):
    """tests/test_linear_solver.py's integer dispatch case."""
    m = ls.Model("knap")
    xs = [m.new_bool_var(f"x{i}") for i in range(8)]
    m.add(ls.LinearExpr.weighted_sum(xs, [3, 5, 7, 2, 8, 4, 6, 1]) <= 15)
    m.maximize(ls.LinearExpr.weighted_sum(xs, [4, 6, 9, 2, 10, 5, 7, 1]))
    return m


def mixed_model(ls):
    """A mixed-integer model: two integer variables, two continuous."""
    rng = np.random.default_rng(7)
    m = ls.Model("mixed")
    xs = [m.new_var(0, 5, k < 2, f"v{k}") for k in range(4)]
    a = rng.standard_normal((6, 4))
    x0 = rng.uniform(0, 3, size=4)
    b = a @ x0 + rng.uniform(0.2, 1.0, size=6)
    for i in range(6):
        m.add(ls.LinearExpr.weighted_sum(xs, a[i].tolist()) <= float(b[i]))
    m.minimize(ls.LinearExpr.weighted_sum(xs,
                                          rng.standard_normal(4).tolist()))
    return m


LP_MODELS = {"sample": sample_model, "duals": duals_model,
             "offsets": offset_model,
             "random0": lambda ls: random_model(ls, 0),
             "random1": lambda ls: random_model(ls, 1)}
MIP_MODELS = {"knapsack": knapsack_model, "mixed": mixed_model}


# ---------------------------------------------------------------------------
# Model building and MPS I/O
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LP_MODELS) + sorted(MIP_MODELS))
def test_model_to_qp_and_mps_text_match(name):
    build = {**LP_MODELS, **MIP_MODELS}[name]
    jm, tm = build(JLS), build(TLS)
    jq, tq = jm.to_qp(), tm.to_qp()
    assert type(tq).__module__.startswith("ortools_tpu_torch")
    assert_same(jq, tq)
    assert jm.export_to_mps_string() == tm.export_to_mps_string()


def test_expressions_and_offset_folding():
    for ls in (JLS, TLS):
        m = ls.Model()
        x = m.new_num_var(0, 1, "x")
        y = m.new_num_var(0, 1, "y")
        e = 2 * x - y / 2 + 3 - 1
        assert e.coeffs == {0: 2.0, 1: -0.5} and e.offset == 2.0
        assert ls.LinearExpr.sum([x, y, 5]).offset == 5.0
        assert ls.LinearExpr.weighted_sum([x, y], [2, 3]).coeffs == {
            0: 2.0, 1: 3.0}
        ct = m.add(x + 3 <= 5)
        assert m.ct_ub[ct.index] == 2.0
        with pytest.raises(TypeError):
            x * y
        with pytest.raises(TypeError):
            m.add(True)


@pytest.mark.parametrize("gz", [False, True])
def test_mps_files_read_the_same(tmp_path, gz):
    """Each package writes a file of a mixed-integer model and of a random
    LP, the same bytes; both packages read every file (gzipped too) to the
    same QuadraticProgram."""
    paths = []
    for k, qp in enumerate((mixed_model(JLS).to_qp(),
                            random_lp(12, 9, density=0.4, seed=4))):
        for pkg, mod in (("jax", JMPS), ("port", TMPS)):
            path = tmp_path / f"m{k}_{pkg}.mps"
            mod.write_mps(qp if mod is JMPS else port_qp(qp), str(path))
            paths.append(path)
        assert paths[-2].read_bytes() == paths[-1].read_bytes()
    if gz:
        for k, path in enumerate(paths):
            paths[k] = path.with_suffix(".mps.gz")
            paths[k].write_bytes(gzip.compress(path.read_bytes()))
    for path in paths:
        jq, tq = JMPS.read_mps(str(path)), TMPS.read_mps(str(path))
        assert_same(jq, tq)
    with pytest.raises(TMPS.MpsError):
        TMPS.read_mps("NAME x\nBOGUS\n", is_text=True)


# ---------------------------------------------------------------------------
# Solver: pdlp, glop, mip
# ---------------------------------------------------------------------------


@pytest.fixture
def pdlp_results(monkeypatch):
    """Records each package's pdlp SolveResult behind its Solver."""
    seen = {}

    def spy(pkg, mod):
        inner = mod.solve

        def solve(*args, **kw):
            seen[pkg] = r = inner(*args, **kw)
            return r
        monkeypatch.setattr(mod, "solve", solve)

    spy("jax", JP)
    spy("port", TP)
    return seen


def _close(a, b, tol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    scale = 1.0 + max(float(np.max(np.abs(a), initial=0.0)),
                      float(np.max(np.abs(b), initial=0.0)))
    return float(np.max(np.abs(a - b), initial=0.0)) <= tol * scale


@pytest.mark.parametrize("name", sorted(LP_MODELS))
def test_pdlp_solver_matches(name, pdlp_results):
    jm, tm = LP_MODELS[name](JLS), LP_MODELS[name](TLS)
    js, ts = _solver(JLS, "pdlp"), _solver(TLS, "pdlp")
    jst, tst = js.solve(jm), ts.solve(tm)
    jr, tr = pdlp_results["jax"], pdlp_results["port"]
    assert jst.name == tst.name == "OPTIMAL"
    assert tr.primal_solution.dtype == np.float64
    assert abs(js.objective_value - ts.objective_value) <= 10 * PDLP_TOL * (
        1 + abs(js.objective_value))
    assert abs(js.best_objective_bound - ts.best_objective_bound) <= (
        10 * PDLP_TOL * (1 + abs(js.best_objective_bound)))
    for attr in ("_values", "_duals", "_reduced_costs"):
        assert _close(getattr(js, attr), getattr(ts, attr), 1e-4), attr
    # within a quarter, or one major where a quarter is less than one
    assert abs(jr.iterations - tr.iterations) <= max(64, jr.iterations // 4)


@pytest.mark.parametrize("name", sorted(LP_MODELS))
def test_glop_solver_is_bit_identical(name):
    jm, tm = LP_MODELS[name](JLS), LP_MODELS[name](TLS)
    js, ts = _solver(JLS, "glop"), _solver(TLS, "glop")
    assert js.solve(jm).name == ts.solve(tm).name
    for attr in ("_values", "_duals", "_reduced_costs", "_objective",
                 "_best_bound"):
        assert_same(getattr(js, attr), getattr(ts, attr), attr)


@pytest.mark.parametrize("backend", ["sat", "mip", "auto", "pdlp", "glop"])
@pytest.mark.parametrize("name", sorted(MIP_MODELS))
def test_mip_solver_matches(name, backend):
    """Every backend name sends an integer model to the B&B."""
    jm, tm = MIP_MODELS[name](JLS), MIP_MODELS[name](TLS)
    js, ts = _solver(JLS, backend), _solver(TLS, backend)
    jst, tst = js.solve(jm), ts.solve(tm)
    assert jst.name == tst.name == "OPTIMAL"
    obj = js.objective_value
    assert abs(ts.objective_value - obj) <= 1e-9 * (1 + abs(obj))
    x = ts._values
    assert np.all(np.abs(x[:2] - np.round(x[:2])) <= 1e-6)


def test_pdlp_solver_dtype_and_params(pdlp_results):
    """The CPU route solves in float64; ``pdhg_params`` overrides the
    defaults; other keywords go into PdhgParams, as in the JAX package."""
    m = sample_model(TLS)
    s = _solver(TLS, "pdlp")
    s.solve(m, iteration_limit=64)
    assert pdlp_results["port"].iterations <= 64
    assert s.solve(m, pdhg_params=TP.PdhgParams(
        dtype=torch.float32, iteration_limit=10**5)).name == "OPTIMAL"
    assert abs(s.objective_value - 34.0) <= 1e-3 * 35


def test_pdlp_feasible_rule_matches(pdlp_results):
    """MPSolver's FEASIBLE rule on an iteration limit: NOT_SOLVED for an
    iterate far from feasible, FEASIBLE for one within 1e-4·(1 + the largest
    finite row bound) of it, in both packages.  (Nearer the optimum the
    two trajectories end at different limits.)"""
    for limit, want in ((64, "NOT_SOLVED"), (700, "FEASIBLE")):
        got = [_solver(ls, "pdlp").solve(random_model(ls, 2),
                                         iteration_limit=limit).name
               for ls in (JLS, TLS)]
        assert got == [want, want], limit
        r, qp = pdlp_results["port"], random_model(TLS, 2).to_qp()
        scale = 1.0 + float(np.max(np.abs(qp.constraint_upper)))
        assert (r.primal_residual <= 1e-4 * scale) == (want == "FEASIBLE")


# ---------------------------------------------------------------------------
# math_opt: tests/test_facades.py's cases, and PDLP
# ---------------------------------------------------------------------------


def _mo_solve(mo, model, solver_type, **kw):
    if mo is TMO:
        kw["device"] = "cpu"
    return mo.solve(model, solver_type, **kw)


def _mo_lp(mo, solver_type):
    model = mo.Model(name="sample")
    x = model.add_variable(lb=0, name="x")
    y = model.add_variable(lb=0, name="y")
    model.add_linear_constraint(x + 2 * y <= 14)
    model.add_linear_constraint(3 * x - y >= 0)
    model.add_linear_constraint(x - y <= 2)
    model.maximize(3 * x + 4 * y)
    r = _mo_solve(mo, model, getattr(mo.SolverType, solver_type))
    return r, x


@pytest.mark.parametrize("solver_type", ["GLOP", "HIGHS", "PDLP"])
def test_math_opt_lp_matches(solver_type):
    (jr, jx), (tr, tx) = _mo_lp(JMO, solver_type), _mo_lp(TMO, solver_type)
    assert jr.termination.reason.name == tr.termination.reason.name == (
        "OPTIMAL")
    assert tr.has_primal_feasible_solution()
    tol = 0.0 if solver_type != "PDLP" else 10 * PDLP_TOL * 35
    assert abs(jr.objective_value() - tr.objective_value()) <= tol
    assert abs(tr.value(tx) - 6.0) <= (1e-7 if tol == 0 else 1e-3)
    jv = sorted((v.index, val) for v, val in jr.variable_values().items())
    tv = sorted((v.index, val) for v, val in tr.variable_values().items())
    assert [k for k, _ in jv] == [k for k, _ in tv]
    assert _close([v for _, v in jv], [v for _, v in tv],
                  0.0 if tol == 0 else 1e-4)


@pytest.mark.parametrize("solver_type", ["CP_SAT", "GSCIP"])
def test_math_opt_mip_matches(solver_type):
    out = []
    for mo in (JMO, TMO):
        model = mo.Model()
        x = model.add_binary_variable("x")
        y = model.add_integer_variable(lb=0, ub=5, name="y")
        model.add_linear_constraint(2 * x + 3 * y <= 12)
        model.maximize(x + 2 * y)
        out.append(_mo_solve(mo, model, getattr(mo.SolverType, solver_type)))
    assert [r.termination.reason.name for r in out] == ["OPTIMAL"] * 2
    assert abs(out[0].objective_value() - out[1].objective_value()) <= 1e-9
    assert abs(out[1].objective_value() - 8.0) < 1e-6


def test_math_opt_callbacks_match():
    got = []
    for mo in (JMO, TMO):
        m = mo.Model("cb")
        xs = [m.add_binary_variable(name=f"b{i}") for i in range(6)]
        m.add_linear_constraint(sum(xs) >= 3)
        m.minimize(sum((i + 1) * x for i, x in enumerate(xs)))
        msgs, sols = [], []
        r = _mo_solve(mo, m, mo.SolverType.GSCIP,
                      message_callback=lambda lines: msgs.extend(lines),
                      solution_callback=lambda v, obj: sols.append(obj))
        got.append((r.termination.reason.name, r.objective_value(), msgs,
                    min(sols)))
    assert got[0] == got[1]
    assert got[1][1] == 6.0


def _incremental(mod):
    """tests/test_facades.py's incremental cases as one sequence; returns
    each step's termination and objective."""
    kw = {"device": "cpu"} if mod is TMOM else {}
    out = []
    m = mod.Model("inc")
    x = m.add_variable(lb=0.0, ub=10.0, name="x")
    y = m.add_variable(lb=0.0, ub=10.0, name="y")
    c0 = m.add_linear_constraint(x + y >= 4.0)
    m.minimize(2 * x + 3 * y)
    sess = mod.IncrementalSolver(m, mod.SolverType.GLOP, **kw)
    steps = [None,
             mod.ModelUpdate().set_variable_ub(x, 1.0),
             mod.ModelUpdate().set_variable_ub(x, 1.0).set_variable_ub(y, 2.0),
             mod.ModelUpdate().set_variable_ub(y, 10.0).set_constraint_lb(
                 c0, 6.0)]
    upd = mod.ModelUpdate()
    upd.add_linear_constraint(x <= 3.0)
    steps.append(upd)
    steps.append(mod.ModelUpdate().delete_linear_constraint(1))
    upd = mod.ModelUpdate().add_variable(lb=0.0, ub=2.0, name="z")
    steps.append(upd)
    upd = mod.ModelUpdate()
    upd.objective_coeffs[2] = -5.0
    steps.append(upd)
    steps.append(mod.ModelUpdate().delete_variable(y))
    steps.append(mod.ModelUpdate().set_coefficient(c0, x, 2.0))
    for upd in steps:
        r = sess.solve() if upd is None else sess.solve_after_update(upd)
        out.append((r.termination.reason.name, r.objective_value()))
    # the same session's model through PDLP, from scratch
    pdlp = mod.IncrementalSolver(m, mod.SolverType.PDLP, **kw)
    r = pdlp.solve()
    out.append((r.termination.reason.name, r.objective_value()))
    return out


def test_math_opt_incremental_matches():
    jo, to = _incremental(JMOM), _incremental(TMOM)
    assert [s for s, _ in jo] == [s for s, _ in to]
    assert [o for _, o in jo[:-1]] == [o for _, o in to[:-1]]
    assert abs(jo[-1][1] - to[-1][1]) <= 10 * PDLP_TOL * (1 + abs(jo[-1][1]))
    assert "INFEASIBLE" in [s for s, _ in to]


def _iis_models(mo):
    m = mo.Model("iis")
    x = m.add_variable(lb=0.0, ub=10.0, name="x")
    y = m.add_variable(lb=0.0, ub=10.0, name="y")
    m.add_linear_constraint(x + y >= 12)
    m.add_linear_constraint(x + y <= 8)
    m.add_linear_constraint(x - y <= 3)
    m2 = mo.Model("ok")
    a = m2.add_variable(lb=0.0, ub=1.0)
    m2.add_linear_constraint(a <= 1)
    m3 = mo.Model("bounds")
    z = m3.add_variable(lb=5.0, ub=10.0)
    m3.add_linear_constraint(z <= 2)
    m4 = mo.Model("integer")
    b = m4.add_integer_variable(lb=0.0, ub=3.0)
    c = m4.add_variable(lb=-1.0, ub=1.0)
    m4.add_linear_constraint(b + c >= 5)
    m4.add_linear_constraint(b - c <= 1)
    return (m, m2, m3, m4)


def test_compute_infeasible_subsystem_matches():
    for jm, tm in zip(_iis_models(JMO), _iis_models(TMO)):
        jr = JMO.compute_infeasible_subsystem(jm)
        tr = TMO.compute_infeasible_subsystem(tm)
        assert jr.feasibility.name == tr.feasibility.name
        assert jr.is_minimal == tr.is_minimal
        assert dataclasses.asdict(jr.infeasible_subsystem) == (
            dataclasses.asdict(tr.infeasible_subsystem))
    r = TMO.compute_infeasible_subsystem(_iis_models(TMO)[0])
    assert sorted(r.infeasible_subsystem.linear_constraints) == [0, 1]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    lines = capsys.readouterr().out.splitlines()
    head = [ln for ln in lines if ln.split(":")[0] in (
        "Model", "Solver", "Status", "Objective")]
    return rc, head


def _sol(path):
    rows = [ln.split() for ln in Path(path).read_text().splitlines()]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


def _cli_pair(tmp_path, capsys, qp, solver):
    path = str(tmp_path / "m.mps")
    JMPS.write_mps(qp, path)
    out = []
    for pkg, main, extra in (("jax", JCLI.main, []),
                             ("port", TCLI.main, ["--device", "cpu"])):
        sol = str(tmp_path / f"{pkg}.sol")
        rc, head = _cli(main, ["solve", "--input", path, "--solver", solver,
                               "--sol_file", sol] + extra, capsys)
        out.append((rc, head, sol))
    return out


def test_cli_glop_is_bit_identical(tmp_path, capsys):
    (jrc, jhead, jsol), (trc, thead, tsol) = _cli_pair(
        tmp_path, capsys, random_lp(10, 8, density=0.4, seed=2), "glop")
    assert jrc == trc == 0
    assert jhead == thead and len(thead) == 4
    assert Path(jsol).read_text() == Path(tsol).read_text()


def test_cli_pdlp_matches(tmp_path, capsys):
    (jrc, jhead, jsol), (trc, thead, tsol) = _cli_pair(
        tmp_path, capsys, random_lp(10, 8, density=0.4, seed=2), "pdlp")
    assert jrc == trc == 0
    assert jhead[:3] == thead[:3]
    jobj, tobj = (float(h[0].split()[1]) for h in (jhead[3:], thead[3:]))
    assert abs(jobj - tobj) <= 10 * PDLP_TOL * (1 + abs(jobj))
    (jn, jv), (tn, tv) = _sol(jsol), _sol(tsol)
    assert jn == tn and jn[0] == "=obj="
    assert _close(jv, tv, 1e-4)


def test_cli_mip_matches(tmp_path, capsys):
    (jrc, jhead, jsol), (trc, thead, tsol) = _cli_pair(
        tmp_path, capsys, knapsack_model(JLS).to_qp(), "mip")
    assert jrc == trc == 0
    assert jhead[:3] == thead[:3] and thead[2].endswith("OPTIMAL")
    (jn, jv), (tn, tv) = _sol(jsol), _sol(tsol)
    assert jn == tn
    assert abs(jv[0] - tv[0]) <= 1e-9 * (1 + abs(jv[0]))


def test_cli_bad_status_exits_nonzero(tmp_path, capsys):
    """An infeasible model: both commands print the same status and exit
    1."""
    m = duals_model(JLS)
    m.add(m.objective >= 1.0)
    (jrc, jhead, _), (trc, thead, _) = _cli_pair(
        tmp_path, capsys, m.to_qp(), "glop")
    assert jrc == trc == 1
    assert jhead[:3] == thead[:3] and thead[2].endswith("INFEASIBLE")


def test_python_m_ortools_tpu_torch(tmp_path, capsys):
    """``python -m ortools_tpu_torch solve`` in a subprocess prints what
    ``main`` prints in this process."""
    path = str(tmp_path / "m.mps")
    TMPS.write_mps(port_qp(random_lp(10, 8, density=0.4, seed=2)), path)
    argv = ["solve", "--input", path, "--solver", "glop", "--device", "cpu"]
    _, head = _cli(TCLI.main, argv, capsys)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "ortools_tpu_torch"] + argv,
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.split(":")[0] in (
        "Model", "Solver", "Status", "Objective")]
    assert lines == head
