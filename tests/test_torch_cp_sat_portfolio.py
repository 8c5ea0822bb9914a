"""CP-SAT's portfolios, model I/O, DRAT checking and runner in the port
(``ortools_tpu_torch/sat/``) against the JAX package's, on the CPU.

- The copies' text: ``portfolio.py``, ``parallel_portfolio.py``,
  ``sat_io.py``, ``serialization.py`` and ``drat.py`` equal the JAX
  package's apart from import lines; ``runner.py`` apart from import lines
  and lines that name ``device``.
- The interleaved portfolio (``num_workers > 1``, the default
  ``interleave_search``) is deterministic: with no time limit, the port's
  ``CpSolverResponse`` equals the JAX package's field by field
  (``wall_time`` and ``gap_integral`` are clock readings and left out), and
  so do the workers' win counts.  The models are tests/test_portfolio.py's
  small ones.
- The forked portfolio and the shared-tree portfolio end on messages
  between processes: they are held to the JAX package's status and
  objective, in a process that ran torch ops before it forked.
- ``read_cnf``, ``read_wcnf``, ``read_opb``: the port's IR equals the JAX
  IR carried across; ``model_to_json`` gives the same text;
  ``check_drat`` gives the same verdicts; ``runner.main`` with ``--device
  cpu`` prints the JAX runner's lines apart from ``Walltime``.
"""

import math
import types

import numpy as np
import pytest
import torch

from ortools_tpu.sat import cp_model as jcp
from ortools_tpu.sat import drat as jdrat
from ortools_tpu.sat import portfolio as jpf
from ortools_tpu.sat import runner as jrunner
from ortools_tpu.sat import sat_io as jio
from ortools_tpu.sat import serialization as jser

from ortools_tpu_torch.sat import cdcl as tcdcl
from ortools_tpu_torch.sat import cp_model as tcp
from ortools_tpu_torch.sat import drat as tdrat
from ortools_tpu_torch.sat import portfolio as tpf
from ortools_tpu_torch.sat import runner as trunner
from ortools_tpu_torch.sat import sat_io as tio
from ortools_tpu_torch.sat import serialization as tser
from ortools_tpu_torch.sat.checker import solution_is_feasible

from tests.test_torch_cp_sat import response_fields
from tests.test_torch_cp_sat_parts import assert_device_diff
from tests.test_torch_mip_host import assert_copy_text, to_port_ir

torch.set_num_threads(1)

JAX = types.SimpleNamespace(cp=jcp, pf=jpf, io=jio, ser=jser, kw={})
PORT = types.SimpleNamespace(cp=tcp, pf=tpf, io=tio, ser=tser,
                             kw={"device": "cpu"})

COPIES = ["sat/portfolio.py", "sat/parallel_portfolio.py", "sat/sat_io.py",
          "sat/serialization.py", "sat/drat.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equals_the_original_apart_from_imports(rel):
    assert_copy_text(rel)


def test_runner_differs_only_in_imports_and_device():
    assert_device_diff("sat/runner.py")


# ---------------------------------------------------------------------------
# The models (tests/test_portfolio.py's), one builder for both packages
# ---------------------------------------------------------------------------


def knapsack(p, n=14, seed=0, hint=False):
    rng = np.random.default_rng(seed)
    m = p.cp.CpModel()
    xs = [m.new_bool_var(f"x{i}") for i in range(n)]
    w = rng.integers(1, 20, n)
    v = rng.integers(1, 30, n)
    m.add(sum(int(wi) * x for wi, x in zip(w, xs)) <= int(w.sum() * 0.4))
    m.maximize(sum(int(vi) * x for vi, x in zip(v, xs)))
    if hint:
        for x in xs:
            m.add_hint(x, 0)
    return m


def queens(p, n=8):
    m = p.cp.CpModel()
    q = [m.new_int_var(0, n - 1, f"q{i}") for i in range(n)]
    m.add_all_different(q)
    m.add_all_different([q[i] + i for i in range(n)])
    m.add_all_different([q[i] - i for i in range(n)])
    return m


def infeasible(p):
    m = p.cp.CpModel()
    x = m.new_int_var(0, 3, "x")
    m.add(x >= 2)
    m.add(x <= 1)
    return m


def pigeons(p, k=5):
    """k variables in [0, k - 2], pairwise different: infeasible, and left
    to the search (presolve and root propagation do not see it)."""
    m = p.cp.CpModel()
    xs = [m.new_int_var(0, k - 2, f"x{i}") for i in range(k)]
    for i in range(k):
        for j in range(i + 1, k):
            m.add(xs[i] != xs[j])
    return m


def makespan(p, durations=(3, 3, 3, 3, 3), hi=30):
    m = p.cp.CpModel()
    ivs, es = [], []
    for i, d in enumerate(durations):
        s = m.new_int_var(0, hi, f"s{i}")
        ivs.append(m.new_fixed_size_interval_var(s, d, f"iv{i}"))
        es.append(s + d)
    m.add_no_overlap(ivs)
    mk = m.new_int_var(0, hi, "mk")
    m.add_max_equality(mk, es)
    m.minimize(mk)
    return m


def shaving(p):
    m = p.cp.CpModel()
    xs = [m.new_int_var(0, 50, f"x{i}") for i in range(4)]
    m.add(sum(xs) >= 87)
    m.add(xs[0] - xs[1] <= 5)
    m.minimize(sum((i + 1) * x for i, x in enumerate(xs)))
    return m


def lb_tree(p):
    """tests/test_portfolio.py:461's model, cut from 5 variables in
    [0, 30] to 4 in [0, 15] (about 1 s in each package)."""
    m = p.cp.CpModel()
    xs = [m.new_int_var(0, 15, f"x{i}") for i in range(4)]
    m.add(sum(xs) >= 35)
    m.add(xs[1] + 2 * xs[2] >= 9)
    m.minimize(sum((i + 2) * x for i, x in enumerate(xs)))
    return m


# name: (builder, num_workers, status, objective)
INTERLEAVED = {
    "optimization": (knapsack, 8, "OPTIMAL", 165),
    "satisfaction": (queens, 4, "OPTIMAL", None),
    "infeasible": (infeasible, 4, "INFEASIBLE", None),
    "hint": (lambda p: knapsack(p, seed=7, hint=True), 3, "OPTIMAL", None),
    "lns_rotation": (makespan, 10, "OPTIMAL", 15),
    "shaving": (shaving, 4, "OPTIMAL", 128),
    "lb_tree": (lb_tree, 6, "OPTIMAL", None),
}


def _solve(p, build, workers, **params):
    solver = p.cp.CpSolver(**p.kw)
    solver.parameters.num_workers = workers
    for k, v in params.items():
        setattr(solver.parameters, k, v)
    model = build(p)
    solver.solve(model)
    return model, solver.response


def _wins(p, monkeypatch):
    """Records each worker's win (``InterleavedPortfolio._win``) in order:
    a run may end by an exception when an incumbent meets the root LP
    bound, so its outcome's ``wins`` is not always returned."""
    seen = []
    orig = p.pf.InterleavedPortfolio._win

    def win(self, who):
        seen.append(who)
        return orig(self, who)

    monkeypatch.setattr(p.pf.InterleavedPortfolio, "_win", win)
    return seen


def _same_fields(jr, tr):
    jf, tf = response_fields(jr), response_fields(tr)
    assert jf.keys() == tf.keys()
    for k in jf:
        same = jf[k] == tf[k] or (
            isinstance(jf[k], float) and math.isnan(jf[k])
            and math.isnan(tf[k]))
        assert same, (k, jf[k], tf[k])


@pytest.mark.parametrize("name", list(INTERLEAVED))
def test_interleaved_portfolio_equals_jax(name, monkeypatch):
    build, workers, status, objective = INTERLEAVED[name]
    jwins, twins = _wins(JAX, monkeypatch), _wins(PORT, monkeypatch)
    jm, jr = _solve(JAX, build, workers)
    tm, tr = _solve(PORT, build, workers)
    assert to_port_ir(jm.ir) == tm.ir
    _same_fields(jr, tr)
    assert twins == jwins
    assert tr.status.name == status
    if objective is not None:
        assert tr.objective_value == objective
    if tr.solution is not None:
        assert solution_is_feasible(tm.ir, tr.solution)


def test_lns_relax_sets_equal_jax():
    """Each LNS worker rotates through every generator: its relax sets and
    extra constraints (local branching) equal the JAX package's."""
    from ortools_tpu.sat import expand as jexpand
    from ortools_tpu_torch.sat import expand as texpand

    works = []
    for p, ex in ((JAX, jexpand), (PORT, texpand)):
        m = makespan(p, (3, 2, 4, 1, 5, 2))
        works.append(ex.expand_model(m.ir))
    assert to_port_ir(works[0]) == works[1]
    rng = np.random.default_rng(1)
    best = [int(v) for v in rng.integers(0, 10, len(works[1].variables))]
    for seed in (100, 101, 107):
        jw = jpf.LnsWorker(works[0], math.inf, seed=seed)
        tw = tpf.LnsWorker(works[1], math.inf, seed=seed)
        for _ in range(2 * len(tpf.LNS_GENERATORS)):
            assert tw._relax_set(best) == jw._relax_set(best)
            assert tw.last_generator == jw.last_generator
            assert to_port_ir(jw._extra_cts) == tw._extra_cts
    assert tpf.LNS_GENERATORS == jpf.LNS_GENERATORS


@pytest.mark.parametrize("worker", ["ShavingWorker", "LbTreeWorker"])
def test_shaving_and_lb_tree_workers_equal_jax(worker):
    """tests/test_portfolio.py's worker tests, slice by slice against the
    JAX package (no deadline, so only the conflict budget ends a probe):
    the proven bounds rise to the optimum, 128, and never pass it."""
    out = []
    for p in (JAX, PORT):
        w = getattr(p.pf, worker)(shaving(p).ir, deadline=math.inf)
        assert w.ok
        seq = [w.slice(best_internal=10_000.0) for _ in range(30)]
        seq += [w.slice(best_internal=128.0) for _ in range(60)]
        out.append([r if r is None or r[0] == "bound" else
                    (r[0], list(r[1])) for r in seq])
    assert out[1] == out[0]
    bounds = [r[1] for r in out[1] if r is not None and r[0] == "bound"]
    assert bounds and max(bounds) == 128.0
    assert bounds == sorted(bounds)


FORKED = {
    # name: (builder, workers, shared tree, status, objective);
    # tests/test_portfolio.py's infeasible models are settled by presolve
    # before the portfolio, so the infeasible cases here are pigeons'
    "optimization": (lambda p: knapsack(p, seed=5), 4, False, "OPTIMAL",
                     None),
    "infeasible": (pigeons, 3, False, "INFEASIBLE", None),
    "shared_tree_optimization": (lambda p: knapsack(p, seed=5), 4, True,
                                 "OPTIMAL", None),
    "shared_tree_infeasible": (pigeons, 3, True, "INFEASIBLE", None),
    "shared_tree_scheduling": (lambda p: makespan(p, (4, 3, 5), 20), 4,
                               True, "OPTIMAL", 12),
}


def _same_objective(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("name", list(FORKED))
def test_forked_portfolio_status_and_objective_equal_jax(name, monkeypatch):
    import multiprocessing as mp

    from ortools_tpu_torch.sat import parallel_portfolio as tpp

    build, workers, shared, status, objective = FORKED[name]
    spawned = []
    orig = tpp.ParallelPortfolio._spawn

    def spawn(self):
        orig(self)
        spawned.append(len(self._procs))

    monkeypatch.setattr(tpp.ParallelPortfolio, "_spawn", spawn)
    # torch's thread pool and allocator have run in this process before
    # the portfolio forks its workers
    a = torch.arange(4096, dtype=torch.float64).reshape(64, 64)
    assert float((a @ a).sum()) > 0
    params = dict(interleave_search=False, use_shared_tree_search=shared,
                  max_time_in_seconds=60.0)
    _, jr = _solve(JAX, build, workers, **params)
    tm, tr = _solve(PORT, build, workers, **params)
    assert spawned and spawned[0] >= 1
    assert not mp.active_children()
    assert tr.status.name == jr.status.name == status
    assert _same_objective(tr.objective_value, jr.objective_value)
    if objective is not None:
        assert tr.objective_value == objective
    _, single = _solve(PORT, build, 1)
    assert single.status.name == status
    assert _same_objective(tr.objective_value, single.objective_value)
    if tr.solution is not None:
        assert solution_is_feasible(tm.ir, tr.solution)
    b = torch.ones(8, dtype=torch.float64)
    assert float(b.sum()) == 8.0


# ---------------------------------------------------------------------------
# Readers, JSON, DRAT, the runner
# ---------------------------------------------------------------------------

TEXTS = {
    "cnf": ("read_cnf", "c simple\np cnf 3 3\n1 2 0\n-1 3 0\n-2 -3 0\n"),
    "cnf_unsat": ("read_cnf", "p cnf 1 2\n1 0\n-1 0\n"),
    "wcnf": ("read_wcnf", "p wcnf 2 3 100\n100 1 2 0\n3 -1 0\n5 -2 0\n"),
    "wcnf_2022": ("read_wcnf", "c 2022 format\nh 1 2 0\n3 -1 0\n5 -2 0\n"
                               "2 1 -2 0\n"),
    "opb": ("read_opb", "* #variable= 3 #constraint= 2\n"
                        "min: +1 x1 +2 x2 +3 x3 ;\n"
                        "+1 x1 +1 x2 +1 x3 >= 2 ;\n+1 x1 +1 x2 <= 1 ;\n"),
    "opb_negated": ("read_opb", "min: +2 ~x1 +1 x2 ;\n+1 x1 +1 ~x2 = 2 ;\n"),
}


@pytest.mark.parametrize("name", list(TEXTS))
def test_readers_equal_jax(name):
    fn, text = TEXTS[name]
    j = getattr(jio, fn)(text, name=name)
    t = getattr(tio, fn)(text, name=name)
    assert to_port_ir(j) == t
    r = _solve_ir(t)
    assert r.status.name == ("INFEASIBLE" if "unsat" in name else "OPTIMAL")


def _solve_ir(model):
    from ortools_tpu_torch.sat.solver import solve_model
    return solve_model(model, device="cpu")


def test_readers_reject_what_jax_rejects():
    for mod in (jio, tio):
        with pytest.raises(mod.SatIoError):
            mod.read_opb("min: +1 x1 x2 ;\n+1 x1 >= 0 ;\n")
        with pytest.raises(mod.SatIoError):
            mod.read_cnf("p dnf 1 1\n1 0\n")
        with pytest.raises(mod.SatIoError):
            mod.read_opb("min: +1 ;\n")


def rich_model(p):
    """tests/test_serialization.py::build_rich_model."""
    m = p.cp.CpModel()
    x = m.new_int_var(0, 10, "x")
    y = m.new_int_var(0, 10, "y")
    b = m.new_bool_var("b")
    m.add(x + 2 * y <= 14)
    m.add(x != 3)
    m.add_all_different([x, y])
    m.add_max_equality(m.new_int_var(0, 20, "mx"), [x, y])
    m.add_multiplication_equality(m.new_int_var(0, 100, "p"), x, y)
    m.add_element(m.new_int_var(0, 1, "i"), [x, y],
                  m.new_int_var(0, 10, "t"))
    m.add_allowed_assignments([x, y], [(1, 4), (0, 7), (2, 8)])
    m.add(y >= 5).only_enforce_if(b)
    iv = m.new_fixed_size_interval_var(x, 3, "iv")
    iv2 = m.new_fixed_size_interval_var(y, 2, "iv2")
    m.add_no_overlap([iv, iv2])
    m.add_hint(x, 1)
    m.maximize(x + y)
    return m


def test_model_json_equals_jax():
    jm, tm = rich_model(JAX), rich_model(PORT)
    for indent in (None, 1):
        assert (tser.model_to_json(tm.ir, indent=indent)
                == jser.model_to_json(jm.ir, indent=indent))
    text = tser.model_to_json(tm.ir)
    back = tser.model_from_json(text)
    assert back == tm.ir
    assert to_port_ir(jser.model_from_json(text)) == back
    assert tser.model_to_json(back) == text
    r0, r1 = _solve_ir(tm.ir), _solve_ir(back)
    assert r1.status.name == r0.status.name == "OPTIMAL"
    assert r1.objective_value == r0.objective_value


def _pigeonhole(pigeons=4, holes=3):
    def var(p, h):
        return p * holes + h + 1
    clauses = [[var(p, h) for h in range(holes)] for p in range(pigeons)]
    for h in range(holes):
        for p1 in range(pigeons):
            for p2 in range(p1 + 1, pigeons):
                clauses.append([-var(p1, h), -var(p2, h)])
    return clauses, pigeons * holes


def test_check_drat_gives_jax_verdicts(tmp_path):
    clauses, n = _pigeonhole()
    s = tcdcl.CdclSolver(num_vars=n, proof=True)
    for c in clauses:
        s.add_clause(c)
    assert s.solve() == 0
    path = tmp_path / "php.drat"
    s.write_drat(str(path))
    proof = tdrat.parse_drat(str(path))
    assert proof == jdrat.parse_drat(str(path)) == s.proof()
    broken = [ev for ev in proof if ev[0] == "d" or ev[1]][:3] + [("a", [])]
    cases = [(clauses, proof), (clauses, broken), ([[1, 2]], [("a", [])]),
             ([[1, 2]], [("a", [-1]), ("a", [])])]
    verdicts = [(tdrat.check_drat(f, pr), jdrat.check_drat(f, pr))
                for f, pr in cases]
    assert [t for t, _ in verdicts] == [j for _, j in verdicts]
    assert [t for t, _ in verdicts] == [True, False, False, False]


RUNNER_FILES = {
    "w.wcnf": "p wcnf 3 4 100\n100 1 2 0\n100 -2 3 0\n3 -1 0\n5 -3 0\n",
    "m.opb": "min: +1 x1 +2 x2 +3 x3 ;\n+1 x1 +1 x2 +1 x3 >= 2 ;\n",
    "u.cnf": "p cnf 1 2\n1 0\n-1 0\n",
}


def _runner_lines(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, [ln for ln in out if not ln.startswith("Walltime")]


@pytest.mark.parametrize("fname,extra", [
    ("w.wcnf", []), ("m.opb", ["--num_workers", "3"]), ("u.cnf", []),
    ("json", ["--all_solutions"])])
def test_runner_prints_the_jax_runners_lines(fname, extra, tmp_path,
                                             capsys):
    path = tmp_path / ("m.json" if fname == "json" else fname)
    if fname == "json":
        path.write_text(tser.model_to_json(queens(PORT, 5).ir))
    else:
        path.write_text(RUNNER_FILES[fname])
    jrc, jout = _runner_lines(jrunner.main, [str(path)] + extra, capsys)
    trc, tout = _runner_lines(trunner.main,
                              [str(path), "--device", "cpu"] + extra, capsys)
    assert (trc, tout) == (jrc, jout)
    assert any(ln.startswith("Status: ") for ln in tout)
    if fname == "json":
        assert "Solutions: 10" in tout
