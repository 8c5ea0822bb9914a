"""The port's copies of the branch-and-bound's host modules against the JAX
package's originals, on the CPU.

Each copy (``utils/domain.py``, ``utils/status.py``, ``sat/model_ir.py``,
``sat/feasibility_jump.py``, ``mip/propagation.py``, ``mip/cuts.py``,
``glop/simplex.py``, ``glop/native_simplex.py`` with ``_native/smalllp.cc``,
``mip/heuristics.py``, ``models/mip_generators.py``, and the front end's
``models/mps.py``) must have the
original's text apart from its import lines, and give the original's
results exactly, bit for bit, on seeded inputs taken from the originals'
own tests (tests/test_domain.py, test_feasibility_jump.py, test_mip.py's
propagation cases, test_cuts.py, test_glop.py, test_native_simplex.py) and
on the battery generators.  All of it is numpy, scipy and C++ on the host.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.optimize import linprog

from ortools_tpu.glop import native_simplex as JN
from ortools_tpu.glop import simplex as JS
from ortools_tpu.mip import cuts as JC
from ortools_tpu.mip import heuristics as JH
from ortools_tpu.mip import propagation as JPR
from ortools_tpu.models import mip_generators as JG
from ortools_tpu.models.lp import random_lp
from ortools_tpu.sat import CpModel
from ortools_tpu.sat import feasibility_jump as JF
from ortools_tpu.sat import model_ir as JIR
from ortools_tpu.utils import domain as JD
from ortools_tpu.utils import status as JST

from ortools_tpu_torch._native import build as native_build
from ortools_tpu_torch.glop import native_simplex as TN
from ortools_tpu_torch.glop import simplex as TS
from ortools_tpu_torch.mip import cuts as TC
from ortools_tpu_torch.mip import heuristics as TH
from ortools_tpu_torch.mip import propagation as TPR
from ortools_tpu_torch.models import mip_generators as TG
from ortools_tpu_torch.models.lp import QuadraticProgram as TQuadraticProgram
from ortools_tpu_torch.sat import feasibility_jump as TF
from ortools_tpu_torch.sat import model_ir as TIR
from ortools_tpu_torch.utils import domain as TD
from ortools_tpu_torch.utils import status as TST

from tests.test_torch_presolve import port_qp

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["utils/domain.py", "utils/status.py", "sat/model_ir.py",
          "sat/feasibility_jump.py", "mip/propagation.py", "mip/cuts.py",
          "glop/simplex.py", "glop/native_simplex.py", "_native/smalllp.cc",
          "mip/heuristics.py", "models/mip_generators.py", "models/mps.py"]
_IMPORT = re.compile(r"^\s*(from|import)\s+ortools_tpu_torch(\.|\s)")


def assert_same(a, b, path="result"):
    """Exact equality of nested results: arrays bit for bit (NaN equal to
    NaN), sparse matrices by their CSR arrays, enums by name."""
    if sp.issparse(a):
        assert sp.issparse(b), path
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.shape == b.shape, path
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{path}.{f}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{k}]")
    elif hasattr(a, "name") and hasattr(a, "value") and hasattr(b, "name"):
        assert a.name == b.name, path
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# The text of each copy
# ---------------------------------------------------------------------------


def assert_copy_text(rel):
    """The port's ``rel`` has the JAX package's text, apart from import
    lines repointed from ``ortools_tpu`` to ``ortools_tpu_torch``."""
    orig = (ROOT / "ortools_tpu" / rel).read_text().splitlines()
    port = (ROOT / "ortools_tpu_torch" / rel).read_text().splitlines()
    assert len(orig) == len(port), rel
    for k, (o, p) in enumerate(zip(orig, port), start=1):
        if o == p:
            continue
        assert _IMPORT.match(p), f"{rel}:{k} differs: {p!r}"
        assert p.replace("ortools_tpu_torch", "ortools_tpu") == o, (
            f"{rel}:{k}: {p!r} is not {o!r} repointed")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equals_the_original_apart_from_imports(rel):
    assert_copy_text(rel)


def test_status_enums_match():
    for name in ("TerminationReason", "SolveStatus", "MPSolverStatus"):
        j, t = getattr(JST, name), getattr(TST, name)
        assert [(e.name, e.value) for e in j] == [(e.name, e.value)
                                                  for e in t]


# ---------------------------------------------------------------------------
# utils/domain.py and sat/model_ir.py
# ---------------------------------------------------------------------------


def _domains(mod, rng, k=3):
    flat = np.sort(rng.choice(np.arange(-30, 31), size=2 * k,
                              replace=False)).tolist()
    return mod.Domain.from_flat_intervals(flat)


def _domain_ops(mod, rng):
    d, e = _domains(mod, rng), _domains(mod, rng, 2)
    c = int(rng.integers(-4, 5)) or 3
    out = [d.flattened_intervals(), d.size(), d.min(), d.max(),
           d.complement().flattened_intervals(),
           d.negation().flattened_intervals(),
           d.intersection_with(e).flattened_intervals(),
           d.union_with(e).flattened_intervals(),
           d.addition_with(e).flattened_intervals(),
           d.offset(c).flattened_intervals(),
           d.multiplication_by(c).flattened_intervals(),
           d.continuous_multiplication_by(c).flattened_intervals(),
           d.division_by(c).flattened_intervals(),
           d.inverse_multiplication_by(c).flattened_intervals(),
           d.relaxed().flattened_intervals(), d.is_included_in(e),
           [d.contains(v) for v in range(-32, 33)],
           mod.Domain(-5, 7).flattened_intervals(),
           mod.Domain.from_values([4, 1, 2, 9, 3]).flattened_intervals(),
           mod.Domain.all_values().complement().is_empty(), repr(d)]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_domain_matches(seed):
    assert_same(_domain_ops(JD, np.random.default_rng(seed)),
                _domain_ops(TD, np.random.default_rng(seed)))


def _ir_ops(ir, dom, rng):
    n = 5
    doms = [dom.Domain(int(lo), int(lo) + int(w))
            for lo, w in zip(rng.integers(-5, 5, n), rng.integers(0, 6, n))]
    vals = [d.min() for d in doms]
    out = []
    for _ in range(8):
        k = int(rng.integers(1, 4))
        expr = ir.LinearExprIR(
            vars=[int(v) for v in rng.choice(n, size=k, replace=False)],
            coeffs=[int(c) for c in rng.integers(-3, 4, k)],
            offset=int(rng.integers(-4, 5)))
        out += [ir.eval_expr(expr, vals),
                ir.expr_domain(expr, doms).flattened_intervals()]
    for lit in (-4, -1, 0, 3):
        out += [ir.negated_literal(lit), ir.literal_index(lit),
                ir.literal_is_positive(lit)]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_model_ir_matches(seed):
    assert_same(_ir_ops(JIR, JD, np.random.default_rng(seed)),
                _ir_ops(TIR, TD, np.random.default_rng(seed)))


# ---------------------------------------------------------------------------
# sat/feasibility_jump.py on models built as tests/test_feasibility_jump.py
# builds them
# ---------------------------------------------------------------------------


def to_port_ir(obj):
    """Rebuild a JAX-package IR object from the port's classes."""
    if isinstance(obj, JD.Domain):
        return TD.Domain.from_flat_intervals(obj.flattened_intervals())
    if dataclasses.is_dataclass(obj):
        cls = getattr(TIR, type(obj).__name__)
        return cls(**{f.name: to_port_ir(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_port_ir(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_port_ir(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_port_ir(v) for k, v in obj.items()}
    return obj


def _inequality_model():
    m = CpModel()
    n = 40
    xs = [m.new_int_var(0, 10, f"x{i}") for i in range(n)]
    rng = np.random.default_rng(5)
    sol = rng.integers(0, 11, n)
    for _ in range(60):
        idx = rng.choice(n, size=5, replace=False)
        coef = rng.integers(-3, 4, size=5)
        val = int(coef @ sol[idx])
        e = sum(int(c) * xs[int(j)] for c, j in zip(coef, idx))
        if rng.random() < 0.5:
            m.add(e <= val + int(rng.integers(0, 3)))
        else:
            m.add(e >= val - int(rng.integers(0, 3)))
    return m, 3, 20_000


def _equality_model():
    m = CpModel()
    ys = [m.new_int_var(0, 10, f"y{i}") for i in range(12)]
    m.add(ys[0] + ys[1] == 7)
    m.add(ys[2] - ys[3] == 2)
    return m, 0, 5000


def _enforced_model():
    m = CpModel()
    b = m.new_bool_var("b")
    x = m.new_int_var(0, 5, "x")
    y = m.new_int_var(0, 5, "y")
    m.add(x >= 3).only_enforce_if(b)
    m.add(x + y <= 7)
    m.add_bool_or(b, ~b)
    m.add_at_most_one([b, ~b])
    return m, 1, 2000


def _infeasible_model():
    m = CpModel()
    x = m.new_int_var(0, 3, "x")
    y = m.new_int_var(0, 3, "y")
    m.add(x + y >= 10)
    for i in range(12):
        m.new_int_var(0, 1, f"pad{i}")
    return m, 2, 3000


@pytest.mark.parametrize("build", [_inequality_model, _equality_model,
                                   _enforced_model, _infeasible_model])
def test_feasibility_jump_matches(build):
    model, seed, moves = build()
    js = JF.extract_linear_system(model.ir)
    ts = TF.extract_linear_system(to_port_ir(model.ir))
    assert_same(js, ts)
    assert_same(JF.feasibility_jump(js, seed=seed, max_moves=moves),
                TF.feasibility_jump(ts, seed=seed, max_moves=moves))


def test_feasibility_jump_rejects_what_the_original_rejects():
    m = CpModel()
    x = m.new_int_var(0, 5, "x")
    y = m.new_int_var(0, 5, "y")
    m.add_all_different([x, y])
    assert JF.extract_linear_system(m.ir) is None
    assert TF.extract_linear_system(to_port_ir(m.ir)) is None


# ---------------------------------------------------------------------------
# mip/propagation.py
# ---------------------------------------------------------------------------


def _propagation_cases():
    yield (sp.csr_matrix(np.array([[1.0, 1.0]])), np.array([-np.inf]),
           np.array([3.0]), np.zeros(2), np.full(2, 10.0),
           np.ones(2, dtype=bool))
    yield (sp.csr_matrix(np.ones((1, 2))), np.array([5.0]),
           np.array([np.inf]), np.zeros(2), np.full(2, 2.0),
           np.ones(2, dtype=bool))
    for seed in range(6):
        rng = np.random.default_rng(seed)
        m, n = 8, 10
        a = sp.random(m, n, density=0.4, random_state=seed,
                      data_rvs=lambda k: np.round(rng.normal(size=k) * 3))
        x0 = rng.integers(0, 4, n).astype(float)
        ax = a @ x0
        cl = np.where(rng.random(m) < 0.3, ax - rng.integers(0, 3, m),
                      -np.inf)
        cu = np.where(rng.random(m) < 0.8, ax + rng.integers(0, 3, m),
                      np.inf)
        a = sp.csr_matrix(a)
        a.eliminate_zeros()
        yield a, cl, cu, np.zeros(n), np.full(n, 5.0), rng.random(n) < 0.7


@pytest.mark.parametrize("case", list(_propagation_cases()))
def test_propagation_matches(case):
    assert_same(JPR.propagate_bounds(*case), TPR.propagate_bounds(*case))
    assert_same(JPR.propagate_bounds(*case, max_rounds=2),
                TPR.propagate_bounds(*case, max_rounds=2))


# ---------------------------------------------------------------------------
# mip/cuts.py on tests/test_cuts.py's inputs
# ---------------------------------------------------------------------------


def _random_cut_case(seed):
    rng = np.random.default_rng(seed)
    n, m = 5, 4
    a = sp.csr_matrix(np.round(rng.normal(size=(m, n)) * 3))
    lb, ub = np.zeros(n), np.full(n, 3.0)
    x_ref = rng.integers(0, 4, size=n)
    cu = a @ x_ref + rng.integers(0, 5, size=m)
    cl = np.full(m, -np.inf)
    c = rng.normal(size=n)
    res = linprog(c, A_ub=a.todense(), b_ub=cu, bounds=list(zip(lb, ub)),
                  method="highs")
    return (a, cl, cu, lb, ub, np.ones(n, dtype=bool), res.x), \
        dict(min_violation=1e-6)


def _knapsack_cut_case():
    a = sp.csr_matrix(np.array([[3.0, 4.0, 5.0]]))
    res = linprog([-1, -1, -1], A_ub=a.todense(), b_ub=[6.0],
                  bounds=[(0, 1)] * 3, method="highs")
    return (a, np.array([-np.inf]), np.array([6.0]), np.zeros(3),
            np.ones(3), np.ones(3, dtype=bool), res.x), {}


def _mir_cut_case():
    return (sp.csr_matrix(np.array([[2.0, 2.0]])), np.array([-np.inf]),
            np.array([3.0]), np.zeros(2), np.full(2, 2.0),
            np.ones(2, dtype=bool), np.array([0.75, 0.75])), \
        dict(min_violation=1e-6)


def _battery_cut_case(idx, zero_half=False):
    """A battery instance's root LP point (HiGHS), as the B&B's first cut
    round sees it."""
    qp = JG.miplib_like_battery(0.5)[idx].as_minimization()
    a = sp.csr_matrix(qp.constraint_matrix)
    ub_rows = np.isfinite(qp.constraint_upper)
    lb_rows = np.isfinite(qp.constraint_lower)
    a_ub = sp.vstack([a[ub_rows], -a[lb_rows]])
    b_ub = np.concatenate([qp.constraint_upper[ub_rows],
                           -qp.constraint_lower[lb_rows]])
    res = linprog(qp.objective_vector, A_ub=a_ub, b_ub=b_ub,
                  bounds=list(zip(qp.variable_lower, qp.variable_upper)),
                  method="highs")
    return (a, qp.constraint_lower, qp.constraint_upper, qp.variable_lower,
            qp.variable_upper, np.asarray(qp.integrality, dtype=bool),
            res.x), dict(enable_zero_half=zero_half)


CUT_CASES = ([(f"random_{s}", lambda s=s: _random_cut_case(s))
              for s in range(8)]
             + [("knapsack_cover", _knapsack_cut_case),
                ("mir_row", _mir_cut_case)]
             + [(f"battery_{i}", lambda i=i: _battery_cut_case(i))
                for i in (0, 3, 6, 9, 12, 15)]
             + [("battery_0_zero_half",
                 lambda: _battery_cut_case(0, zero_half=True)),
                ("battery_12_zero_half",
                 lambda: _battery_cut_case(12, zero_half=True))])


@pytest.mark.parametrize("name,make", CUT_CASES,
                         ids=[c[0] for c in CUT_CASES])
def test_generate_cuts_matches(name, make):
    args, kw = make()
    jp = JC.generate_cuts(*args, **kw)
    tp = TC.generate_cuts(*args, **kw)
    assert_same(jp, tp)
    if jp is not None:
        qp = JG.miplib_like_battery(0.5)[0]
        qp = dataclasses.replace(
            qp, constraint_matrix=sp.csr_matrix((1, args[0].shape[1])),
            objective_vector=np.zeros(args[0].shape[1]),
            constraint_lower=np.array([-np.inf]),
            constraint_upper=np.array([1.0]),
            variable_lower=np.zeros(args[0].shape[1]),
            variable_upper=np.ones(args[0].shape[1]),
            integrality=np.ones(args[0].shape[1], dtype=bool),
            constraint_names=None, variable_names=None)
        jq = JC.append_cuts(qp, jp)
        tq = TC.append_cuts(port_qp(qp), tp)
        assert_same(jq.constraint_matrix, tq.constraint_matrix)
        assert_same(jq.constraint_upper, tq.constraint_upper)
        assert_same(jq.constraint_lower, tq.constraint_lower)


# ---------------------------------------------------------------------------
# glop/simplex.py and glop/native_simplex.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,m,n", [(0, 10, 8), (1, 25, 40), (2, 50, 30),
                                      (3, 30, 50)])
def test_simplex_solve_matches(seed, m, n):
    qp = random_lp(m, n, density=0.3, seed=seed)
    assert_same(JS.solve(qp), TS.solve(port_qp(qp)))
    assert_same(JS.solve_dualized(qp), TS.solve_dualized(port_qp(qp)))


def test_simplex_warm_resolves_match():
    """tests/test_glop.py's warm restart: one RevisedSimplex re-solved under
    a sequence of bound changes, primal and dual paths."""
    qp = random_lp(20, 15, density=0.5, seed=4)
    qp = qp.as_minimization()
    jsx, tsx = JS.RevisedSimplex(qp), TS.RevisedSimplex(port_qp(qp))
    assert_same(jsx.primal_solve(), tsx.primal_solve())
    assert_same(jsx.result(JST.MPSolverStatus.OPTIMAL),
                tsx.result(TST.MPSolverStatus.OPTIMAL))
    rng = np.random.default_rng(4)
    lb = np.asarray(qp.variable_lower, dtype=float)
    ub = np.asarray(qp.variable_upper, dtype=float)
    for _ in range(10):
        l2, u2 = lb.copy(), ub.copy()
        j = int(rng.integers(0, qp.num_variables))
        lo = l2[j] if np.isfinite(l2[j]) else -5.0
        hi = u2[j] if np.isfinite(u2[j]) else 5.0
        cut = rng.uniform(lo, hi)
        if rng.random() < 0.5:
            l2[j] = cut
        else:
            u2[j] = cut
        js, ts = jsx.resolve(l2, u2), tsx.resolve(l2, u2)
        assert_same(js, ts)
        if js == JST.MPSolverStatus.OPTIMAL:
            assert_same(jsx.result(js), tsx.result(ts))
        assert_same(jsx.basis, tsx.basis)


def test_native_library_builds_outside_the_source_tree():
    lib = TN._lib()
    path = native_build.library_path("smalllp")
    assert path.exists() and path.parent == native_build.OUT_DIR
    assert native_build.OUT_DIR == ROOT / "build" / "native"
    assert lib is native_build.load_library("smalllp")
    src_dir = ROOT / "ortools_tpu_torch" / "_native"
    assert not list(src_dir.glob("*.so"))


def test_native_resolve_matches():
    """tests/test_native_simplex.py's fuzz: the native dual simplex of each
    package re-solved under the same bound changes."""
    rng = np.random.default_rng(7)
    resolves = 0
    for seed in range(4):
        qp = random_lp(20, 15, density=0.5, seed=seed)
        qpm = qp.as_minimization() if qp.maximize else qp
        sx = JS.RevisedSimplex(qpm)
        if sx.primal_solve() != JST.MPSolverStatus.OPTIMAL:
            continue
        jn, tn = JN.NativeSmallLp(qpm), TN.NativeSmallLp(port_qp(qpm))
        jn.seed_basis(sx.basis, sx.nb_status)
        tn.seed_basis(sx.basis, sx.nb_status)
        vlb = np.asarray(qpm.variable_lower, dtype=float)
        vub = np.asarray(qpm.variable_upper, dtype=float)
        for _ in range(10):
            l2, u2 = vlb.copy(), vub.copy()
            for j in rng.choice(qpm.num_variables,
                                size=rng.integers(1, 5), replace=False):
                lo = l2[j] if np.isfinite(l2[j]) else -5.0
                hi = u2[j] if np.isfinite(u2[j]) else 5.0
                cut = rng.uniform(lo, hi)
                if rng.random() < 0.5:
                    l2[j] = cut
                else:
                    u2[j] = cut
            assert_same(jn.resolve(l2, u2), tn.resolve(l2, u2))
            resolves += 1
    assert resolves >= 20


def test_native_seed_all_slack_keeps_the_originals_behaviour():
    """The original returns True even where a free column with nonzero cost
    makes the all-slack start dual-infeasible (against its docstring); the
    copy keeps that behaviour."""
    qp = random_lp(10, 8, density=0.5, seed=1).as_minimization()
    qp = dataclasses.replace(
        qp, variable_lower=np.full(8, -np.inf),
        variable_upper=np.full(8, np.inf))
    assert JN.NativeSmallLp(qp).seed_all_slack() is True
    assert TN.NativeSmallLp(port_qp(qp)).seed_all_slack() is True
    for cls, q in ((JN.NativeSmallLp, qp),
                   (TN.NativeSmallLp, port_qp(qp))):
        big = dataclasses.replace(
            q, constraint_matrix=sp.csr_matrix((600, 8)),
            constraint_lower=np.zeros(600), constraint_upper=np.ones(600))
        with pytest.raises(ValueError):
            cls(big)


# ---------------------------------------------------------------------------
# mip/heuristics.py: the deterministic heuristics (the clock-budgeted ones
# are held by the whole solves of tests/test_torch_mip.py)
# ---------------------------------------------------------------------------


HEUR_INSTANCES = (0, 3, 6, 9, 12, 15)


def _root_point(qp):
    a = sp.csr_matrix(qp.constraint_matrix)
    ub_rows = np.isfinite(qp.constraint_upper)
    lb_rows = np.isfinite(qp.constraint_lower)
    res = linprog(qp.objective_vector,
                  A_ub=sp.vstack([a[ub_rows], -a[lb_rows]]),
                  b_ub=np.concatenate([qp.constraint_upper[ub_rows],
                                       -qp.constraint_lower[lb_rows]]),
                  bounds=list(zip(qp.variable_lower, qp.variable_upper)),
                  method="highs")
    return res.x, res


def _heuristics(H, qp, x_lp, y, int_idx):
    out = [H.greedy_cover(qp, int_idx)]
    cands = H.round_and_repair(qp, x_lp, int_idx, seen=set())
    out.append(cands)
    out.append(H.detect_set_cover(qp) is not None)
    wis = H.detect_independent_set(qp)
    out.append(None if wis is None else wis[1])
    inc = next((c for c in cands if c is not None), None)
    if inc is None:
        inc = out[0]
    if inc is not None:
        out.append(H.ils_polish(qp, inc, int_idx, np.random.default_rng(3)))
        out.append(H.one_two_exchange(qp, inc))
        out.append(H.rc_neighborhood(qp, inc, y, int_idx))
    return out


@pytest.mark.parametrize("idx", HEUR_INSTANCES)
def test_heuristics_match(idx):
    jq = JG.miplib_like_battery(0.5)[idx].as_minimization()
    tq = port_qp(jq)
    x_lp, res = _root_point(jq)
    y = np.zeros(jq.num_constraints)
    ub_rows = np.isfinite(jq.constraint_upper)
    y[ub_rows] = res.ineqlin.marginals[:int(ub_rows.sum())]
    int_idx = np.nonzero(np.asarray(jq.integrality, dtype=bool))[0]
    assert_same(_heuristics(JH, jq, x_lp, y, int_idx),
                _heuristics(TH, tq, x_lp, y, int_idx))


def test_set_cover_detection_matches():
    qp = JG.set_cover(40, 20, seed=1).as_minimization()
    assert_same(JH.detect_set_cover(qp), TH.detect_set_cover(port_qp(qp)))


# ---------------------------------------------------------------------------
# models/mip_generators.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_battery_generators_match(scale):
    jb, tb = JG.miplib_like_battery(scale), TG.miplib_like_battery(scale)
    assert len(jb) == len(tb) == 20
    for j, t in zip(jb, tb):
        assert type(t) is TQuadraticProgram
        assert_same(j, t, j.name)
