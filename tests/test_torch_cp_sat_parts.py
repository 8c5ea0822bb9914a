"""The parts of the port's CP-SAT solve against the JAX package's, on the
CPU.

- The copies' text: each module equals the JAX package's apart from its
  import lines (``assert_copy_text``), the native cores ``lcg.cc`` and
  ``pbsat.cc`` byte for byte, and ``sat/solver.py`` and ``sat/cp_model.py``
  apart from import lines and lines that name ``device``.
- ``expand_model``, ``presolve_model``, the engine's root propagation, the
  checker on random assignments and the symmetry finder, each on the models
  of tests/test_torch_cp_sat.py, equal to the JAX package's.
- The scheduling propagators, the PB core, LCG, the integer encoding, the
  root LP relaxation and the gap integral on seeded inputs.
"""

import difflib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ortools_tpu.algorithms import symmetry as JSYM
from ortools_tpu.sat import checker as JCH
from ortools_tpu.sat import engine as JEN
from ortools_tpu.sat import expand as JEX
from ortools_tpu.sat import integer_encoding as JIE
from ortools_tpu.sat import lcg as JLCG
from ortools_tpu.sat import lp_propagator as JLP
from ortools_tpu.sat import pb_solver as JPB
from ortools_tpu.sat import presolve as JPRE
from ortools_tpu.sat import scheduling_propagators as JSP
from ortools_tpu.sat import symmetry_breaking as JSB
from ortools_tpu.utils import logging_util as JLOG

from ortools_tpu_torch.algorithms import symmetry as TSYM
from ortools_tpu_torch.sat import checker as TCH
from ortools_tpu_torch.sat import engine as TEN
from ortools_tpu_torch.sat import expand as TEX
from ortools_tpu_torch.sat import integer_encoding as TIE
from ortools_tpu_torch.sat import lcg as TLCG
from ortools_tpu_torch.sat import lp_propagator as TLP
from ortools_tpu_torch.sat import pb_solver as TPB
from ortools_tpu_torch.sat import presolve as TPRE
from ortools_tpu_torch.sat import scheduling_propagators as TSP
from ortools_tpu_torch.sat import symmetry_breaking as TSB
from ortools_tpu_torch.utils import logging_util as TLOG

from tests.test_torch_cp_sat import CASES, JAX, PORT
from tests.test_torch_mip_host import assert_copy_text, assert_same, to_port_ir

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["sat/params.py", "sat/checker.py", "sat/expand.py",
          "sat/scheduling_propagators.py", "sat/engine.py",
          "algorithms/symmetry.py", "sat/symmetry_breaking.py",
          "sat/presolve.py", "utils/logging_util.py", "sat/pb_solver.py",
          "sat/pb_bridge.py", "sat/integer_encoding.py", "sat/lcg.py",
          "sat/lp_propagator.py", "sat/__init__.py"]
_IMPORT = re.compile(r"^\s*(from|import)\s+(ortools_tpu_torch(\.|\s)|"
                     r"functools$)")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equals_the_original_apart_from_imports(rel):
    assert_copy_text(rel)


@pytest.mark.parametrize("name", ["lcg", "pbsat"])
def test_native_core_is_a_byte_copy(name):
    rel = f"_native/{name}.cc"
    assert ((ROOT / "ortools_tpu_torch" / rel).read_bytes()
            == (ROOT / "ortools_tpu" / rel).read_bytes())


def assert_device_diff(rel):
    """Every line of the port that is not the original's is an import line
    or names ``device``; no line of the original is dropped without such a
    line in its place, and each changed import is the original repointed."""
    orig = (ROOT / "ortools_tpu" / rel).read_text().splitlines()
    port = (ROOT / "ortools_tpu_torch" / rel).read_text().splitlines()
    sm = difflib.SequenceMatcher(a=orig, b=port, autojunk=False)
    changed = 0
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op == "equal":
            continue
        assert op != "delete", (rel, orig[i1:i2])
        new = port[j1:j2]
        for line in new:
            assert _IMPORT.match(line) or "device" in line, (rel, line)
        changed += len(new)
        old_imports = [o for o in orig[i1:i2]
                       if re.match(r"^\s*(from|import)\s+ortools_tpu", o)]
        repointed = [p.replace("ortools_tpu_torch", "ortools_tpu")
                     for p in new]
        for o in old_imports:
            assert o in repointed, (rel, o)
    assert changed > 0


@pytest.mark.parametrize("rel", ["sat/solver.py", "sat/cp_model.py"])
def test_device_files_differ_only_in_imports_and_device(rel):
    assert_device_diff(rel)


# ---------------------------------------------------------------------------
# expand, presolve, root propagation, the checker and symmetry detection on
# the whole-solve cases' models
# ---------------------------------------------------------------------------

MODELS = ["ft06", "dfs_node_lp", "queens_8_all", "reservoir_and_boxes",
          "inverse_and_arith", "circuit", "cumulative", "automaton_all",
          "encoding_table_element", "symmetry_breaking", "pure_pb_sat",
          "enforcement_domains", "optional_intervals", "lcg_large_domain"]


def _models(name):
    build = CASES[name][0]
    jm, tm = build(JAX)[0], build(PORT)[0]
    assert to_port_ir(jm.ir) == tm.ir
    return jm.ir, tm.ir


def _same_ir(j, t):
    assert (j is None) == (t is None)
    if j is not None:
        assert to_port_ir(j) == t


@pytest.mark.parametrize("name", MODELS)
def test_expand_model_matches(name):
    j, t = _models(name)
    _same_ir(JEX.expand_model(j), TEX.expand_model(t))


@pytest.mark.parametrize("name", MODELS)
def test_presolve_model_matches(name):
    j, t = _models(name)
    j, t = JEX.expand_model(j), TEX.expand_model(t)
    for keep in (False, True):
        _same_ir(JPRE.presolve_model(j, preserve_all_solutions=keep),
                 TPRE.presolve_model(t, preserve_all_solutions=keep))


def _root_domains(en, model):
    eng = en.Engine(model)
    doms = eng.initial_domains()
    ok = eng.root_propagate(doms)
    return ok, [d.flattened_intervals() for d in doms]


@pytest.mark.parametrize("name", MODELS)
def test_root_propagate_matches(name):
    j, t = _models(name)
    j, t = JEX.expand_model(j), TEX.expand_model(t)
    assert _root_domains(JEN, j) == _root_domains(TEN, t)
    pj, pt = JPRE.presolve_model(j), TPRE.presolve_model(t)
    if pj is not None:
        assert _root_domains(JEN, pj) == _root_domains(TEN, pt)


@pytest.mark.parametrize("name", MODELS)
def test_checker_matches_on_random_assignments(name):
    j, t = _models(name)
    assert JCH.validate_model(j) == TCH.validate_model(t)
    rng = np.random.default_rng(len(name))
    lo = [v.domain.min() for v in t.variables]
    hi = [v.domain.max() for v in t.variables]
    for _ in range(40):
        vals = [int(rng.integers(a, b + 1)) for a, b in zip(lo, hi)]
        assert (JCH.solution_is_feasible(j, vals)
                == TCH.solution_is_feasible(t, vals))
        for cj, ct in zip(j.constraints, t.constraints):
            assert (JCH.constraint_is_feasible(j, cj, vals)
                    == TCH.constraint_is_feasible(t, ct, vals))


@pytest.mark.parametrize("name", ["symmetry_breaking", "queens_8_all",
                                  "pure_pb_sat", "circuit"])
def test_variable_symmetries_match(name):
    j, t = _models(name)
    gj = JSB.detect_variable_symmetries(j)
    gt = TSB.detect_variable_symmetries(t)
    assert gj == gt
    _same_ir(JSB.add_symmetry_breaking(j), TSB.add_symmetry_breaking(t))


def _petersen():
    outer = [(i, (i + 1) % 5) for i in range(5)]
    spokes = [(i, i + 5) for i in range(5)]
    inner = [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
    return 10, outer + spokes + inner, None


GRAPHS = {
    "cycle_5": (5, [(i, (i + 1) % 5) for i in range(5)], None),
    "petersen": _petersen(),
    "colored_cycle_6": (6, [(i, (i + 1) % 6) for i in range(6)],
                        [0, 1, 0, 1, 0, 1]),
    "k33": (6, [(i, 3 + k) for i in range(3) for k in range(3)], None),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_graph_symmetry_generators_match(graph):
    n, edges, colors = GRAPHS[graph]
    gj = JSYM.GraphSymmetryFinder(n, edges, colors).find_generators()
    gt = TSYM.GraphSymmetryFinder(n, edges, colors).find_generators()
    assert gj and [g.cycles for g in gj] == [g.cycles for g in gt]
    dj, dt = JSYM.DynamicPartition(n), TSYM.DynamicPartition(n)
    for part in ([0, 2, 4], [1], [0, 5]):
        part = [v for v in part if v < n]
        assert dj.refine(part) == dt.refine(part)
    assert dj.as_colors() == dt.as_colors()


# ---------------------------------------------------------------------------
# the scheduling propagators, the PB core, LCG, the integer encoding, the
# root LP and the gap integral on seeded inputs
# ---------------------------------------------------------------------------


def _sched(mod, rng):
    n = int(rng.integers(3, 8))
    p = rng.integers(1, 5, n)
    est = rng.integers(0, 6, n)
    lct = est + p + rng.integers(0, 8, n)
    dem = rng.integers(1, 4, n)
    cap = int(rng.integers(2, 6))
    lst, ect = lct - p, est + p
    return [mod.disjunctive_bounds(est, lct, p),
            mod.timetable_bounds(est, lst, ect, lct, p, dem, cap),
            mod.energetic_reasoning_bounds(est, lct, p, dem, cap)]


@pytest.mark.parametrize("seed", range(4))
def test_scheduling_propagators_match(seed):
    for k in range(25):
        assert_same(_sched(JSP, np.random.default_rng([seed, k])),
                    _sched(TSP, np.random.default_rng([seed, k])))


def _pb(mod, seed):
    """Random PB rows over 14 variables, then the PB core's decision and a
    minimization (tests/test_pb_solver.py's shapes)."""
    rng = np.random.default_rng(seed)
    n = 14
    s = mod.PbSolver(n)
    for _ in range(10):
        k = int(rng.integers(2, 6))
        vs = rng.choice(n, k, replace=False).tolist()
        cf = rng.integers(1, 6, k).tolist()
        neg = (rng.random(k) < 0.3).tolist()
        s.add_geq(cf, vs, neg, int(rng.integers(1, sum(cf) // 2 + 2)))
    st, model = s.solve(100_000)
    obj = rng.integers(1, 9, n).tolist()
    best = mod.minimize(s, obj, list(range(n)), deadline=math.inf)
    return [st, model, s.num_conflicts, best]


@pytest.mark.parametrize("seed", range(3))
def test_pb_core_matches(seed):
    assert_same(_pb(JPB, seed), _pb(TPB, seed))


@pytest.mark.parametrize("name", ["lcg_optimization", "ft06",
                                  "lcg_large_domain", "cumulative"])
def test_lcg_and_encoding_match(name):
    j, t = _models(name)
    j, t = JEX.expand_model(j), TEX.expand_model(t)
    assert (JLCG.solve_lcg(j, deadline=math.inf)
            == TLCG.solve_lcg(t, deadline=math.inf))
    assert (JIE.solve_integer_cdcl(j, deadline=math.inf)
            == TIE.solve_integer_cdcl(t, deadline=math.inf))


@pytest.mark.parametrize("name", ["dfs_node_lp", "ft06", "cumulative"])
def test_root_lp_relaxation_matches(name):
    j, t = _models(name)
    j, t = JEX.expand_model(j), TEX.expand_model(t)
    rj = JLP.root_lp_relaxation(j, j.objective, 1)
    rt = TLP.root_lp_relaxation(t, t.objective, 1)
    assert rt is not None and rt.int_bound is not None
    assert_same(rj, rt)
    assert (JLP.reduced_cost_tightenings(rj, rj.int_bound + 3)
            == TLP.reduced_cost_tightenings(rt, rt.int_bound + 3))


def test_gap_integral_matches():
    def run(mod):
        ticks = iter(np.arange(0.0, 10.0, 0.5))
        g = mod.GapIntegral(lambda: float(next(ticks)))
        for obj, bound in [(20, 5), (15, 5), (15, 12), (13, 13)]:
            g.update(obj, bound)
        return g.finalize()

    assert run(JLOG) == run(TLOG) > 0
