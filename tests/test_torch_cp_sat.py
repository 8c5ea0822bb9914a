"""The port's CP-SAT solve (``ortools_tpu_torch/sat/``) against the JAX
package's, on the CPU: whole solves, one route of ``solve_model`` each.

Every case is built by one builder from each package's own ``CpModel``;
the port's IR must equal the JAX IR carried across, and the port's
``CpSolverResponse`` must equal the JAX package's field by field (status,
solution, objective, bound, branches, conflicts and the assumption core;
``wall_time`` and ``gap_integral`` are clock readings and left out).  A
solution callback's calls are compared as well.  The cases are
tests/test_cp_model.py's, test_cp_expand.py's, test_cp_presolve.py's,
test_lcg.py's, test_integer_encoding.py's, test_lp_propagator.py's,
test_symmetry_breaking.py's and test_max_hs.py's, and ft06 (optimum 55).

Spies on the port's modules record which route each solve took, so that
every route of ``solve_model`` is shown to run: validation, presolve,
root propagation, the pure-PB core, the FJ hint, pure SAT, LCG, the
integer encoding, the root LP, the DFS engine with ``NodeLpPropagator``,
OLL and MaxHS (``device="cpu"``: its hitting-set MIPs run the port's
``mip.solve`` in float64).  No case sets a finite time limit, so no
answer depends on the clock.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from ortools_tpu.sat import cp_model as jcp
from ortools_tpu.utils import domain as JD

from ortools_tpu_torch.sat import cp_model as tcp
from ortools_tpu_torch.sat import (core_guided, engine, feasibility_jump,
                                   integer_encoding, lcg, lp_propagator,
                                   max_hs, pb_bridge, presolve, pure_sat)
from ortools_tpu_torch.utils import domain as TD

from tests.test_torch_mip_host import to_port_ir

torch.set_num_threads(1)

JAX = types.SimpleNamespace(cp=jcp, Domain=JD.Domain, kw={})
PORT = types.SimpleNamespace(cp=tcp, Domain=TD.Domain, kw={"device": "cpu"})

FT06 = """\
6 6
2 1 0 3 1 6 3 7 5 3 4 6
1 8 2 5 4 10 5 10 0 10 3 4
2 5 3 4 5 8 0 9 1 1 4 7
1 5 0 5 2 5 3 3 4 8 5 9
2 9 1 3 4 5 5 4 0 3 3 1
1 3 3 3 5 9 0 10 4 4 2 1
"""


def parse_jssp(text):
    """``num_jobs num_machines``, then one line of (machine, duration)
    pairs a job; '#' lines are comments."""
    rows = [[int(v) for v in ln.split()] for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]
    nj, nm = rows[0]
    return [[(r[2 * k], r[2 * k + 1]) for k in range(nm)]
            for r in rows[1:1 + nj]]


def jobshop_model(p, jobs):
    """The interval + no_overlap model of scheduling/jobshop.py's CP
    route without the order booleans: precedences, one no_overlap a
    machine, makespan = max of the last ends, minimized."""
    m = p.cp.CpModel()
    horizon = sum(d for job in jobs for _, d in job)
    machines = {}
    ends = []
    for j, job in enumerate(jobs):
        prev = None
        for o, (mach, dur) in enumerate(job):
            s = m.new_int_var(0, horizon, f"s_{j}_{o}")
            machines.setdefault(mach, []).append(
                m.new_fixed_size_interval_var(s, dur, f"iv_{j}_{o}"))
            if prev is not None:
                m.add(s >= prev)
            prev = s + dur
        ends.append(prev)
    for ivs in machines.values():
        m.add_no_overlap(ivs)
    mk = m.new_int_var(0, horizon, "makespan")
    m.add_max_equality(mk, ends)
    m.minimize(mk)
    return m


def weighted_maxsat(p, seed, n=10, m=18):
    """tests/test_max_hs.py::weighted_maxsat_model."""
    rng = np.random.default_rng(seed)
    mdl = p.cp.CpModel()
    xs = [mdl.new_bool_var(f"x{i}") for i in range(n)]
    for _ in range(m):
        vs = rng.choice(n, 3, replace=False)
        signs = rng.integers(0, 2, 3)
        mdl.add_bool_or([xs[v] if s else ~xs[v] for v, s in zip(vs, signs)])
    w = rng.integers(1, 9, n)
    mdl.minimize(sum(int(wi) * x for wi, x in zip(w, xs)))
    return mdl


def queens(p, n):
    m = p.cp.CpModel()
    q = [m.new_int_var(0, n - 1, f"q{i}") for i in range(n)]
    m.add_all_different(q)
    m.add_all_different([q[i] + i for i in range(n)])
    m.add_all_different([q[i] - i for i in range(n)])
    return m


# ---------------------------------------------------------------------------
# The cases: builder(p) -> (model, parameters); each is named by the route
# it takes, checked by the spies
# ---------------------------------------------------------------------------


def invalid(p):
    m = p.cp.CpModel()
    m.new_int_var(0, 5, "x")
    m.ir.variables.append(dataclasses.replace(m.ir.variables[0],
                                              domain=p.Domain(3, 2)))
    return m, {}


def presolve_infeasible(p):
    m = p.cp.CpModel()
    x = m.new_int_var(0, 5, "x")
    m.add(x >= 3)
    m.add(x <= 2)
    return m, {}


def root_infeasible(p):
    """test_cp_model.py's Hall conflict, with presolve off."""
    m = p.cp.CpModel()
    m.add_all_different([m.new_int_var(1, 2, f"x{i}") for i in range(3)])
    return m, {"cp_model_presolve": False}


def _bins(p, items, bins, capacity, weight=3):
    """Each item in exactly one bin, and a knapsack row a bin: true PB
    rows, which presolve keeps as linear."""
    m = p.cp.CpModel()
    g = [[m.new_bool_var(f"g{i}{j}") for j in range(bins)]
         for i in range(items)]
    for i in range(items):
        m.add_exactly_one(g[i])
    for j in range(bins):
        m.add(sum((weight + (i + j) % 2) * g[i][j] for i in range(items))
              <= capacity)
    return m


def pure_pb_sat(p):
    return _bins(p, 6, 4, 7), {}


def pure_pb_unsat(p):
    """Weighted pigeonhole: no bin holds two items."""
    return _bins(p, 5, 4, 5), {}


def _fj_model(p):
    """tests/test_torch_mip_host.py's inequality model: 40 variables and 60
    rows around a random point."""
    m = p.cp.CpModel()
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
    return m, xs


def fj_hint_decision(p):
    m, _ = _fj_model(p)
    return m, {"use_lcg": False, "use_integer_cdcl": False}


def fj_hint_lcg_optimization(p):
    m, xs = _fj_model(p)
    m.minimize(sum(xs[:8]))
    return m, {}


def clauses(p):
    """test_cp_model.py::test_bool_logic."""
    m = p.cp.CpModel()
    a, b, c = m.new_bool_var("a"), m.new_bool_var("b"), m.new_bool_var("c")
    m.add_bool_or(a, b)
    m.add_implication(a, c)
    m.add_bool_and(~b)
    return m, {}


def assumption_presolve(p):
    """test_cp_model.py::test_assumptions_infeasible: presolve refutes."""
    m = p.cp.CpModel()
    a = m.new_bool_var("a")
    b = m.new_bool_var("b")
    m.add_bool_or(a, b)
    m.add_implication(a, b)
    m.add_assumption(~b)
    return m, {}


def pure_sat_assumption_core(p):
    """Pigeonhole PHP(3, 2) as clauses, switched on by two assumed
    literals: with presolve's probing off, only the CDCL core refutes it,
    and it reports its core.  (Under 12 variables: the FJ does not run.)"""
    m = p.cp.CpModel()
    on = [m.new_bool_var("on0"), m.new_bool_var("on1")]
    free = m.new_bool_var("free")
    g = [[m.new_bool_var(f"g{i}{j}") for j in range(2)] for i in range(3)]
    for i in range(3):
        m.add_bool_or(g[i] + [~on[0]])
    for j in range(2):
        for i in range(3):
            for k in range(i + 1, 3):
                m.add_bool_or([~g[i][j], ~g[k][j], ~on[1]])
    m.add_bool_or([free, on[0]])
    m.add_assumptions([on[0], on[1]])
    return m, {"cp_model_presolve": False}


def _linear(p):
    """test_cp_model.py::test_linear_optimization's rows."""
    m = p.cp.CpModel()
    x = m.new_int_var(0, 10, "x")
    y = m.new_int_var(0, 10, "y")
    m.add(x + 2 * y <= 14)
    m.add(3 * x - y >= 0)
    m.add(x - y <= 2)
    return m, x, y


def lcg_decision(p):
    m, x, y = _linear(p)
    m.add(x + y >= 9)
    return m, {}


def lcg_optimization(p):
    m, x, y = _linear(p)
    m.maximize(3 * x + 4 * y)
    return m, {}


def lcg_large_domain(p):
    """test_lcg.py::test_large_domain_beyond_eager_budget."""
    m = p.cp.CpModel()
    x = m.new_int_var(0, 1_000_000, "x")
    y = m.new_int_var(0, 1_000_000, "y")
    m.add(3 * x + 7 * y >= 1_234_567)
    m.add(x - y <= 2)
    m.minimize(x + y)
    return m, {}


def lcg_assumption_infeasible(p):
    """test_integer_encoding.py::test_assumptions_through_integer_path."""
    m = p.cp.CpModel()
    a = m.new_int_var(0, 5, "a")
    lit = m.new_bool_var("lit")
    m.add(a >= 4).only_enforce_if(lit)
    m.add(a <= 2)
    m.add_assumption(lit)
    return m, {}


def encoding_decision(p):
    m, x, y = _linear(p)
    m.add(x + y >= 9)
    return m, {"use_lcg": False}


def encoding_optimization(p):
    m, x, y = _linear(p)
    m.maximize(3 * x + 4 * y)
    return m, {"use_lcg": False}


def encoding_table_element(p):
    """test_cp_model.py's element and table cases in one model."""
    m = p.cp.CpModel()
    idx = m.new_int_var(0, 4, "i")
    target = m.new_int_var(0, 100, "t")
    m.add_element(idx, [m.new_constant(c) for c in [10, 20, 35, 5, 60]],
                  target)
    x = m.new_int_var(0, 2, "x")
    y = m.new_int_var(0, 2, "y")
    m.add_allowed_assignments([x, y], [(0, 1), (1, 2), (2, 0)])
    m.add_forbidden_assignments([x, y], [(0, 1)])
    m.minimize(target + x)
    return m, {"use_lcg": False}


def dfs_node_lp(p):
    """test_lp_propagator.py::test_node_lp_inside_engine_search_preserves_
    optimum on the DFS engine: root LP bound, then NodeLpPropagator."""
    m = p.cp.CpModel()
    xs = [m.new_int_var(0, 6, f"x{i}") for i in range(6)]
    for i in range(5):
        m.add(xs[i] + xs[i + 1] <= 8)
    m.add(sum(xs) >= 12)
    m.minimize(sum((i % 2 + 1) * x for i, x in enumerate(xs)))
    return m, {"use_lcg": False, "use_integer_cdcl": False}


def dfs_presolve_off(p):
    """test_cp_presolve.py::test_solver_with_presolve_matches_without."""
    m = p.cp.CpModel()
    xs = [m.new_int_var(0, 9, f"x{i}") for i in range(8)]
    m.add_all_different(xs[:5])
    for i in range(7):
        m.add(xs[i] + xs[i + 1] <= 12)
    m.add(xs[0] + 2 * xs[3] >= 6)
    m.maximize(sum(xs))
    return m, {"cp_model_presolve": False, "use_lcg": False,
               "use_integer_cdcl": False}


def dfs_no_lp(p):
    m, x, y = _linear(p)
    m.maximize(3 * x + 4 * y)
    return m, {"use_lcg": False, "use_integer_cdcl": False,
               "use_lp_relaxation": False}


def oll(p):
    return weighted_maxsat(p, 1), {}


def oll_seed_3(p):
    return weighted_maxsat(p, 3), {}


def max_hs_seed_1(p):
    return weighted_maxsat(p, 1), {"core_algorithm": "max_hs"}


def max_hs_seed_7(p):
    return weighted_maxsat(p, 7), {"core_algorithm": "max_hs"}


def queens_6_all(p):
    return queens(p, 6), {"enumerate_all_solutions": True}


def queens_8_all(p):
    return queens(p, 8), {"enumerate_all_solutions": True}


def automaton_all(p):
    """test_cp_expand.py: binary strings of length 5 without "11"."""
    m = p.cp.CpModel()
    bits = [m.new_int_var(0, 1, f"b{i}") for i in range(5)]
    m.add_automaton(bits, 0, [0, 1], [(0, 0, 0), (0, 1, 1), (1, 0, 0)])
    return m, {"enumerate_all_solutions": True}


def hint_full(p):
    """test_cp_model.py::test_hint_used."""
    m = p.cp.CpModel()
    x = m.new_int_var(0, 1000, "x")
    y = m.new_int_var(0, 1000, "y")
    m.add(x + y == 1000)
    m.add_hint(x, 400)
    m.add_hint(y, 600)
    return m, {}


def hint_partial(p):
    """test_cp_model.py::test_partial_hint_guides_values, with a row that
    the hint's completion by domain minima does not meet: the DFS engine
    follows the hint."""
    m = p.cp.CpModel()
    xs = [m.new_int_var(0, 9, f"x{i}") for i in range(6)]
    m.add(sum(xs) >= 15)
    m.add_hint(xs[0], 7)
    m.add_hint(xs[1], 3)
    return m, {}


def hint_optimization(p):
    m, x, y = _linear(p)
    m.maximize(3 * x + 4 * y)
    m.add_hint(x, 2)
    m.add_hint(y, 2)
    return m, {}


def callback_objective(p):
    """test_cp_model.py::test_solution_callback_objective."""
    m = p.cp.CpModel()
    x = m.new_int_var(0, 5, "x")
    m.maximize(x)
    return m, {}


def callback_decision(p):
    """A callback keeps a decision model off the learning cores: the DFS
    engine finds it."""
    return lcg_decision(p)


def callback_dfs(p):
    m, _ = dfs_node_lp(p)
    return m, {"use_lcg": False, "use_integer_cdcl": False}


def symmetry_breaking(p):
    """test_symmetry_breaking.py's interchangeable variables."""
    m = p.cp.CpModel()
    xs = [m.new_int_var(0, 10, f"x{i}") for i in range(4)]
    m.add(sum(xs) == 17)
    m.minimize(sum(xs))
    return m, {}


def no_overlap_2x2(p):
    return jobshop_model(p, [[(0, 3), (1, 2)], [(1, 4), (0, 1)]]), {}


def ft06(p):
    return jobshop_model(p, parse_jssp(FT06)), {}


def optional_intervals(p):
    """test_cp_model.py::test_optional_intervals."""
    m = p.cp.CpModel()
    pres = m.new_bool_var("p")
    st = m.new_int_var(0, 10, "s")
    iv = m.new_optional_interval_var(st, 5, st + 5, pres, "iv")
    iv2 = m.new_fixed_size_interval_var(m.new_constant(0), 8, "iv2")
    m.add_no_overlap([iv, iv2])
    m.add(st <= 2)
    m.maximize(pres)
    return m, {}


def cumulative(p):
    m = p.cp.CpModel()
    starts = [m.new_int_var(0, 10, f"s{i}") for i in range(3)]
    ivs = [m.new_fixed_size_interval_var(starts[i], 3, f"i{i}")
           for i in range(3)]
    m.add_cumulative(ivs, [2, 2, 2], 4)
    mk = m.new_int_var(0, 20, "mk")
    m.add_max_equality(mk, [starts[i] + 3 for i in range(3)])
    m.minimize(mk)
    return m, {}


def circuit(p):
    m = p.cp.CpModel()
    lits = {(i, j): m.new_bool_var(f"a{i}{j}")
            for i in range(4) for j in range(4) if i != j}
    m.add_circuit([(i, j, lit) for (i, j), lit in lits.items()])
    m.add_bool_and(lits[0, 2])
    return m, {}


def inverse_and_arith(p):
    """test_cp_model.py's inverse, min/max/abs and product/div/mod."""
    m = p.cp.CpModel()
    f = [m.new_int_var(0, 3, f"f{i}") for i in range(4)]
    g = [m.new_int_var(0, 3, f"g{i}") for i in range(4)]
    m.add_inverse(f, g)
    m.add(f[0] == 2)
    x = m.new_int_var(2, 10, "x")
    y = m.new_int_var(3, 10, "y")
    prod = m.new_int_var(0, 100, "p")
    q = m.new_int_var(0, 100, "q")
    r = m.new_int_var(0, 100, "r")
    m.add_multiplication_equality(prod, x, y)
    m.add_division_equality(q, prod, m.new_constant(4))
    m.add_modulo_equality(r, prod, m.new_constant(5))
    mx = m.new_int_var(-10, 10, "mx")
    ab = m.new_int_var(0, 10, "ab")
    m.add_max_equality(mx, [x - 7, f[1]])
    m.add_abs_equality(ab, x - 8)
    m.minimize(r + ab + g[3])
    return m, {}


def reservoir_and_boxes(p):
    """test_cp_expand.py's reservoir with active literals and
    no_overlap_2d packing."""
    m = p.cp.CpModel()
    use = m.new_bool_var("use")
    m.add_reservoir_constraint_with_active(
        [m.new_constant(0), m.new_constant(1)], [1, -2], [True, use], 0, 10)
    xiv, yiv = [], []
    for i in range(3):
        xiv.append(m.new_fixed_size_interval_var(
            m.new_int_var(0, 2, f"x{i}"), 2, f"xi{i}"))
        yiv.append(m.new_fixed_size_interval_var(
            m.new_int_var(0, 2, f"y{i}"), 2, f"yi{i}"))
    m.add_no_overlap_2d(xiv, yiv)
    m.maximize(use)
    return m, {}


def boxes_infeasible(p):
    """test_cp_expand.py::test_no_overlap_2d_infeasible."""
    m = p.cp.CpModel()
    xiv, yiv = [], []
    for i in range(5):
        xiv.append(m.new_fixed_size_interval_var(
            m.new_int_var(0, 2, f"x{i}"), 2, f"xi{i}"))
        yiv.append(m.new_fixed_size_interval_var(
            m.new_int_var(0, 2, f"y{i}"), 2, f"yi{i}"))
    m.add_no_overlap_2d(xiv, yiv)
    return m, {}


def enforcement_domains(p):
    """test_cp_model.py's enforcement literals and domains with holes."""
    m = p.cp.CpModel()
    b = m.new_bool_var("b")
    x = m.new_int_var(0, 10, "x")
    m.add(x >= 7).only_enforce_if(b)
    m.add(x <= 3).only_enforce_if(~b)
    z = m.new_int_var_from_domain(p.Domain.from_values([1, 3, 5, 7]), "z")
    w = m.new_int_var(0, 7, "w")
    m.add(z != 5)
    m.add(z == w)
    m.minimize(z + w - 2 * x)
    return m, {}


# (builder, the routes that must be seen: "name:ok" where the route
# returned an answer, "name:none" where it declined, "name:false" where a
# propagation failed)
CASES = {
    "model_invalid": (invalid, {"!presolve:ok", "!root_propagate:ok"}),
    "presolve_infeasible": (presolve_infeasible, {"presolve:none"}),
    "root_infeasible": (root_infeasible, {"root_propagate:false"}),
    "pure_pb_sat": (pure_pb_sat, {"pb:ok"}),
    "pure_pb_unsat": (pure_pb_unsat, {"pb:ok"}),
    "fj_hint_decision": (fj_hint_decision, {"fj:ok"}),
    "fj_hint_lcg_optimization": (fj_hint_lcg_optimization, {"fj:ok",
                                                            "lcg:ok"}),
    "pure_sat": (clauses, {"pure_sat:ok"}),
    "pure_sat_assumption_core": (pure_sat_assumption_core, {"pure_sat:ok"}),
    "assumption_presolve": (assumption_presolve, {"presolve:none"}),
    "lcg_decision": (lcg_decision, {"lcg:ok"}),
    "lcg_optimization": (lcg_optimization, {"root_lp:ok", "lcg:ok"}),
    "lcg_large_domain": (lcg_large_domain, {"lcg:ok"}),
    "lcg_assumption_infeasible": (lcg_assumption_infeasible, set()),
    "encoding_decision": (encoding_decision, {"encoding:ok"}),
    "encoding_optimization": (encoding_optimization, {"encoding:ok"}),
    "encoding_table_element": (encoding_table_element, {"encoding:ok"}),
    "dfs_node_lp": (dfs_node_lp, {"root_lp:ok", "node_lp:ok", "search:ok"}),
    "dfs_presolve_off": (dfs_presolve_off, {"search:ok"}),
    "dfs_no_lp": (dfs_no_lp, {"search:ok"}),
    "oll": (oll, {"oll:ok"}),
    "oll_seed_3": (oll_seed_3, {"oll:ok"}),
    "max_hs_seed_1": (max_hs_seed_1, {"max_hs:ok"}),
    "max_hs_seed_7": (max_hs_seed_7, {"max_hs:ok"}),
    "queens_6_all": (queens_6_all, {"search:ok"}),
    "queens_8_all": (queens_8_all, {"search:ok"}),
    "automaton_all": (automaton_all, {"search:ok"}),
    "hint_full": (hint_full, {"root_propagate:ok", "!search:ok"}),
    "hint_partial": (hint_partial, {"search:ok"}),
    "hint_optimization": (hint_optimization, {"lcg:ok"}),
    "callback_objective": (callback_objective, set()),
    "callback_decision": (callback_decision, {"!lcg:ok", "search:ok"}),
    "callback_dfs": (callback_dfs, {"node_lp:ok", "search:ok"}),
    "symmetry_breaking": (symmetry_breaking, set()),
    "no_overlap_2x2": (no_overlap_2x2, set()),
    "ft06": (ft06, {"lcg:ok"}),
    "optional_intervals": (optional_intervals, set()),
    "cumulative": (cumulative, set()),
    "circuit": (circuit, set()),
    "inverse_and_arith": (inverse_and_arith, set()),
    "reservoir_and_boxes": (reservoir_and_boxes, set()),
    "boxes_infeasible": (boxes_infeasible, set()),
    "enforcement_domains": (enforcement_domains, set()),
}

# What each case must give, whatever the routes: (status, objective)
EXPECTED = {
    "model_invalid": ("MODEL_INVALID", None),
    "presolve_infeasible": ("INFEASIBLE", None),
    "root_infeasible": ("INFEASIBLE", None),
    "pure_pb_sat": ("OPTIMAL", None),
    "pure_pb_unsat": ("INFEASIBLE", None),
    "pure_sat_assumption_core": ("INFEASIBLE", None),
    "assumption_presolve": ("INFEASIBLE", None),
    "lcg_optimization": ("OPTIMAL", 34),
    "lcg_assumption_infeasible": ("INFEASIBLE", None),
    "encoding_optimization": ("OPTIMAL", 34),
    "encoding_table_element": ("OPTIMAL", 6),
    "dfs_no_lp": ("OPTIMAL", 34),
    "symmetry_breaking": ("OPTIMAL", 17),
    "no_overlap_2x2": ("OPTIMAL", 6),
    "ft06": ("OPTIMAL", 55),
    "optional_intervals": ("OPTIMAL", 0),
    "cumulative": ("OPTIMAL", 6),
    "boxes_infeasible": ("INFEASIBLE", None),
    "callback_objective": ("OPTIMAL", 5),
}
# Solutions counted by the callback under enumerate_all_solutions
COUNTS = {"queens_6_all": 4, "queens_8_all": 92, "automaton_all": 13}

SPIES = {
    "presolve": (presolve, "presolve_model"),
    "pb": (pb_bridge, "try_pure_pb"),
    "fj": (feasibility_jump, "feasibility_jump"),
    "pure_sat": (pure_sat, "solve_pure_sat"),
    "lcg": (lcg, "solve_lcg"),
    "encoding": (integer_encoding, "solve_integer_cdcl"),
    "root_lp": (lp_propagator, "root_lp_relaxation"),
    "node_lp": (lp_propagator, "NodeLpPropagator"),
    "oll": (core_guided, "minimize_core_guided"),
    "max_hs": (max_hs, "minimize_max_hs"),
    "root_propagate": (engine.Engine, "root_propagate"),
    "search": (engine.Engine, "search"),
}


def _tag(name, out):
    if out is None:
        return f"{name}:none"
    if out is False or (name == "node_lp" and not out.ok):
        return f"{name}:false"
    return f"{name}:ok"


def spy_routes(monkeypatch):
    seen = set()
    for name, (owner, attr) in SPIES.items():
        orig = getattr(owner, attr)

        def wrapper(*a, _name=name, _orig=orig, **k):
            out = _orig(*a, **k)
            seen.add(_tag(_name, out))
            return out

        monkeypatch.setattr(owner, attr, wrapper)
    return seen


def recorder(p):
    class Recorder(p.cp.CpSolverSolutionCallback):
        def __init__(self):
            super().__init__()
            self.calls = []

        def on_solution_callback(self):
            self.calls.append((list(self._values), self.objective_value))

    return Recorder()


def solve(p, name):
    """Solve case ``name`` with package ``p``.  A decision model gets a
    solution callback only where the case is about one (it keeps the
    model off the learning cores)."""
    model, params = CASES[name][0](p)
    solver = p.cp.CpSolver(**p.kw)
    for k, v in params.items():
        setattr(solver.parameters, k, v)
    cb = None
    if (model.ir.objective is not None or name.startswith("callback")
            or params.get("enumerate_all_solutions")):
        cb = recorder(p)
    solver.solve(model, cb)
    return model, solver.response, cb.calls if cb else None


def response_fields(r):
    d = dataclasses.asdict(r)
    del d["wall_time"], d["gap_integral"]
    d["status"] = r.status.name
    return d


def _same_float(a, b):
    return (a == b) or (isinstance(a, float) and isinstance(b, float)
                        and math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_the_jax_package(name, monkeypatch):
    routes = CASES[name][1]
    jm, jr, jcalls = solve(JAX, name)
    seen = spy_routes(monkeypatch)
    tm, tr, tcalls = solve(PORT, name)
    assert to_port_ir(jm.ir) == tm.ir
    jf, tf = response_fields(jr), response_fields(tr)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert _same_float(jf[k], tf[k]), (k, jf[k], tf[k])
    assert jcalls == tcalls
    assert {r for r in routes if r[0] != "!"} <= seen, (routes, seen)
    assert not {r[1:] for r in routes if r[0] == "!"} & seen, (routes, seen)
    want = EXPECTED.get(name)
    if want is not None:
        assert tr.status.name == want[0]
        if want[1] is not None:
            assert tr.objective_value == want[1]
    if "assumption" in name:
        assert tr.sufficient_assumptions_for_infeasibility
    if name in COUNTS:
        assert tr.status.name == "OPTIMAL"
        assert len(tcalls) == COUNTS[name]
        assert len({tuple(v) for v, _ in tcalls}) == COUNTS[name]
    if tr.solution is not None:
        from ortools_tpu_torch.sat.checker import solution_is_feasible
        assert solution_is_feasible(tm.ir, tr.solution)
