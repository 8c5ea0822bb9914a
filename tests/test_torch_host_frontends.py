"""The port's host front ends around ``mip.solve`` against the JAX
package's, on the CPU.

Bin packing (assignment MIP and arc flow), BOP (``IntegralSolver`` and the
strategy portfolio) and perfect matching run the port's ``mip.solve`` with
``device="cpu"`` (float64 node LPs) against the JAX package's under x64.
The copies (``graph/blossom.py``, ``sat/simplification.py``,
``sat/pure_sat.py``, ``sat/cdcl.py``, ``sat/core_guided.py`` and
``_native/cdcl.cc``) must have their originals' text apart from import
lines.  MaxHS has a file of its own, ``tests/test_torch_max_hs.py``.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import Bounds, LinearConstraint, milp

from ortools_tpu.bop import IntegralSolver as JIntegralSolver
from ortools_tpu.graph import blossom as JB
from ortools_tpu.graph import matching as JM
from ortools_tpu.models.lp import QuadraticProgram as JQuadraticProgram
from ortools_tpu.packing import BinPackingInstance as JBinPackingInstance
from ortools_tpu.packing import first_fit_decreasing as jffd
from ortools_tpu.packing import solve_bin_packing as jpack
from ortools_tpu.packing import arc_flow as JA

from ortools_tpu_torch.bop import IntegralSolver
from ortools_tpu_torch.bop.portfolio import solve_boolean_lp
from ortools_tpu_torch.graph import blossom as TB
from ortools_tpu_torch.graph import matching as TM
from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.packing import (BinPackingInstance,
                                       first_fit_decreasing,
                                       solve_bin_packing)
from ortools_tpu_torch.packing import arc_flow as TA
from ortools_tpu_torch.utils.status import SolveStatus

from tests.test_torch_mip_host import assert_copy_text

torch.set_num_threads(1)

COPIES = ["graph/blossom.py", "sat/simplification.py", "sat/pure_sat.py",
          "sat/cdcl.py", "sat/core_guided.py", "_native/cdcl.cc"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equals_the_original_apart_from_imports(rel):
    assert_copy_text(rel)


# ---------------------------------------------------------------------------
# Bin packing
# ---------------------------------------------------------------------------


def u_class(n: int, seed: int = 0):
    """Falkenauer's "u" class: n integer sizes uniform in [20, 100],
    capacity 150."""
    return 150, np.random.default_rng(seed).integers(20, 101, size=n).tolist()


# tests/test_scheduling_packing.py's two instances (FFD settles both), a
# case whose FFD count exceeds the lower bound (the MIP runs), and the u
# class at 24, 60 and 120 items
PACKINGS = [(10, [7, 6, 5, 4, 3, 2, 2, 1]), (12, [6, 6, 4, 4, 4]),
            (10, [6, 6, 6]), u_class(24), u_class(60), u_class(120)]


@pytest.mark.parametrize("case", range(len(PACKINGS)))
def test_first_fit_decreasing_matches(case):
    cap, sizes = PACKINGS[case]
    assert (first_fit_decreasing(BinPackingInstance(cap, sizes))
            == jffd(JBinPackingInstance(cap, sizes)))


@pytest.mark.parametrize("case", range(3))
def test_solve_bin_packing_matches(case):
    cap, sizes = PACKINGS[case]
    inst = BinPackingInstance(cap, sizes)
    runs_mip = len(first_fit_decreasing(inst)) > inst.lower_bound()
    assert runs_mip == (case == 2)
    port = solve_bin_packing(inst, device="cpu")
    assert port == jpack(JBinPackingInstance(cap, sizes))
    assert sorted(i for b in port for i in b) == list(range(len(sizes)))
    assert all(sum(sizes[i] for i in b) <= cap for b in port)
    assert len(port) == (3 if case == 2 else inst.lower_bound())


# tests/test_scheduling_packing.py's three arc-flow cases and the u class
# at 60 items, equal sizes merged into one item with their count as demand
def _u_arc_flow(n: int):
    cap, sizes = u_class(n)
    size, count = np.unique(sizes, return_counts=True)
    return [cap], [[int(s)] for s in size], count.tolist()


ARC_FLOWS = [([10], [[6], [5], [4], [3], [2]], [1, 1, 1, 1, 1]),
             ([6], [[3]], [4]),
             ([5, 6], [[3, 1], [3, 5], [2, 4]], [1, 1, 1]),
             _u_arc_flow(60)]
ARC_FLOW_BINS = [2, 2, 2, 24]


@pytest.mark.parametrize("case", range(len(ARC_FLOWS)))
def test_arc_flow_graph_matches(case):
    port = TA.build_arc_flow_graph(*ARC_FLOWS[case])
    jax_ = JA.build_arc_flow_graph(*ARC_FLOWS[case])
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_)
    if case == 3:
        assert (port.num_nodes, len(port.arcs)) == (120, 1194)


@pytest.mark.parametrize("case", range(len(ARC_FLOWS)))
def test_arc_flow_bins_match(case):
    bins, _ = TA.solve_vector_bin_packing(*ARC_FLOWS[case], device="cpu")
    jbins, _ = JA.solve_vector_bin_packing(*ARC_FLOWS[case])
    assert bins == jbins == ARC_FLOW_BINS[case]


# ---------------------------------------------------------------------------
# BOP
# ---------------------------------------------------------------------------


def _facade_qp(cls):
    """tests/test_facades.py::test_bop_integral_solver's model."""
    return cls(
        objective_vector=np.array([2.0, 3.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 2.0]])),
        constraint_lower=np.array([-np.inf]),
        constraint_upper=np.array([4.0]),
        variable_lower=np.zeros(2),
        variable_upper=np.array([3.0, 3.0]),
        maximize=True,
    )


def test_integral_solver_matches():
    port = IntegralSolver(device="cpu").solve(_facade_qp(QuadraticProgram))
    jax_ = JIntegralSolver().solve(_facade_qp(JQuadraticProgram))
    assert port.status.name == jax_.status.name == "OPTIMAL"
    assert port.solution == jax_.solution
    assert port.objective_value == jax_.objective_value
    assert IntegralSolver.Solve is IntegralSolver.solve


def test_boolean_lp_proves_small_instance():
    """tests/test_facades.py::test_bop_portfolio_proves_small_instance."""
    qp = QuadraticProgram(
        objective_vector=np.array([-2.0, -3.0, -4.0]),
        constraint_matrix=np.array([[1.0, 1.0, 1.0]]),
        constraint_lower=np.array([-np.inf]),
        constraint_upper=np.array([2.0]),
        variable_lower=np.zeros(3),
        variable_upper=np.ones(3),
        integrality=np.ones(3, dtype=bool),
    )
    r = solve_boolean_lp(qp, time_limit_sec=15, device="cpu")
    assert r.status == SolveStatus.OPTIMAL
    assert abs(r.objective_value - (-7.0)) < 1e-9
    assert r.best_bound <= -7.0 + 1e-9


def test_boolean_lp_no_worse_than_milp():
    """tests/test_facades.py::test_bop_portfolio_optimizes_boolean_lp:
    the LNS draws its neighbourhoods from the clock, so the port is held
    to milp's objective, not to the JAX package's trajectory."""
    rng = np.random.default_rng(4)
    n, m = 30, 12
    a = sp.random(m, n, density=0.3, random_state=2, format="csr")
    a.data = np.abs(rng.standard_normal(a.nnz)) + 0.1
    qp = QuadraticProgram(
        objective_vector=-rng.uniform(1, 3, n),
        constraint_matrix=a,
        constraint_lower=np.full(m, -np.inf),
        constraint_upper=rng.uniform(2, 4, m),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
    )
    r = solve_boolean_lp(qp, time_limit_sec=20, device="cpu")
    assert r.status in (SolveStatus.OPTIMAL, SolveStatus.FEASIBLE)
    x = r.solution
    assert np.all((x == 0) | (x == 1))
    assert np.all(a @ x <= qp.constraint_upper + 1e-6)
    assert r.objective_value == pytest.approx(qp.objective_vector @ x,
                                              abs=1e-9)
    s = milp(qp.objective_vector,
             constraints=LinearConstraint(a, qp.constraint_lower,
                                          qp.constraint_upper),
             bounds=Bounds(qp.variable_lower, qp.variable_upper),
             integrality=np.ones(n), options={"time_limit": 20})
    assert r.objective_value <= s.fun + 1e-4 * (1 + abs(s.fun))
    assert sum(r.strategy_wins.values()) >= 1


def test_boolean_lp_rejects_a_non_binary_model():
    qp = _facade_qp(QuadraticProgram)
    with pytest.raises(ValueError, match="pure 0/1"):
        solve_boolean_lp(qp, device="cpu")


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _dist(seed: int):
    rng = np.random.default_rng(seed)
    k = int(rng.choice([4, 6, 8]))
    pts = rng.uniform(0, 10, (k, 2))
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


@pytest.mark.parametrize("seed", range(40))
def test_blossom_pairs_match(seed):
    d = _dist(seed)
    port = TM.min_weight_perfect_matching(d, device="cpu")
    assert port == JM.min_weight_perfect_matching(d)
    assert sorted(v for p in port for v in p) == list(range(d.shape[0]))


@pytest.mark.parametrize("seed", range(4))
def test_mip_fallback_pairs_match(seed, monkeypatch):
    """With the blossom patched to give up, both packages reach their MIP
    fallback, which must give the blossom's pairs."""
    d = _dist(seed)
    exact = TB.min_weight_perfect_matching_blossom(d, list(range(len(d))))
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "min_weight_perfect_matching_blossom",
                            lambda *a, **k: None)
    port = TM.min_weight_perfect_matching(d, device="cpu")
    assert port == JM.min_weight_perfect_matching(d)
    assert sorted(map(sorted, port)) == sorted(map(sorted, exact))
