"""The port's knapsack and set-cover solvers against the JAX package's, on
the CPU.

``dp_knapsack_torch`` (``device="cpu"``) must equal ``dp_knapsack_jax``
exactly, int32 semantics included: items heavier than the capacity, items
of weight 0, negative weights (JAX's clipped index) and wrapping sums.
Every ``KnapsackSolver`` type gives the JAX package's value; the host
types (brute force, DP, branch and bound) its solution too.  The
multi-dimensional MIP fallback and ``solve_set_cover_mip`` run the port's
``mip.solve`` in float64 on the CPU against the JAX package's under x64.
"""

import numpy as np
import pytest
import torch

from ortools_tpu.algorithms import KnapsackSolver as JKnapsackSolver
from ortools_tpu.algorithms import SetCoverModel as JSetCoverModel
from ortools_tpu.algorithms import greedy_set_cover as jgreedy
from ortools_tpu.algorithms.knapsack import dp_knapsack_jax
from ortools_tpu.algorithms.set_cover import solve_set_cover_mip as jcover

from ortools_tpu_torch.algorithms import KnapsackSolver, SetCoverModel
from ortools_tpu_torch.algorithms import greedy_set_cover
from ortools_tpu_torch.algorithms.knapsack import (dp_knapsack_table,
                                                   dp_knapsack_torch)
from ortools_tpu_torch.algorithms.set_cover import solve_set_cover_mip

from tests.test_algorithms import classic_instance

torch.set_num_threads(1)


def _dp_case(seed):
    rng = np.random.default_rng(seed)
    n = 25
    cap = int(rng.integers(40, 400))
    w = rng.integers(1, cap // 3, n)
    w[:3] = [cap + 1, cap + 50, 0]        # too heavy, too heavy, weight 0
    p = rng.integers(1, 100, n)
    return p.tolist(), w.tolist(), cap


@pytest.mark.parametrize("seed", range(6))
def test_dp_knapsack_torch_equals_jax(seed):
    p, w, cap = _dp_case(seed)
    assert dp_knapsack_torch(p, w, cap, device="cpu") == dp_knapsack_jax(
        p, w, cap)


@pytest.mark.parametrize("case", [
    ([10, 40, 30, 50], [5, 4, 6, 3], 10),                # test_algorithms
    ([7, 9, 4], [0, 0, 0], 5),                          # all weight 0
    ([7, 9, 4], [6, 8, 100], 5),                        # none fits
    ([7, 9, 4], [3, 2, 1], 0),                          # capacity 0
    ([5, 8, 3, 6], [-2, 3, -7, 4], 9),                  # negative weights
    ([2**30, 2**30, 2**30], [1, 1, 1], 3),              # int32 wraps
    ([-5, 12, -3], [2, 4, 0], 8),                       # negative profits
])
def test_dp_knapsack_torch_edge_cases(case):
    p, w, cap = case
    assert dp_knapsack_torch(p, w, cap, device="cpu") == dp_knapsack_jax(
        p, w, cap)


def test_dp_knapsack_table_is_int32_and_monotone():
    p, w, cap = _dp_case(11)
    dp = dp_knapsack_table(p, w, cap, device="cpu")
    assert dp.dtype == torch.int32 and dp.shape == (cap + 1,)
    assert bool(torch.all(dp[1:] >= dp[:-1]))
    assert int(dp[-1]) == dp_knapsack_jax(p, w, cap)


def _knapsack_cases():
    v, w, c = classic_instance()
    yield "classic", v, w, c
    for seed in range(3):
        rng = np.random.default_rng(seed)
        n = 14
        vv = rng.integers(1, 100, n).tolist()
        ww = [rng.integers(1, 30, n).tolist()]
        yield f"single{seed}", vv, ww, [int(sum(ww[0]) * 0.4)]
    for seed in range(2):
        rng = np.random.default_rng(10 + seed)
        n = 12
        vv = rng.integers(1, 60, n).tolist()
        ww = rng.integers(1, 20, (3, n)).tolist()
        yield f"multi{seed}", vv, ww, [int(sum(d) * 0.35) for d in ww]


KNAPSACK_CASES = {name: (v, w, c) for name, v, w, c in _knapsack_cases()}
SOLVER_TYPES = [t.name for t in JKnapsackSolver.KNAPSACK_BRUTE_FORCE_SOLVER
                .__class__]
HOST_TYPES = ("KNAPSACK_BRUTE_FORCE_SOLVER",
              "KNAPSACK_DYNAMIC_PROGRAMMING_SOLVER",
              "KNAPSACK_MULTIDIMENSION_BRANCH_AND_BOUND_SOLVER",
              "KNAPSACK_64ITEMS_SOLVER")


# every type on every case, but brute force (2^n masks in Python) not on
# the 20-item classic instance
KNAPSACK_RUNS = [(name, t) for name in sorted(KNAPSACK_CASES)
                 for t in SOLVER_TYPES
                 if (name, t) != ("classic", "KNAPSACK_BRUTE_FORCE_SOLVER")]


@pytest.mark.parametrize("name,solver_type", KNAPSACK_RUNS)
def test_knapsack_solver_matches(name, solver_type):
    v, w, c = KNAPSACK_CASES[name]
    js = JKnapsackSolver(getattr(JKnapsackSolver, solver_type), "j")
    ts = KnapsackSolver(getattr(KnapsackSolver, solver_type), "t",
                        device="cpu")
    js.init(v, w, c)
    ts.Init(v, w, c)
    jval, tval = js.solve(), ts.Solve()
    assert jval == tval
    assert ts.IsSolutionOptimal()
    sel = [i for i in range(len(v)) if ts.BestSolutionContains(i)]
    assert sum(v[i] for i in sel) == tval
    for d, cap in zip(w, c):
        assert sum(d[i] for i in sel) <= cap
    multi = len(c) > 1
    if solver_type in HOST_TYPES and not multi:
        assert sel == [i for i in range(len(v)) if js.best_solution_contains(i)]


def _cover_models(seed):
    """A random cover instance built in both packages: 24 elements, 16
    subsets, every element in at least one."""
    rng = np.random.default_rng(seed)
    subsets = [sorted(rng.choice(24, int(rng.integers(2, 7)),
                                 replace=False).tolist()) for _ in range(16)]
    subsets.append(list(range(0, 24, 2)))
    subsets.append(list(range(1, 24, 2)))
    costs = rng.uniform(1.0, 4.0, len(subsets)).round(3).tolist()
    costs[-2:] = [9.5, 9.25]
    out = []
    for cls in (JSetCoverModel, SetCoverModel):
        m = cls()
        for cost, sub in zip(costs, subsets):
            m.AddEmptySubset(cost)
            for e in sub:
                m.AddElementToLastSubset(e)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", range(2))
def test_set_cover_matches(seed):
    jm, tm = _cover_models(seed)
    assert jgreedy(jm) == greedy_set_cover(tm)
    # the root feasibility jump ends on its clock: a short one each
    jsel = jcover(jm, fj_root_seconds=0.5)
    tsel = solve_set_cover_mip(tm, device="cpu", fj_root_seconds=0.5)
    assert tsel is not None
    covered = set()
    for j in tsel:
        covered |= set(tm.subsets[j])
    assert covered == set(range(tm.num_elements))
    jcost = sum(jm.costs[j] for j in jsel)
    tcost = sum(tm.costs[j] for j in tsel)
    assert abs(jcost - tcost) <= 1e-9 * (1 + abs(jcost))
    assert tcost <= sum(tm.costs[j] for j in greedy_set_cover(tm)) + 1e-9


def test_set_cover_uncoverable_matches():
    for cls, greedy in ((JSetCoverModel, jgreedy),
                        (SetCoverModel, greedy_set_cover)):
        m = cls()
        m.add_empty_subset(1.0)
        m.add_element_to_last_subset(0)
        m.add_empty_subset(1.0)
        m.add_element_to_last_subset(3)
        assert greedy(m) is None
    assert solve_set_cover_mip(m, device="cpu") is None
