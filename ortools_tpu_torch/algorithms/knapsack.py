"""Knapsack solvers, the PyTorch port of ``ortools_tpu/algorithms/knapsack.py``.

Capability parity: ``ortools/algorithms/knapsack_solver.h:113`` — the
multi-algorithm facade: dynamic programming, branch and bound, brute force,
and a MIP fallback for multi-dimensional problems (reference :127-194).

Device note: the DP recurrence dp[w] = max(dp[w], dp[w - w_i] + v_i) is a
shift + max over the capacity axis — offered on the card via
``dp_knapsack_torch`` (a loop over the items on an int32 vector of length
cap + 1, two torch kernels an item, one read of the device at the end);
the numpy path is the host default for small problems.  The
multi-dimensional MIP fallback runs the port's ``mip.solve`` on the
solver's ``device`` (the card by default).
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import numpy as np
import torch

from ortools_tpu_torch.utils.device import lp_dtype, resolve_device


class SolverType(enum.Enum):
    KNAPSACK_BRUTE_FORCE_SOLVER = 0
    KNAPSACK_64ITEMS_SOLVER = 1
    KNAPSACK_DYNAMIC_PROGRAMMING_SOLVER = 2
    KNAPSACK_MULTIDIMENSION_BRANCH_AND_BOUND_SOLVER = 5
    KNAPSACK_MULTIDIMENSION_CBC_MIP_SOLVER = 3  # alias -> our MIP
    KNAPSACK_MULTIDIMENSION_SCIP_MIP_SOLVER = 4  # alias -> our MIP


class KnapsackSolver:
    KNAPSACK_BRUTE_FORCE_SOLVER = SolverType.KNAPSACK_BRUTE_FORCE_SOLVER
    KNAPSACK_64ITEMS_SOLVER = SolverType.KNAPSACK_64ITEMS_SOLVER
    KNAPSACK_DYNAMIC_PROGRAMMING_SOLVER = (
        SolverType.KNAPSACK_DYNAMIC_PROGRAMMING_SOLVER
    )
    KNAPSACK_MULTIDIMENSION_BRANCH_AND_BOUND_SOLVER = (
        SolverType.KNAPSACK_MULTIDIMENSION_BRANCH_AND_BOUND_SOLVER
    )
    KNAPSACK_MULTIDIMENSION_CBC_MIP_SOLVER = (
        SolverType.KNAPSACK_MULTIDIMENSION_CBC_MIP_SOLVER
    )
    KNAPSACK_MULTIDIMENSION_SCIP_MIP_SOLVER = (
        SolverType.KNAPSACK_MULTIDIMENSION_SCIP_MIP_SOLVER
    )

    def __init__(self, solver_type: SolverType = SolverType
                 .KNAPSACK_MULTIDIMENSION_BRANCH_AND_BOUND_SOLVER,
                 name: str = "", device="cuda") -> None:
        self.solver_type = solver_type
        self.name = name
        self.device = device
        self._profits: List[int] = []
        self._weights: List[List[int]] = []
        self._capacities: List[int] = []
        self._solution: Optional[np.ndarray] = None
        self._optimal = False

    def init(self, profits: Sequence[int],
             weights: Sequence[Sequence[int]],
             capacities: Sequence[int]) -> None:
        self._profits = [int(p) for p in profits]
        self._weights = [[int(w) for w in dim] for dim in weights]
        self._capacities = [int(c) for c in capacities]
        assert len(self._weights) == len(self._capacities)
        for dim in self._weights:
            assert len(dim) == len(self._profits)

    Init = init

    def solve(self) -> int:
        p = np.asarray(self._profits, dtype=np.int64)
        w = np.asarray(self._weights, dtype=np.int64)
        c = np.asarray(self._capacities, dtype=np.int64)
        n = len(p)
        st = self.solver_type
        self._optimal = True
        if n == 0:
            self._solution = np.zeros(0, dtype=bool)
            return 0
        if st == SolverType.KNAPSACK_BRUTE_FORCE_SOLVER and n <= 20:
            value, sol = _brute_force(p, w, c)
        elif st == SolverType.KNAPSACK_DYNAMIC_PROGRAMMING_SOLVER and (
            len(c) == 1
        ):
            value, sol = _dp_single(p, w[0], int(c[0]))
        elif len(c) == 1:
            value, sol = _branch_and_bound_single(p, w[0], int(c[0]))
        else:
            value, sol = _mip_fallback(p, w, c, self.device)
        self._solution = sol
        return int(value)

    Solve = solve

    def best_solution_contains(self, item: int) -> bool:
        assert self._solution is not None, "solve() first"
        return bool(self._solution[item])

    BestSolutionContains = best_solution_contains

    def is_solution_optimal(self) -> bool:
        return self._optimal

    IsSolutionOptimal = is_solution_optimal


def _brute_force(p, w, c):
    n = len(p)
    best, best_mask = -1, 0
    for mask in range(1 << n):
        sel = np.array([(mask >> i) & 1 for i in range(n)], dtype=bool)
        if np.all(w[:, sel].sum(axis=1) <= c):
            v = int(p[sel].sum())
            if v > best:
                best, best_mask = v, mask
    sol = np.array([(best_mask >> i) & 1 for i in range(n)], dtype=bool)
    return best, sol


def _dp_single(p, w, cap):
    """O(n*cap) DP with bit-packed take flags for reconstruction."""
    n = len(p)
    dp = np.zeros(cap + 1, dtype=np.int64)
    take = np.zeros((n, cap + 1), dtype=bool)
    for i in range(n):
        wi, pi = int(w[i]), int(p[i])
        if wi <= cap:
            cand = np.concatenate([
                np.full(wi, -1, dtype=np.int64), dp[: cap + 1 - wi] + pi
            ])
            better = cand > dp
            take[i] = better
            dp = np.where(better, cand, dp)
    # reconstruct
    sol = np.zeros(n, dtype=bool)
    wleft = cap
    for i in range(n - 1, -1, -1):
        if take[i, wleft]:
            sol[i] = True
            wleft -= int(w[i])
    return int(dp[cap]), sol


def dp_knapsack_table(profits, weights, capacity: int, device="cuda"
                      ) -> torch.Tensor:
    """The DP's int32 vector dp[0..cap] after every item, left on
    ``device``: one step an item, a shift + elementwise max (two kernels),
    with the items' weights and profits read from host arrays, so that no
    step reads the device.  The semantics of ``dp_knapsack_jax``'s
    recurrence: cand[w] = dp[clip(w - w_i, 0, cap)] + p_i where w >= w_i
    (int32, wrapping), and dp = max(dp, cand); an item heavier than the
    capacity changes nothing, a weight-0 item adds its profit to every
    cell."""
    device = resolve_device(device)
    p = np.asarray(profits, dtype=np.int32)
    w = np.asarray(weights, dtype=np.int32)
    cap = int(capacity)
    dp = torch.zeros(cap + 1, dtype=torch.int32, device=device)
    for wi, pi in zip(w.tolist(), p.tolist()):
        if wi > cap:
            continue
        if wi >= 0:
            # dp[w] for w >= w_i against dp[w - w_i] + p_i (the candidates
            # are read before the max writes)
            tail = dp[wi:]
            torch.maximum(tail, dp[:cap + 1 - wi] + pi, out=tail)
        else:
            # a negative weight: dp[min(w - w_i, cap)] + p_i everywhere
            # (JAX's clip), out of place since the candidates overlap
            cand = torch.cat([dp[-wi:], dp[cap:].expand(min(-wi, cap + 1))])
            dp = torch.maximum(dp, cand[:cap + 1] + pi)
    return dp


def dp_knapsack_torch(profits, weights, capacity: int, device="cuda") -> int:
    """Device DP over the capacity axis (value only), the port of
    ``dp_knapsack_jax``: ``dp_knapsack_table``, then one read of the
    device, for dp[cap]."""
    return int(dp_knapsack_table(profits, weights, capacity, device)[-1])


def _branch_and_bound_single(p, w, cap):
    """Classic knapsack B&B with the fractional (Dantzig) bound."""
    n = len(p)
    order = np.argsort(-(p / np.maximum(w, 1)))
    ps, ws = p[order], w[order]

    best = 0
    best_sel: List[int] = []

    def bound(i, value, room):
        b = value
        for k in range(i, n):
            if ws[k] <= room:
                room -= ws[k]
                b += ps[k]
            else:
                return b + ps[k] * room // max(ws[k], 1)
        return b

    stack = [(0, 0, cap, [])]
    while stack:
        i, value, room, sel = stack.pop()
        if value > best:
            best = value
            best_sel = sel
        if i >= n or bound(i, value, room) <= best:
            continue
        # take first (DFS prefers greedy inclusion)
        stack.append((i + 1, value, room, sel))
        if ws[i] <= room:
            stack.append((i + 1, value + ps[i], room - ws[i], sel + [i]))
    sol = np.zeros(n, dtype=bool)
    sol[order[best_sel]] = True
    return int(best), sol


def _mip_fallback(p, w, c, device="cuda"):
    import scipy.sparse as sp

    from ortools_tpu_torch.mip import MipParams, solve as mip_solve
    from ortools_tpu_torch.models.lp import QuadraticProgram

    n = len(p)
    qp = QuadraticProgram(
        objective_vector=p.astype(np.float64),
        constraint_matrix=sp.csr_matrix(w.astype(np.float64)),
        constraint_lower=np.full(len(c), -np.inf),
        constraint_upper=c.astype(np.float64),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        maximize=True,
        integrality=np.ones(n, dtype=bool),
    )
    device = resolve_device(device)
    r = mip_solve(qp, MipParams(), device=device, lp_dtype=lp_dtype(device))
    sol = r.solution > 0.5
    return int(round(r.objective_value)), sol
