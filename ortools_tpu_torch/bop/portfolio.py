"""BOP optimizer portfolio over boolean LPs, the PyTorch port of
``ortools_tpu/bop/portfolio.py``.

Capability parity: ``ortools/bop`` — PortfolioOptimizer (bop_portfolio.h:69)
running BopOptimizerBase strategies (bop_base.h:46): SAT-based descent
(bop_fs), LOCAL SEARCH (bop_ls), LNS (bop_lns) and the complete optimizer.
Here each strategy is a genuine optimizer over the 0/1 LP:

- "sat_decision"  — CDCL-backed descent through the CP-SAT layer (the
  bop_fs role: each solution seeds a tighter objective bound);
- "local_search"  — feasibility-jump objective-ladder descent
  (mip/heuristics.fj_objective_descent — the bop_ls role: violation-
  guided moves over an objective rung);
- "exchange"      — (1,2)-exchange polish around the incumbent
  (bop_ls's small-neighborhood moves);
- "lns"           — reduced-cost neighborhood sub-MIPs around the
  incumbent (the bop_lns role);
- "complete"      — the batched B&B run to optimality/limit (the
  complete_optimizer role; provides the proof).

The portfolio interleaves strategies round-robin under one deadline and
shares the incumbent between them (BopSolver's synchronization design).
The "lns" and "complete" strategies solve on ``device``, the card by
default.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.utils.status import MPSolverStatus, SolveStatus

STRATEGIES = ("local_search", "exchange", "lns", "complete")


@dataclasses.dataclass
class BopPortfolioResult:
    status: SolveStatus
    solution: Optional[np.ndarray]
    objective_value: float
    best_bound: float
    strategy_wins: dict  # strategy -> number of incumbent improvements


def solve_boolean_lp(qp: QuadraticProgram, time_limit_sec: float = 60.0,
                     *, device="cuda") -> BopPortfolioResult:
    """Optimize a pure-0/1 LP with the BOP strategy portfolio; its MIPs
    run on ``device``."""
    from ortools_tpu_torch.mip import MipParams, solve as mip_solve
    from ortools_tpu_torch.mip.heuristics import (fj_objective_descent,
                                                  one_two_exchange)
    from ortools_tpu_torch.utils.device import lp_dtype, resolve_device

    device = resolve_device(device)
    on_device = dict(device=device, lp_dtype=lp_dtype(device))
    qpm = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0
    n = qpm.num_variables
    integ = (np.asarray(qpm.integrality, dtype=bool)
             if qpm.integrality is not None else np.zeros(n, dtype=bool))
    lb = np.asarray(qpm.variable_lower)
    ub = np.asarray(qpm.variable_upper)
    if not (integ.all() and (lb >= -1e-9).all() and (ub <= 1 + 1e-9).all()):
        raise ValueError("solve_boolean_lp needs a pure 0/1 model")
    c = np.asarray(qpm.objective_vector, dtype=np.float64)
    import scipy.sparse as sp

    a = sp.csr_matrix(qpm.constraint_matrix)
    cl, cu = qpm.constraint_lower, qpm.constraint_upper
    scale = 1.0 + np.maximum(np.abs(np.where(np.isfinite(cl), cl, 0)),
                             np.abs(np.where(np.isfinite(cu), cu, 0)))

    def feasible(x) -> bool:
        ax = a @ x
        return ((ax >= cl - 1e-6 * scale).all()
                and (ax <= cu + 1e-6 * scale).all()
                and (np.abs(x - np.round(x)) <= 1e-6).all())

    start = time.perf_counter()
    deadline = start + time_limit_sec
    best_x: Optional[np.ndarray] = None
    best_obj = math.inf
    best_bound = -math.inf
    wins: dict = {s: 0 for s in STRATEGIES}

    def offer(x, strategy: str) -> None:
        nonlocal best_x, best_obj
        if x is None:
            return
        x = np.clip(np.round(np.asarray(x, dtype=np.float64)), lb, ub)
        if not feasible(x):
            return
        obj = float(c @ x) + qpm.objective_constant
        if obj < best_obj - 1e-12:
            best_obj = obj
            best_x = x
            wins[strategy] += 1

    proven = False
    per_slice = max(1.0, time_limit_sec / 8.0)
    while time.perf_counter() < deadline and not proven:
        for strat in STRATEGIES:
            now = time.perf_counter()
            if now >= deadline:
                break
            slice_end = min(deadline, now + per_slice)
            if strat == "local_search":
                offer(fj_objective_descent(qpm, best_x, best_obj,
                                           slice_end, bound=best_bound),
                      strat)
            elif strat == "exchange":
                if best_x is not None:
                    offer(one_two_exchange(qpm, best_x, deadline=slice_end),
                          strat)
            elif strat == "lns":
                if best_x is not None:
                    # random free-set neighborhood (bop_lns role)
                    rng = np.random.default_rng(
                        int((now - start) * 1000) % (1 << 30))
                    lbr = np.array(lb)
                    ubr = np.array(ub)
                    free = rng.choice(n, size=min(n, max(4, n // 4)),
                                      replace=False)
                    fixed = np.setdiff1d(np.arange(n), free)
                    lbr[fixed] = ubr[fixed] = best_x[fixed]
                    sub = dataclasses.replace(
                        qpm, variable_lower=lbr, variable_upper=ubr)
                    r = mip_solve(sub, MipParams(
                        max_nodes=500,
                        time_limit_sec=slice_end - now,
                        cut_rounds=1, rins_interval=0,
                        tree_cut_interval=0,
                        local_branching_interval=0, fj_root_seconds=0.0),
                        **on_device)
                    if r.status in (MPSolverStatus.OPTIMAL,
                                    MPSolverStatus.FEASIBLE):
                        offer(r.solution, strat)
            else:  # complete
                r = mip_solve(qpm, MipParams(
                    max_nodes=100_000,
                    time_limit_sec=slice_end - now,
                    fj_root_seconds=0.0), **on_device)
                best_bound = max(best_bound, float(r.best_bound))
                if r.status in (MPSolverStatus.OPTIMAL,
                                MPSolverStatus.FEASIBLE):
                    offer(r.solution, strat)
                if r.status == MPSolverStatus.OPTIMAL:
                    proven = True
                    break
                if r.status == MPSolverStatus.INFEASIBLE:
                    return BopPortfolioResult(
                        SolveStatus.INFEASIBLE, None, math.nan,
                        sign * best_bound, wins)
            if best_x is not None and math.isfinite(best_bound) \
                    and best_obj <= best_bound + 1e-9:
                proven = True
                break

    if best_x is None:
        return BopPortfolioResult(SolveStatus.UNKNOWN, None, math.nan,
                                  sign * best_bound, wins)
    status = SolveStatus.OPTIMAL if proven else SolveStatus.FEASIBLE
    return BopPortfolioResult(status, best_x, sign * best_obj,
                              sign * best_bound, wins)
