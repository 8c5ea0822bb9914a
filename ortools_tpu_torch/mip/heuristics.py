"""Primal heuristics for the batched B&B: LP-guided rounding + repair.

Capability parity: the incumbent-finding role of the reference portfolio's
first-solution subsolvers and feasibility pump
(``ortools/sat/feasibility_pump.h``, ``cp_model_solver.cc:3613``) —
recast as vectorized numpy passes over the node LP solution:

1. threshold-round the integer variables at several thresholds;
2. greedy repair: while a row is violated, flip the integer variable with
   the best violation-reduction per unit objective damage;
3. for mixed problems, re-optimize the continuous part with the ints
   fixed (one small LP through glop);
4. vectorized 1-opt polish on the binaries.

All candidates are re-verified by the caller against the original model
(the runtime self-verification contract, SURVEY §4.5) before acceptance.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.models.lp import QuadraticProgram


def _row_violations(a, cl, cu, x):
    ax = a @ x
    return np.maximum(cl - ax, 0.0) + np.maximum(ax - cu, 0.0), ax


def round_and_repair(
    qp_min: QuadraticProgram,
    x_lp: np.ndarray,
    int_idx: np.ndarray,
    max_repair_steps: int = 300,
    thresholds: Iterable[float] = (0.5, 0.3, 0.7),
    rng: Optional[np.random.Generator] = None,
    feas_tol: float = 1e-6,
    reopt=None,
    seen: Optional[set] = None,
) -> List[np.ndarray]:
    """Return integer-feasible CANDIDATES (possibly violating rows — the
    caller's checker decides).  qp_min must be in minimization form."""
    a = sp.csr_matrix(qp_min.constraint_matrix)
    at = sp.csc_matrix(a)
    cl, cu = qp_min.constraint_lower, qp_min.constraint_upper
    lb, ub = qp_min.variable_lower, qp_min.variable_upper
    c = qp_min.objective_vector
    n = qp_min.num_variables
    cont_mask = np.ones(n, dtype=bool)
    cont_mask[int_idx] = False
    has_cont = bool(cont_mask.any())
    out: List[np.ndarray] = []

    for th in thresholds:
        x = np.array(x_lp, dtype=np.float64)
        f = x[int_idx] - np.floor(x[int_idx])
        x[int_idx] = np.floor(x[int_idx]) + (f > th)
        x = np.clip(x, lb, ub)
        # -- greedy repair on integer flips -------------------------------
        for _ in range(max_repair_steps):
            viol, ax = _row_violations(a, cl, cu, x)
            scale = 1.0 + np.maximum(np.abs(np.where(np.isfinite(cl), cl, 0)),
                                     np.abs(np.where(np.isfinite(cu), cu, 0)))
            bad = viol > feas_tol * scale
            if not bad.any():
                break
            r = int(np.argmax(viol / scale))
            lo_r, hi_r = a.indptr[r], a.indptr[r + 1]
            cols = a.indices[lo_r:hi_r]
            vals = a.data[lo_r:hi_r]
            need = (cl[r] - ax[r]) if ax[r] < cl[r] else (cu[r] - ax[r])
            # candidate unit moves on integer vars in this row
            best_j, best_score, best_step = -1, -math.inf, 0.0
            for j, v in zip(cols, vals):
                if cont_mask[j] or v == 0.0:
                    continue
                step = 1.0 if need * v > 0 else -1.0
                xj_new = x[j] + step
                if xj_new < lb[j] - 1e-9 or xj_new > ub[j] + 1e-9:
                    continue
                gain = min(abs(v), abs(need))
                cost_pen = c[j] * step
                score = gain / (1.0 + max(cost_pen, 0.0))
                if score > best_score:
                    best_j, best_score, best_step = int(j), score, step
            if best_j < 0:
                break  # stuck
            x[best_j] += best_step
        # -- continuous re-optimization -----------------------------------
        if has_cont:
            x = _reopt_continuous(qp_min, x, int_idx, cont_mask, reopt)
            if x is None:
                continue
        viol, _ = _row_violations(a, cl, cu, x)
        if (viol <= feas_tol * (1.0 + np.maximum(
                np.abs(np.where(np.isfinite(cl), cl, 0)),
                np.abs(np.where(np.isfinite(cu), cu, 0))))).all():
            if seen is not None:
                # don't re-polish a candidate already offered: the node
                # LPs revisit near-identical fractional points every batch
                key = x.tobytes()
                if key in seen:
                    continue
                seen.add(key)
            x = _one_opt(qp_min, a, at, x, int_idx, feas_tol)
            x = _swap_polish(qp_min, a, at, x, int_idx, feas_tol)
            out.append(x)
    return out


def _swap_polish(qp_min, a, at, x, int_idx, feas_tol, max_moves: int = 200):
    """(1,k)-swap local search on binaries: set an improving variable j to
    1 even when that violates rows, then greedily clear other binaries in
    the violated rows to restore feasibility; commit iff the net objective
    improves.  Reference role: the LS moves of feasibility_jump.h /
    bop_ls — this is the move class that closes packing-type gaps
    (independent set, multiknapsack) that pure rounding misses."""
    cl, cu = qp_min.constraint_lower, qp_min.constraint_upper
    lb, ub = qp_min.variable_lower, qp_min.variable_upper
    c = qp_min.objective_vector
    bin_idx = int_idx[(lb[int_idx] >= 0) & (ub[int_idx] <= 1)]
    if len(bin_idx) == 0:
        return x
    is_bin = np.zeros(qp_min.num_variables, dtype=bool)
    is_bin[bin_idx] = True
    scale = 1.0 + np.maximum(
        np.abs(np.where(np.isfinite(cl), cl, 0)),
        np.abs(np.where(np.isfinite(cu), cu, 0)))
    x = np.array(x, dtype=np.float64)
    ax = a @ x
    moves = 0
    # try turning ON binaries with improving (negative) cost, clearing
    # other set binaries in the rows the flip violates
    improving = bin_idx[(c[bin_idx] < -1e-12) & (x[bin_idx] < 0.5)
                        & (ub[bin_idx] >= 1)]
    for j in improving[np.argsort(c[improving])]:
        if moves >= max_moves:
            break
        if x[j] >= 0.5:
            continue
        lo_c, hi_c = at.indptr[j], at.indptr[j + 1]
        rows_j = at.indices[lo_c:hi_c]
        vals_j = at.data[lo_c:hi_c]
        ax_j = ax[rows_j] + vals_j
        over = np.maximum(ax_j - cu[rows_j], 0.0)
        under = np.maximum(cl[rows_j] - ax_j, 0.0)
        if np.any(under > feas_tol * scale[rows_j]):
            continue  # this move class only repairs <=-side violations
        removed: List[int] = []
        removed_mask = np.zeros(qp_min.num_variables, dtype=bool)
        obj_delta = c[j]
        feasible = True
        for ri, o in zip(rows_j, over):
            tol_r = feas_tol * scale[ri]
            if o <= tol_r:
                continue
            lo_r, hi_r = a.indptr[ri], a.indptr[ri + 1]
            cols_r = a.indices[lo_r:hi_r]
            vals_r = a.data[lo_r:hi_r]
            m = ((cols_r != j) & (vals_r > 0) & (x[cols_r] >= 0.5)
                 & is_bin[cols_r] & (lb[cols_r] <= 0)
                 & ~removed_mask[cols_r])
            kk = cols_r[m]
            vv = vals_r[m]
            # clear smallest-loss binaries first until the row fits
            order = np.argsort(-c[kk], kind="stable")
            csum = np.cumsum(vv[order])
            t = int(np.searchsorted(csum, o - tol_r, side="left")) + 1
            if t > len(order):
                feasible = False
                break
            chosen = kk[order[:t]]
            removed_mask[chosen] = True
            removed.extend(int(k) for k in chosen)
            obj_delta -= float(c[chosen].sum())
        if not feasible or obj_delta >= -1e-12:
            continue
        x_try = x.copy()
        x_try[j] = 1.0
        for k in removed:
            x_try[k] = 0.0
        ax_try = a @ x_try
        viol = np.maximum(cl - ax_try, 0) + np.maximum(ax_try - cu, 0)
        if np.any(viol > feas_tol * scale):
            continue
        x, ax = x_try, ax_try
        moves += 1
    return x


def ils_polish(
    qp_min: QuadraticProgram,
    x_best: np.ndarray,
    int_idx: np.ndarray,
    rng: np.random.Generator,
    rounds: int = 12,
    drop_frac: float = 0.15,
    reopt=None,
    feas_tol: float = 1e-6,
) -> List[np.ndarray]:
    """Iterated local search around an incumbent: randomly clear a
    fraction of the set binaries, greedily repair, then 1-opt + swap
    polish.  Reference role: the perturbation/restart variants of the
    feasibility-jump portfolio (cp_model_solver.cc:3560-3612) and bop_ls.
    Returns improving candidates (caller verifies + accepts)."""
    a = sp.csr_matrix(qp_min.constraint_matrix)
    at = sp.csc_matrix(a)
    cl, cu = qp_min.constraint_lower, qp_min.constraint_upper
    lb, ub = qp_min.variable_lower, qp_min.variable_upper
    c = qp_min.objective_vector
    bin_idx = int_idx[(lb[int_idx] >= 0) & (ub[int_idx] <= 1)]
    if len(bin_idx) == 0:
        return []
    cont_mask = np.ones(qp_min.num_variables, dtype=bool)
    cont_mask[int_idx] = False
    has_cont = bool(cont_mask.any())
    scale = 1.0 + np.maximum(
        np.abs(np.where(np.isfinite(cl), cl, 0)),
        np.abs(np.where(np.isfinite(cu), cu, 0)))
    out: List[np.ndarray] = []
    best_obj = float(c @ x_best)
    for _ in range(rounds):
        x = np.array(x_best, dtype=np.float64)
        ones = bin_idx[x[bin_idx] >= 0.5]
        if len(ones) == 0:
            break
        k = max(1, int(len(ones) * drop_frac))
        drop = rng.choice(ones, size=min(k, len(ones)), replace=False)
        x[drop] = 0.0
        # greedy repair of any rows the perturbation broke (covering rows)
        for _ in range(100):
            ax = a @ x
            viol = np.maximum(cl - ax, 0.0) + np.maximum(ax - cu, 0.0)
            bad = viol > feas_tol * scale
            if not bad.any():
                break
            r = int(np.argmax(viol / scale))
            lo_r, hi_r = a.indptr[r], a.indptr[r + 1]
            cols = a.indices[lo_r:hi_r]
            vals = a.data[lo_r:hi_r]
            need = (cl[r] - ax[r]) if ax[r] < cl[r] else (cu[r] - ax[r])
            best_j, best_score, best_step = -1, -math.inf, 0.0
            for j, v in zip(cols, vals):
                if cont_mask[j] or v == 0.0:
                    continue
                step = 1.0 if need * v > 0 else -1.0
                xj_new = x[j] + step
                if xj_new < lb[j] - 1e-9 or xj_new > ub[j] + 1e-9:
                    continue
                score = min(abs(v), abs(need)) / (1.0 + max(c[j] * step, 0.0))
                if score > best_score:
                    best_j, best_score, best_step = int(j), score, step
            if best_j < 0:
                break
            x[best_j] += best_step
        if has_cont:
            x = _reopt_continuous(qp_min, x, int_idx, cont_mask, reopt)
            if x is None:
                continue
        x = _one_opt(qp_min, a, at, x, int_idx, feas_tol)
        x = _swap_polish(qp_min, a, at, x, int_idx, feas_tol)
        ax = a @ x
        viol = np.maximum(cl - ax, 0.0) + np.maximum(ax - cu, 0.0)
        if np.any(viol > feas_tol * scale):
            continue
        obj = float(c @ x)
        if obj < best_obj - 1e-9:
            best_obj = obj
            x_best = x
            out.append(x)
    return out


def lp_dive(
    backend,
    a: sp.csr_matrix,
    cl: np.ndarray,
    cu: np.ndarray,
    x_lp: np.ndarray,
    lb: np.ndarray,
    ub: np.ndarray,
    int_idx: np.ndarray,
    integrality: np.ndarray,
    integrality_tol: float = 1e-5,
    max_resolves: int = 40,
    deadline: float = math.inf,
) -> Optional[np.ndarray]:
    """Fractional diving on a cheap-resolve node-LP backend.

    Reference role: the diving primal heuristics of MIP portfolios (and
    CP-SAT's ``QuickSolveWithHint`` LP-guided descent): repeatedly fix the
    most-integral fractional variables to their rounded values, propagate,
    and re-solve the LP, until the LP optimum is integral (an incumbent
    candidate) or the dive dead-ends.  With warm dual-simplex re-solves
    each descent step costs a handful of pivots.
    """
    import time as _time

    from ortools_tpu_torch.mip.propagation import propagate_bounds
    from ortools_tpu_torch.utils.status import MPSolverStatus

    lb = np.array(lb, dtype=np.float64)
    ub = np.array(ub, dtype=np.float64)
    x = np.array(x_lp, dtype=np.float64)
    for _ in range(max_resolves):
        if _time.perf_counter() > deadline:
            return None
        frac = np.abs(x[int_idx] - np.round(x[int_idx]))
        fr = int_idx[frac > integrality_tol]
        if len(fr) == 0:
            # LP optimum with all integers integral: feasible by LP
            # feasibility; the caller's checker confirms.
            return x
        # fix the most-integral ~20% (>=1) to their rounded values
        d = np.abs(x[fr] - np.round(x[fr]))
        k = max(1, len(fr) // 5)
        chosen = fr[np.argsort(d)[:k]]
        v = np.round(x[chosen])
        v = np.clip(v, lb[chosen], ub[chosen])
        lb[chosen] = v
        ub[chosen] = v
        lb, ub, ok = propagate_bounds(a, cl, cu, lb, ub, integrality,
                                      max_rounds=2)
        if not ok:
            return None
        st, x2, _y, _obj = backend.resolve_raw(lb, ub, deadline=deadline)
        if st != MPSolverStatus.OPTIMAL:
            return None
        x = x2
    return None


def _reopt_continuous(qp_min, x, int_idx, cont_mask, reopt=None):
    """Fix the integers, re-optimize the continuous part.  ``reopt`` is a
    warm resolve callable ``(lb, ub) -> (status, x, y, obj)`` (the node-LP
    backend's dual-simplex re-solve) — 20x cheaper than the cold-solve
    fallback."""
    from ortools_tpu_torch.utils.status import MPSolverStatus

    lb2 = np.array(qp_min.variable_lower, dtype=np.float64)
    ub2 = np.array(qp_min.variable_upper, dtype=np.float64)
    lb2[int_idx] = x[int_idx]
    ub2[int_idx] = x[int_idx]
    if reopt is not None:
        st, x2, _y, _obj = reopt(lb2, ub2)
        return x2 if st == MPSolverStatus.OPTIMAL else None

    import dataclasses

    from ortools_tpu_torch.glop import simplex as glop_simplex

    sub = dataclasses.replace(qp_min, variable_lower=lb2, variable_upper=ub2,
                              integrality=None)
    res = glop_simplex.solve(sub, max_iterations=5000)
    if res.status != MPSolverStatus.OPTIMAL:
        return None
    return res.primal_solution


def greedy_cover(qp_min: QuadraticProgram, int_idx: np.ndarray,
                 feas_tol: float = 1e-6) -> Optional[np.ndarray]:
    """Greedy covering incumbent for >=-structured binary minimization
    (reference role: set_cover.h GreedySolutionGenerator, run here as a
    root primal heuristic of the MIP).  Applicable when every
    finite-bounded row is lower-bounded only (cu = +inf), A >= 0, all
    integers are binaries and costs are >= 0: start at the lower bounds
    and repeatedly set the binary with the largest shortfall reduction
    per unit cost.  Ends with a reverse-delete pass dropping redundant
    columns.  Returns the candidate or None when out of scope."""
    a = sp.csr_matrix(qp_min.constraint_matrix)
    cl, cu = qp_min.constraint_lower, qp_min.constraint_upper
    lb, ub = qp_min.variable_lower, qp_min.variable_upper
    c = qp_min.objective_vector
    n = qp_min.num_variables
    if len(int_idx) != n or np.any(lb[int_idx] < 0) \
            or np.any(ub[int_idx] > 1):
        return None
    if np.any(np.isfinite(cu)) or np.any(c < -1e-12) or a.nnz == 0 \
            or np.any(a.data < 0):
        return None
    at = sp.csc_matrix(a)
    x = np.array(lb, dtype=np.float64)
    ax = a @ x
    shortfall = np.maximum(cl - ax, 0.0)
    free = x < 0.5
    for _ in range(n):
        tot = float(shortfall.sum())
        if tot <= feas_tol * max(1.0, float(np.abs(cl[np.isfinite(cl)])
                                            .max(initial=1.0))):
            break
        # gain_j = sum_i min(a_ij, shortfall_i) for rows still short
        best_j, best_ratio = -1, 0.0
        short_rows = shortfall > 0
        for j in np.nonzero(free)[0]:
            lo, hi = at.indptr[j], at.indptr[j + 1]
            rows_j = at.indices[lo:hi]
            vals_j = at.data[lo:hi]
            m = short_rows[rows_j]
            if not m.any():
                continue
            gain = float(np.minimum(vals_j[m], shortfall[rows_j[m]]).sum())
            ratio = gain / (1.0 + max(float(c[j]), 0.0))
            if ratio > best_ratio:
                best_j, best_ratio = int(j), ratio
        if best_j < 0:
            return None  # cannot cover: leave it to the exact search
        x[best_j] = 1.0
        free[best_j] = False
        lo, hi = at.indptr[best_j], at.indptr[best_j + 1]
        ax[at.indices[lo:hi]] += at.data[lo:hi]
        shortfall = np.maximum(cl - ax, 0.0)
    else:
        return None
    # reverse-delete: drop set columns whose removal keeps all rows covered
    order = np.argsort(-c)  # most expensive first
    for j in order:
        if x[j] < 0.5 or lb[j] > 0.5 or c[j] <= 1e-12:
            continue
        lo, hi = at.indptr[j], at.indptr[j + 1]
        rows_j = at.indices[lo:hi]
        if np.all(ax[rows_j] - at.data[lo:hi] >= cl[rows_j] - feas_tol):
            x[j] = 0.0
            ax[rows_j] -= at.data[lo:hi]
    return x


def _one_opt(qp_min, a, at, x, int_idx, feas_tol):
    """Vectorized 1-opt: flip/step any single integer variable that
    improves the objective and keeps all rows feasible."""
    cl, cu = qp_min.constraint_lower, qp_min.constraint_upper
    lb, ub = qp_min.variable_lower, qp_min.variable_upper
    c = qp_min.objective_vector
    x = np.array(x, dtype=np.float64)
    for _ in range(3):  # few passes
        ax = a @ x
        slack_up = cu - ax  # how much each row can increase
        slack_dn = ax - cl
        improved = False
        # try steps -1 and +1 for improving-cost variables
        for step in (-1.0, 1.0):
            cand = int_idx[(c[int_idx] * step < -1e-12)]
            for j in cand:
                xn = x[j] + step
                if xn < lb[j] - 1e-9 or xn > ub[j] + 1e-9:
                    continue
                lo_c, hi_c = at.indptr[j], at.indptr[j + 1]
                rows = at.indices[lo_c:hi_c]
                vals = at.data[lo_c:hi_c] * step
                if np.any(vals > slack_up[rows] + feas_tol) or \
                        np.any(-vals > slack_dn[rows] + feas_tol):
                    continue
                x[j] = xn
                ax[rows] += vals
                slack_up[rows] -= vals
                slack_dn[rows] += vals
                improved = True
        if not improved:
            break
    return x


def fj_objective_descent(
    qp_min: QuadraticProgram,
    x0: Optional[np.ndarray],
    obj0: float,
    deadline: float,
    bound: float = -math.inf,
    seed: int = 17,
    moves_per_rung: int = 200_000,
) -> Optional[np.ndarray]:
    """Objective-ladder feasibility jump for PURE-INTEGER models
    (reference FeasibilityJumpSolver in its objective mode,
    sat/feasibility_jump.h:48): append the objective as a row and ask the
    violation-guided jump for a feasible point at a target between the
    incumbent and the known dual ``bound`` (objective-shaving rungs: a
    failed rung bisects toward the incumbent, a solved rung re-anchors).

    Returns the best improving point found (feasible by construction —
    the caller still re-verifies, as with every incumbent source), or
    None.  Models with continuous variables or unbounded integers are
    rejected (returns None).
    """
    import time

    from ortools_tpu_torch.sat.feasibility_jump import (LinearSystem,
                                                  feasibility_jump)

    n = qp_min.num_variables
    integ = (np.asarray(qp_min.integrality, dtype=bool)
             if qp_min.integrality is not None else np.zeros(n, dtype=bool))
    lb = np.asarray(qp_min.variable_lower, dtype=np.float64)
    ub = np.asarray(qp_min.variable_upper, dtype=np.float64)
    if not integ.all() or not (np.isfinite(lb).all()
                               and np.isfinite(ub).all()):
        return None
    if not qp_min.is_lp():
        return None
    a = sp.csr_matrix(qp_min.constraint_matrix)
    c = np.asarray(qp_min.objective_vector, dtype=np.float64)
    rlo = np.asarray(qp_min.constraint_lower, dtype=np.float64)
    rhi = np.asarray(qp_min.constraint_upper, dtype=np.float64)
    rows = sp.vstack([a, sp.csr_matrix(c[None, :])], format="csr")

    def run_rung(target: float, x_start, rng_seed: int, rung_deadline):
        system = LinearSystem(
            a=rows,
            row_lb=np.concatenate([rlo, [-np.inf]]),
            row_ub=np.concatenate([rhi, [target]]),
            var_lb=lb, var_ub=ub,
        )
        return feasibility_jump(system, x0=x_start,
                                max_moves=moves_per_rung,
                                seed=rng_seed,
                                deadline=min(deadline, rung_deadline))

    # Work entirely in c@x space: callers pass obj0/bound including
    # qp.objective_constant, but rung targets and the improvement test
    # below compare against float(c @ x) without the constant.
    shift = float(qp_min.objective_constant or 0.0)
    best_x = None
    best_obj = obj0 - shift
    bound = bound - shift
    x_start = x0
    rng_seed = seed
    # ambition in [0, 1]: fraction of the incumbent-to-bound gap to ask
    # for; halved on failure, restored on success
    ambition = 0.5
    while time.perf_counter() < deadline:
        if math.isfinite(best_obj):
            gap = (best_obj - bound) if math.isfinite(bound) \
                else 0.05 * (1.0 + abs(best_obj))
            step = max(ambition * gap, 1e-7 * (1.0 + abs(best_obj)))
            target = best_obj - step
        else:
            target = math.inf  # first rung: any feasible point
        rung_secs = max(1.0, (deadline - time.perf_counter()) / 3.0)
        x = run_rung(target, x_start, rng_seed,
                     time.perf_counter() + rung_secs)
        rng_seed += 1
        if x is None:
            ambition *= 0.5
            if ambition < 1e-4 or (
                    math.isfinite(best_obj) and math.isfinite(bound)
                    and ambition * (best_obj - bound)
                    < 1e-7 * (1.0 + abs(best_obj))):
                break
            # alternate restart point between incumbent and random
            x_start = best_x if (rng_seed % 2 == 0 and best_x is not None) \
                else None
            continue
        obj = float(c @ x)
        if obj < best_obj - 1e-12 or best_x is None:
            best_obj = obj
            best_x = np.asarray(x, dtype=np.float64)
            x_start = best_x
            ambition = 0.5
        else:
            ambition *= 0.5
            if ambition < 1e-4:
                break
    return best_x


def one_two_exchange(
    qp_min: QuadraticProgram,
    x: np.ndarray,
    feas_tol: float = 1e-6,
    deadline: float = math.inf,
    max_pair_cands: int = 48,
) -> Optional[np.ndarray]:
    """(1,2)-exchange local search over BINARY variables: for each
    support variable i, try replacing it by one or two non-support
    variables so the move stays feasible and strictly improves the
    (minimization) objective.  The classic independent-set /
    multi-knapsack improvement move; generic over arbitrary two-sided
    rows via activity bookkeeping.

    Returns an improved feasible point or None."""
    import time

    n = qp_min.num_variables
    integ = (np.asarray(qp_min.integrality, dtype=bool)
             if qp_min.integrality is not None else np.zeros(n, dtype=bool))
    lb = np.asarray(qp_min.variable_lower, dtype=np.float64)
    ub = np.asarray(qp_min.variable_upper, dtype=np.float64)
    binary = integ & (lb >= -feas_tol) & (ub <= 1.0 + feas_tol)
    if not binary.any():
        return None
    a = sp.csc_matrix(qp_min.constraint_matrix)
    c = np.asarray(qp_min.objective_vector, dtype=np.float64)
    rlo = np.asarray(qp_min.constraint_lower, dtype=np.float64)
    rhi = np.asarray(qp_min.constraint_upper, dtype=np.float64)
    x = np.array(x, dtype=np.float64)
    act = a @ x

    def col(j):
        s, e = a.indptr[j], a.indptr[j + 1]
        return a.indices[s:e], a.data[s:e]

    def fits(act_v, rows):
        return ((act_v[rows] >= rlo[rows] - feas_tol)
                & (act_v[rows] <= rhi[rows] + feas_tol)).all()

    improved_any = False
    for _round in range(8):
        if time.perf_counter() > deadline:
            break
        improved = False
        support = np.nonzero(binary & (x > 0.5))[0]
        nonsup = np.nonzero(binary & (x < 0.5))[0]
        if len(nonsup) == 0:
            break
        for i in support:
            if time.perf_counter() > deadline:
                break
            ri, di = col(i)
            act_wo = act.copy()
            act_wo[ri] -= di
            # rows needing repair after removing i
            broken = ri[(act_wo[ri] < rlo[ri] - feas_tol)
                        | (act_wo[ri] > rhi[ri] + feas_tol)]
            singles = []
            pair_cands = []
            for j in nonsup:
                rj, dj = col(j)
                gain = c[j] - c[i]
                test = act_wo.copy()
                test[rj] += dj
                touched = np.union1d(rj, broken)
                if fits(test, touched):
                    if gain < -1e-9:
                        singles.append((gain, j))
                    elif len(pair_cands) < max_pair_cands:
                        pair_cands.append(j)
                # j that can't even fit alone is dropped
            did = False
            if singles:
                singles.sort()
                gain, j = singles[0]
                rj, dj = col(j)
                act[ri] -= di
                act[rj] += dj
                x[i], x[j] = 0.0, 1.0
                improved = improved_any = True
                did = True
            elif pair_cands:
                best = None
                for pi in range(len(pair_cands)):
                    j = pair_cands[pi]
                    rj, dj = col(j)
                    base = act_wo.copy()
                    base[rj] += dj
                    for k in pair_cands[pi + 1:]:
                        gain = c[j] + c[k] - c[i]
                        if gain >= -1e-9 or (
                                best is not None and gain >= best[0]):
                            continue
                        rk, dk = col(k)
                        test = base.copy()
                        test[rk] += dk
                        touched = np.union1d(np.union1d(rj, rk), broken)
                        if fits(test, touched):
                            best = (gain, j, k)
                if best is not None:
                    _, j, k = best
                    rj, dj = col(j)
                    rk, dk = col(k)
                    act[ri] -= di
                    act[rj] += dj
                    act[rk] += dk
                    x[i], x[j], x[k] = 0.0, 1.0, 1.0
                    improved = improved_any = True
                    did = True
            if did:
                support = np.nonzero(binary & (x > 0.5))[0]
                nonsup = np.nonzero(binary & (x < 0.5))[0]
        if not improved:
            break
    return x if improved_any else None


def rc_neighborhood(
    qp_min: QuadraticProgram,
    x_inc: np.ndarray,
    y_root: Optional[np.ndarray],
    int_idx: np.ndarray,
    free_size: int = 80,
) -> Optional[tuple]:
    """Reduced-cost neighborhood (an LNS generator in the spirit of
    cp_model_lns.h RelaxationInducedNeighborhoodGenerator): free the
    integer variables with the SMALLEST |reduced cost| at the root duals
    — the ties the LP cannot distinguish are where the optimal solution
    differs from a greedy/rounded incumbent — and fix the rest to the
    incumbent.  Returns (sub_lb, sub_ub) bounds or None."""
    if y_root is None or len(int_idx) < 10:
        return None
    c = np.asarray(qp_min.objective_vector, dtype=np.float64)
    a = sp.csr_matrix(qp_min.constraint_matrix)
    m = qp_min.num_constraints
    y = np.asarray(y_root, dtype=np.float64)[:m]
    rc = c - a.T @ y
    order = int_idx[np.argsort(np.abs(rc[int_idx]), kind="stable")]
    free = set(int(j) for j in order[:min(free_size, len(order))])
    lbr = np.array(qp_min.variable_lower)
    ubr = np.array(qp_min.variable_upper)
    for j in int_idx:
        if int(j) not in free:
            lbr[j] = ubr[j] = x_inc[j]
    return lbr, ubr


def detect_independent_set(qp_min: QuadraticProgram):
    """Detect a pure weighted-independent-set structure: binary
    variables and every row 'sum of +1-coefficient variables <= 1'
    (clique rows are equivalent to their pairwise conflicts for 0/1
    variables).  Returns (adjacency list, weights) or None."""
    n = qp_min.num_variables
    integ = (np.asarray(qp_min.integrality, dtype=bool)
             if qp_min.integrality is not None else np.zeros(n, dtype=bool))
    lb = np.asarray(qp_min.variable_lower)
    ub = np.asarray(qp_min.variable_upper)
    if not (integ.all() and (lb >= -1e-9).all() and (ub <= 1 + 1e-9).all()):
        return None
    a = sp.csr_matrix(qp_min.constraint_matrix)
    rlo = np.asarray(qp_min.constraint_lower)
    rhi = np.asarray(qp_min.constraint_upper)
    # Require true clique rows (rhs >= 1): a row with rhs < 1 forces its
    # variables to 0, which pairwise conflicts cannot express — modeling
    # such a row as at-most-one would admit infeasible IS candidates.
    if not ((rhi <= 1.0 + 1e-9).all() and (rhi >= 1.0 - 1e-9).all()
            and (rlo <= 1e-9).all()):
        return None
    if np.abs(a.data - 1.0).max(initial=0.0) > 1e-9:
        return None
    adj = [set() for _ in range(n)]
    for r in range(a.shape[0]):
        cols = a.indices[a.indptr[r]:a.indptr[r + 1]]
        if len(cols) < 2:
            continue
        for i in range(len(cols)):
            for j in range(i + 1, len(cols)):
                adj[cols[i]].add(int(cols[j]))
                adj[cols[j]].add(int(cols[i]))
    w = -np.asarray(qp_min.objective_vector, dtype=np.float64)
    return adj, w


def wis_ils(adj, w: np.ndarray, deadline: float,
            seed: int = 1) -> np.ndarray:
    """Iterated greedy + (1,2)-swap local search for maximum-weight
    independent set (the engine behind packing-structured MIPs; plays
    the role the reference's LS/LNS portfolio plays on such models).
    Returns a 0/1 incidence vector (always a feasible IS)."""
    import time

    n = len(w)
    rng = np.random.default_rng(seed)
    deg = np.array([len(a) for a in adj], dtype=np.int64)

    def fill_greedy(x, conf, order):
        for v in order:
            if w[v] > 0 and not x[v] and conf[v] == 0:
                x[v] = True
                for u in adj[v]:
                    conf[u] += 1

    def conflicts_of(x):
        conf = np.zeros(n, np.int32)
        for v in np.nonzero(x)[0]:
            for u in adj[v]:
                conf[u] += 1
        return conf

    def improve(x, conf):
        improved = True
        while improved:
            improved = False
            for v in range(n):
                if w[v] > 0 and not x[v] and conf[v] == 0:
                    x[v] = True
                    for u in adj[v]:
                        conf[u] += 1
                    improved = True
            for v in np.nonzero(x)[0]:
                cand = [u for u in adj[v]
                        if w[u] > 0 and not x[u] and conf[u] == 1]
                if not cand:
                    continue
                best = None
                for i2, u in enumerate(cand):
                    if w[u] > w[v] + 1e-12 and (
                            best is None or w[u] > best[0]):
                        best = (w[u], [u])
                    for u2 in cand[i2 + 1:]:
                        if u2 not in adj[u] \
                                and w[u] + w[u2] > w[v] + 1e-12:
                            if best is None or w[u] + w[u2] > best[0]:
                                best = (w[u] + w[u2], [u, u2])
                if best is not None:
                    x[v] = False
                    for u in adj[v]:
                        conf[u] -= 1
                    for u in best[1]:
                        x[u] = True
                        for t in adj[u]:
                            conf[t] += 1
                    improved = True
        return x, conf

    x = np.zeros(n, bool)
    conf = np.zeros(n, np.int32)
    fill_greedy(x, conf, np.argsort(-w / np.maximum(deg, 1)))
    x, conf = improve(x, conf)
    best_x, best_w = x.copy(), float(w[x].sum())
    while time.perf_counter() < deadline:
        x = best_x.copy()
        sup = np.nonzero(x)[0]
        if len(sup) == 0:
            break
        k = max(2, len(sup) // 10)
        drop = rng.choice(sup, size=min(k, len(sup)), replace=False)
        x[drop] = False
        conf = conflicts_of(x)
        fill_greedy(x, conf, rng.permutation(n))
        x, conf = improve(x, conf)
        tw = float(w[x].sum())
        if tw > best_w:
            best_w, best_x = tw, x.copy()
    return best_x.astype(np.float64)


def binary_toggle_ls(
    qp_min: QuadraticProgram,
    x0: np.ndarray,
    int_idx: np.ndarray,
    reopt,
    deadline: float,
) -> Optional[np.ndarray]:
    """Local search for MIXED models with binary integers (fixed-charge /
    facility structure): flip one binary (and first-improvement pair
    swaps), re-optimize the continuous part EXACTLY with the integers
    fixed (warm dual-simplex ``reopt``), keep strictly improving moves.
    Every candidate is feasibility-checked by the caller as usual."""
    import time

    n = qp_min.num_variables
    lb = np.asarray(qp_min.variable_lower)
    ub = np.asarray(qp_min.variable_upper)
    bin_idx = int_idx[(lb[int_idx] >= -1e-9) & (ub[int_idx] <= 1 + 1e-9)]
    if len(bin_idx) == 0 or len(bin_idx) == n:
        return None
    cont_mask = np.ones(n, dtype=bool)
    cont_mask[int_idx] = False
    if not cont_mask.any():
        return None
    c = np.asarray(qp_min.objective_vector, dtype=np.float64)
    a = sp.csr_matrix(qp_min.constraint_matrix)
    cl, cu = qp_min.constraint_lower, qp_min.constraint_upper
    scale = 1.0 + np.maximum(np.abs(np.where(np.isfinite(cl), cl, 0)),
                             np.abs(np.where(np.isfinite(cu), cu, 0)))

    def value_of(x):
        return float(c @ x)

    def feasible(x):
        ax = a @ x
        return ((ax >= cl - 1e-6 * scale).all()
                and (ax <= cu + 1e-6 * scale).all())

    best = np.array(x0, dtype=np.float64)
    best_val = value_of(best)
    improved_any = False

    def try_move(cand) -> bool:
        nonlocal best, best_val, improved_any
        x2 = _reopt_continuous(qp_min, cand, int_idx, cont_mask, reopt)
        if x2 is None:
            return False
        x2 = np.asarray(x2, dtype=np.float64)
        if feasible(x2) and value_of(x2) < best_val - 1e-9:
            best, best_val = x2, value_of(x2)
            improved_any = True
            return True
        return False

    for _sweep in range(6):
        improved = False
        order = np.argsort(-np.abs(c[bin_idx]))
        for j in bin_idx[order]:
            if time.perf_counter() > deadline:
                return best if improved_any else None
            cand = best.copy()
            cand[j] = 1.0 - round(cand[j])
            if try_move(cand):
                improved = True
        # pair swaps: close one open binary, open one closed binary
        # (facility-swap move; first improvement, capped partners)
        open_set = [j for j in bin_idx if best[j] > 0.5]
        closed = sorted((j for j in bin_idx if best[j] < 0.5),
                        key=lambda j: c[j])
        for i in open_set:
            if time.perf_counter() > deadline:
                return best if improved_any else None
            for j in closed[:24]:
                cand = best.copy()
                cand[i], cand[j] = 0.0, 1.0
                if try_move(cand):
                    improved = True
                    break
        if not improved:
            break
    return best if improved_any else None


def feasibility_pump(
    qp_min: QuadraticProgram,
    int_idx: np.ndarray,
    x_lp: Optional[np.ndarray] = None,
    max_pumps: int = 60,
    deadline: float = math.inf,
    rng: Optional[np.random.Generator] = None,
) -> List[np.ndarray]:
    """Proper alternating-projection feasibility pump (reference
    ``ortools/sat/feasibility_pump.{h,cc}``, Fischetti-Glover-Lodi):

      1. project the current integer point onto the LP relaxation by
         minimizing the L1 distance over the integer variables (a LINEAR
         objective: binaries flip sign by rounded value; general integers
         use a split |x - r| <= s with an auxiliary-free two-slope trick
         via shifted costs on the two rounding directions);
      2. round the LP point to the nearest integers;
      3. on cycling, randomly flip the most-fractional coordinates.

    One warm ``RevisedSimplex`` instance serves every projection (only
    the objective changes, so the basis stays primal feasible).  Returns
    integer-valued CANDIDATES for the caller's checker, best-first.
    """
    import dataclasses as _dc
    import time as _time

    from ortools_tpu_torch.glop.simplex import RevisedSimplex
    from ortools_tpu_torch.utils.status import MPSolverStatus

    rng = rng or np.random.default_rng(7)
    n = qp_min.num_variables
    lb = np.asarray(qp_min.variable_lower, dtype=np.float64)
    ub = np.asarray(qp_min.variable_upper, dtype=np.float64)
    is_int = np.zeros(n, dtype=bool)
    is_int[int_idx] = True
    binary = is_int & (lb >= -1e-9) & (ub <= 1 + 1e-9)
    if not np.any(is_int):
        return []
    try:
        sx = RevisedSimplex(qp_min)
    except Exception:
        return []
    if x_lp is None:
        st = sx.primal_solve(deadline=deadline)
        if st != MPSolverStatus.OPTIMAL:
            return []
        x_lp = sx.result(st).primal_solution
    out: List[np.ndarray] = []
    seen = set()
    x = np.array(x_lp, dtype=np.float64)
    for _ in range(max_pumps):
        if _time.perf_counter() > deadline:
            break
        r = np.round(np.clip(x, lb, ub))
        key = tuple(r[int_idx].astype(np.int64).tolist())
        if key in seen:
            # cycle: flip the most-fractional integer coordinates
            frac = np.abs(x - np.round(x))
            order = int_idx[np.argsort(-frac[int_idx])]
            k = max(2, len(int_idx) // 10)
            flips = order[:k]
            r[flips] = np.where(r[flips] > 0.5, 0.0, 1.0) if \
                np.all(binary[flips]) else np.clip(
                    r[flips] + rng.integers(-1, 2, len(flips)),
                    lb[flips], ub[flips])
            key = tuple(r[int_idx].astype(np.int64).tolist())
            if key in seen:
                break
        seen.add(key)
        cand = np.array(x)
        cand[int_idx] = r[int_idx]
        out.append(cand)
        # distance objective: for binaries, min sum_{r=0} x + sum_{r=1}(1-x)
        # -> c = +1 where r=0, -1 where r=1 (constant dropped); general
        # integers get the one-sided slope toward r (exact for moves that
        # do not cross r — the pump's standard linearization)
        c = np.zeros(n)
        c[int_idx] = np.where(r[int_idx] <= x[int_idx], 1.0, -1.0)
        c[binary] = np.where(r[binary] > 0.5, -1.0, 1.0)
        sx.set_objective(c)
        st = sx.primal_solve(deadline=deadline)
        if st != MPSolverStatus.OPTIMAL:
            break
        x = sx.result(st).primal_solution
        dist = float(np.abs(x[int_idx] - r[int_idx]).sum())
        if dist <= 1e-6:
            # integral LP point: the pump converged to a feasible point
            cand = np.array(x)
            cand[int_idx] = np.round(x[int_idx])
            out.append(cand)
            break
    # best-first: later candidates are usually closer to feasibility
    out.reverse()
    return out


def detect_set_cover(qp_min: QuadraticProgram):
    """Detect pure weighted set-covering structure: binary variables,
    every row 'sum of +1-coefficient variables >= 1', positive costs.
    Returns (rows_of_col, cols_of_row, costs) or None."""
    n = qp_min.num_variables
    integ = (np.asarray(qp_min.integrality, dtype=bool)
             if qp_min.integrality is not None else np.zeros(n, dtype=bool))
    lb = np.asarray(qp_min.variable_lower)
    ub = np.asarray(qp_min.variable_upper)
    c = np.asarray(qp_min.objective_vector, dtype=np.float64)
    if not (integ.all() and (lb >= -1e-9).all() and (ub <= 1 + 1e-9).all()
            and (c > 0).all()):
        return None
    a = sp.csr_matrix(qp_min.constraint_matrix)
    rlo = np.asarray(qp_min.constraint_lower)
    rhi = np.asarray(qp_min.constraint_upper)
    m = a.shape[0]
    if m == 0:
        return None
    if not (np.isfinite(rlo).all() and (np.abs(rlo - 1.0) <= 1e-9).all()
            and (~np.isfinite(rhi)).all()):
        return None
    if a.nnz == 0 or np.abs(a.data - 1.0).max(initial=0.0) > 1e-9:
        return None
    acsc = a.tocsc()
    rows_of_col = [acsc.indices[acsc.indptr[j]:acsc.indptr[j + 1]]
                   for j in range(n)]
    cols_of_row = [a.indices[a.indptr[i]:a.indptr[i + 1]]
                   for i in range(m)]
    if any(len(ci) == 0 for ci in cols_of_row):
        return None
    return rows_of_col, cols_of_row, c


def sc_iterated_greedy(rows_of_col, cols_of_row, cost, deadline: float,
                       seed: int = 0) -> Optional[np.ndarray]:
    """Iterated greedy for weighted set covering (reference role:
    ortools/algorithms/set_cover.h greedy + steepest/tabu improvement):
    randomized-greedy construct -> drop redundant sets -> destroy a
    random fraction -> re-greedy, keeping the best cover found.
    Returns a 0/1 vector or None."""
    import time as _time

    rng = np.random.default_rng(seed)
    m = len(cols_of_row)
    n = len(rows_of_col)
    # bool row-membership matrix for vectorized gain computation
    indptr = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        indptr[j + 1] = indptr[j] + len(rows_of_col[j])
    indices = np.concatenate(rows_of_col) if n else np.zeros(0, int)
    a_cols = sp.csc_matrix(
        (np.ones(len(indices)), indices, indptr), shape=(m, n))
    at = a_cols.T.tocsr()

    def greedy(chosen: set, cover_count: np.ndarray, noise: float) -> bool:
        while True:
            unc = (cover_count == 0).astype(np.float64)
            if not unc.any():
                return True
            gains = at @ unc  # per column: # of uncovered rows it covers
            if chosen:
                gains[list(chosen)] = 0.0
            cov = gains > 0
            if not cov.any():
                return False
            score = np.full(n, np.inf)
            score[cov] = cost[cov] / gains[cov]
            if noise:
                score[cov] *= 1.0 + noise * rng.random(int(cov.sum()))
            best_j = int(np.argmin(score))
            chosen.add(best_j)
            cover_count[rows_of_col[best_j]] += 1

    def prune(chosen: set, cover_count: np.ndarray) -> None:
        # drop redundant sets, most expensive first
        for j in sorted(chosen, key=lambda t: -cost[t]):
            rs = rows_of_col[j]
            if len(rs) and (cover_count[rs] >= 2).all():
                chosen.discard(j)
                cover_count[rs] -= 1

    chosen: set = set()
    cover_count = np.zeros(m, dtype=np.int32)
    if not greedy(chosen, cover_count, 0.0):
        return None
    prune(chosen, cover_count)
    best = set(chosen)
    best_cost = float(cost[list(best)].sum())
    # stop early once improvement dries up: a flat budget taxes easy
    # instances whose tree would close the gap faster than more LS
    last_improve = _time.perf_counter()
    stale_window = max(2.0, 0.25 * (deadline - last_improve))
    while _time.perf_counter() < deadline:
        if _time.perf_counter() - last_improve > stale_window:
            break
        # destroy 10-35% of the current cover
        cur = set(best)
        cc = np.zeros(m, dtype=np.int32)
        for j in cur:
            cc[rows_of_col[j]] += 1
        # 30-60% destruction escapes basins that small perturbations
        # cannot (measured 31.8 -> 30.8 on set_cover_400x150)
        k = max(1, int(len(cur) * rng.uniform(0.3, 0.6)))
        for j in rng.choice(list(cur), size=min(k, len(cur)),
                            replace=False):
            cur.discard(int(j))
            cc[rows_of_col[int(j)]] -= 1
        if not greedy(cur, cc, noise=0.3):
            continue
        prune(cur, cc)
        c_cur = float(cost[list(cur)].sum())
        if c_cur < best_cost - 1e-12:
            best, best_cost = set(cur), c_cur
            last_improve = _time.perf_counter()
    x = np.zeros(n)
    x[list(best)] = 1.0
    return x


def sc_lagrangian(rows_of_col, cols_of_row, cost, deadline: float,
                  seed: int = 0,
                  max_iters: int = 20000,
                  n_elite: int = 12):
    """CFT-style Lagrangian heuristic for weighted set covering
    (Caprara-Fischetti-Toth 1999; reference role: the set-cover
    primal/dual engines of ``ortools/algorithms/set_cover.h``).

    Subgradient optimization of the Lagrangian dual
    ``L(u) = sum_i u_i + sum_j min(c_j - sum_{i in rows(j)} u_i, 0)``
    interleaved with greedy cover construction on the Lagrangian reduced
    costs and redundancy pruning.  The dual multipliers steer the greedy
    toward columns the LP wants — covers that plain cost-greedy restarts
    miss.  When the step collapses, the multipliers are perturbed and the
    schedule restarts (CFT's re-optimization phases).

    Returns ``(best_x, elites)`` where ``best_x`` is the best 0/1 cover
    (or None) and ``elites`` is a list of up to ``n_elite`` distinct
    (cost, column-index-array) covers found — the restricted-master pool.
    """
    import time as _time

    rng = np.random.default_rng(seed)
    m = len(cols_of_row)
    n = len(rows_of_col)
    if m == 0 or n == 0:
        return None, []
    cost = np.asarray(cost, dtype=np.float64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        indptr[j + 1] = indptr[j] + len(rows_of_col[j])
    indices = np.concatenate(rows_of_col) if n else np.zeros(0, int)
    a = sp.csc_matrix((np.ones(len(indices)), indices, indptr),
                      shape=(m, n))  # rows x cols
    at = a.T.tocsr()
    col_sz = np.maximum(np.diff(indptr), 1)

    # u_i init: cheapest cost-per-row share among covering columns
    with np.errstate(divide="ignore"):
        share = cost / col_sz
    u = np.full(m, np.inf)
    for j in range(n):
        np.minimum.at(u, rows_of_col[j], share[j])
    u[~np.isfinite(u)] = 0.0

    def greedy_from(rc: np.ndarray, noise: float) -> Optional[np.ndarray]:
        """Greedy cover scored by Lagrangian costs; prune redundant."""
        chosen: List[int] = []
        covered = np.zeros(m, dtype=bool)
        cc = np.zeros(m, dtype=np.int32)
        while not covered.all():
            unc = (~covered).astype(np.float64)
            gains = at @ unc
            cov = gains > 0
            if chosen:
                cov[chosen] = False
            if not cov.any():
                return None
            score = np.full(n, np.inf)
            pos = cov & (rc > 0)
            score[pos] = rc[pos] / gains[pos]
            neg = cov & (rc <= 0)
            score[neg] = rc[neg] * gains[neg]
            if noise:
                fin = np.isfinite(score)
                score[fin] += noise * rng.random(int(fin.sum())) * (
                    np.abs(score[fin]) + 1e-3)
            j = int(np.argmin(score))
            chosen.append(j)
            covered[rows_of_col[j]] = True
            cc[rows_of_col[j]] += 1
        for j in sorted(chosen, key=lambda t: -cost[t]):
            rs = rows_of_col[j]
            if len(rs) and (cc[rs] >= 2).all():
                chosen.remove(j)
                cc[rs] -= 1
        x = np.zeros(n)
        x[chosen] = 1.0
        return x

    best_x = None
    best_ub = math.inf
    best_lb = -math.inf
    elites: dict = {}  # frozenset(cols) -> cost
    lam = 2.0
    stall = 0

    def record(x: np.ndarray) -> None:
        nonlocal best_x, best_ub
        cx = float(cost @ x)
        key = frozenset(np.nonzero(x)[0].tolist())
        if key not in elites:
            elites[key] = cx
            if len(elites) > 4 * n_elite:
                for k in sorted(elites, key=elites.get)[4 * n_elite:]:
                    del elites[k]
        if cx < best_ub - 1e-12:
            best_ub = cx
            best_x = x

    for it in range(max_iters):
        if _time.perf_counter() > deadline:
            break
        rc = cost - (at @ u)  # Lagrangian reduced costs
        xneg = rc < 0
        lb = float(u.sum() + rc[xneg].sum())
        if lb > best_lb + 1e-9:
            best_lb = lb
            stall = 0
        else:
            stall += 1
            if stall >= 30:
                lam *= 0.5
                stall = 0
        if lam < 1e-3:
            # CFT re-optimization phase: perturb multipliers, restart step
            u = u * rng.uniform(0.9, 1.1, m)
            lam = 1.5
        g = 1.0 - (a @ xneg.astype(np.float64))
        gnorm = float(g @ g)
        if gnorm < 1e-12:
            record_x = greedy_from(rc, 0.0)
            if record_x is not None:
                record(record_x)
            u = u * rng.uniform(0.95, 1.05, m)
            continue
        ub_ref = best_ub if math.isfinite(best_ub) else max(1.5 * lb,
                                                            lb + 1.0)
        t = lam * max(ub_ref - lb, 1e-6) / gnorm
        u = np.maximum(0.0, u + t * g)
        if it % 2 == 0:
            x = greedy_from(rc, 0.0 if it % 10 else 0.3)
            if x is not None:
                record(x)
        if math.isfinite(best_ub) and best_ub - best_lb <= 1e-9 * (
                1 + abs(best_ub)):
            break
    elite_list = sorted(((c, np.array(sorted(k), dtype=np.int64))
                         for k, c in elites.items()),
                        key=lambda t: t[0])[:n_elite]
    return best_x, elite_list
