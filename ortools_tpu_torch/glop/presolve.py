"""LP presolve with postsolve (the port's copy of
``ortools_tpu/glop/presolve.py``: numpy and scipy only, kept line for line
so that ``tests/test_torch_presolve.py`` can hold the two against each
other).

Capability parity: ``ortools/glop/preprocessor.{h,cc}`` (MainLpPreprocessor
and its rule classes, SURVEY §2.2) scoped to the composable core:

Basic vectorized pass (``_basic_pass``):

- EmptyConstraint: rows with no entries (feasibility check, drop);
- SingletonRow: one-entry rows fold into variable bounds;
- FixedVariable: lb == ub substitution into row activities;
- EmptyColumn: cost-sign placement at a finite bound (dual-infeasible if
  the needed bound is infinite);
- implied free/forcing-row detection via activity bounds (infeasibility);

Substitution pass (``_subst_pass``, reference
ImpliedFreePreprocessor / DoubletonEqualityRowPreprocessor /
DuplicateRowPreprocessor, preprocessor.h:271-1074):

- duplicate (proportional) rows merged with bound provenance tracking;
- implied-free column singletons in equality rows eliminated with the
  row (cost folded onto the row's other columns);
- doubleton equality rows: one variable substituted out of the whole
  matrix, its bounds folded onto the partner.

``presolve`` chains basic and substitution passes to a fix point and
returns either a single-stage :class:`PresolveResult` or a
:class:`ChainedPresolveResult` exposing the same surface.

Each fired rule pushes an undo record; ``postsolve`` reconstructs a primal
solution of the ORIGINAL problem.  ``postsolve_duals`` replays the undo
logs in reverse (the reference's exact undo-stack design,
preprocessor.h:271).  For a dropped singleton row, a reduced cost stranded
on a bound that the row imposed transfers to that row's dual
(y_i = r_j / a_ij), which zeroes the residual exactly because a singleton
row touches one column.  For an eliminated column j pivoting on row i,
setting y_i = (c_j - sum_{r != i} a_rj y_r) / a_ij zeroes r_j and leaves
every other column's reduced cost unchanged (the substitution is a linear
change of variables; duality commutes), except when the partner variable
of a doubleton sits on a bound folded from x_j — then the one free dual
degree moves the slack onto r_j instead (complementarity patch).
Redundant rows keep dual 0 (valid: they are implied); fixed/empty columns
keep their recomputed reduced costs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.models.lp import QuadraticProgram


class PresolveStatus(enum.Enum):
    REDUCED = 0
    UNCHANGED = 1
    PRIMAL_INFEASIBLE = 2
    DUAL_INFEASIBLE = 3  # unbounded direction found


@dataclasses.dataclass
class PresolveResult:
    status: PresolveStatus
    reduced: Optional[QuadraticProgram]
    kept_rows: np.ndarray  # original row indices kept
    kept_cols: np.ndarray  # original col indices kept
    fixed_values: np.ndarray  # value for every original col (nan if kept)
    # Undo log of folded singleton rows, in firing order:
    # (row, col, a_ij, imposed_lo, imposed_hi) — bounds in x_j space.
    singleton_log: List[Tuple[int, int, float, float, float]] = \
        dataclasses.field(default_factory=list)

    def postsolve(self, x_reduced: np.ndarray) -> np.ndarray:
        n = len(self.fixed_values)
        x = np.array(self.fixed_values)
        x[self.kept_cols] = x_reduced
        return x

    def postsolve_duals(self, qp: QuadraticProgram, x: np.ndarray,
                        y_reduced: np.ndarray, tol: float = 1e-7
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact dual reconstruction (reference undo-stack postsolve).

        Replays the singleton-row log in reverse: when the final reduced
        cost of x_j is complementary to a bound that only the dropped
        singleton row i imposed (the original variable bound is strictly
        looser), the reduced cost moves onto y_i = r_j / a_ij; since row i
        touches only column j this zeroes r_j without disturbing any other
        column.  Rows dropped as redundant are implied by the rest, so
        dual 0 is optimal for them."""
        qp = qp.as_minimization()
        m = qp.num_constraints
        y = np.zeros(m)
        y[self.kept_rows] = y_reduced
        at = sp.csc_matrix(qp.constraint_matrix)
        r = np.asarray(qp.objective_vector - at.T @ y, dtype=np.float64)
        lb = qp.variable_lower
        ub = qp.variable_upper
        for (i, j, aij, lo_imp, hi_imp) in reversed(self.singleton_log):
            if abs(r[j]) <= tol:
                continue
            scale = 1.0 + abs(x[j])
            if r[j] > 0:
                # complementary with a LOWER bound; transfer when x_j sits
                # on the imposed bound and the original bound is looser
                if (np.isfinite(lo_imp) and abs(x[j] - lo_imp) <= tol * scale
                        and (not np.isfinite(lb[j])
                             or lo_imp > lb[j] + tol * scale)):
                    y[i] += r[j] / aij
                    r[j] = 0.0
            else:
                if (np.isfinite(hi_imp) and abs(x[j] - hi_imp) <= tol * scale
                        and (not np.isfinite(ub[j])
                             or hi_imp < ub[j] - tol * scale)):
                    y[i] += r[j] / aij
                    r[j] = 0.0
        rc = np.where(
            r > 0,
            np.where(np.isfinite(lb), r, 0.0),
            np.where(np.isfinite(ub), r, 0.0),
        )
        return y, rc


def _basic_pass(qp: QuadraticProgram, max_rounds: int = 10,
                feas_tol: float = 1e-9) -> PresolveResult:
    """Run the vectorized mask-based rule set to a fix point.  LP only
    (quadratic objective disables everything except validation)."""
    qp = qp.as_minimization()
    m, n = qp.num_constraints, qp.num_variables
    if not qp.is_lp():
        return PresolveResult(
            PresolveStatus.UNCHANGED, qp,
            np.arange(m), np.arange(n), np.full(n, np.nan),
        )
    a = sp.csr_matrix(qp.constraint_matrix).astype(np.float64)
    cl = np.array(qp.constraint_lower, dtype=np.float64)
    cu = np.array(qp.constraint_upper, dtype=np.float64)
    lb = np.array(qp.variable_lower, dtype=np.float64)
    ub = np.array(qp.variable_upper, dtype=np.float64)
    c = np.array(qp.objective_vector, dtype=np.float64)
    row_alive = np.ones(m, dtype=bool)
    col_alive = np.ones(n, dtype=bool)
    fixed = np.full(n, np.nan)
    changed_any = False
    singleton_log: List[Tuple[int, int, float, float, float]] = []

    csc = sp.csc_matrix(a)

    def row_entries(i):
        s, e = a.indptr[i], a.indptr[i + 1]
        idx = a.indices[s:e]
        val = a.data[s:e]
        keep = col_alive[idx] & (val != 0)
        return idx[keep], val[keep]

    def col_entries(j):
        s, e = csc.indptr[j], csc.indptr[j + 1]
        idx = csc.indices[s:e]
        val = csc.data[s:e]
        keep = row_alive[idx] & (val != 0)
        return idx[keep], val[keep]

    def fix_var(j, value) -> bool:
        nonlocal changed_any
        if value < lb[j] - feas_tol or value > ub[j] + feas_tol:
            return False
        col_alive[j] = False
        fixed[j] = value
        changed_any = True
        if value != 0.0:
            rows, vals = col_entries(j)
            cl[rows] -= vals * value
            cu[rows] -= vals * value
        return True

    for _ in range(max_rounds):
        changed = False
        # variable bound sanity
        if np.any(lb[col_alive] > ub[col_alive] + feas_tol):
            return PresolveResult(PresolveStatus.PRIMAL_INFEASIBLE, None,
                                  np.arange(m), np.arange(n), fixed)
        # fixed variables
        for j in np.nonzero(col_alive & (np.abs(ub - lb) <= feas_tol))[0]:
            if not fix_var(j, 0.5 * (lb[j] + ub[j])):
                return PresolveResult(
                    PresolveStatus.PRIMAL_INFEASIBLE, None,
                    np.arange(m), np.arange(n), fixed,
                )
            changed = True
        # rows: empty and singleton
        for i in np.nonzero(row_alive)[0]:
            idx, val = row_entries(i)
            if len(idx) == 0:
                if cl[i] > feas_tol or cu[i] < -feas_tol:
                    return PresolveResult(
                        PresolveStatus.PRIMAL_INFEASIBLE, None,
                        np.arange(m), np.arange(n), fixed,
                    )
                row_alive[i] = False
                changed = True
            elif len(idx) == 1:
                j, aij = int(idx[0]), float(val[0])
                lo, hi = cl[i] / aij, cu[i] / aij
                if aij < 0:
                    lo, hi = hi, lo
                singleton_log.append((int(i), j, aij, lo, hi))
                if lo > lb[j]:
                    lb[j] = lo
                if hi < ub[j]:
                    ub[j] = hi
                if lb[j] > ub[j] + feas_tol:
                    return PresolveResult(
                        PresolveStatus.PRIMAL_INFEASIBLE, None,
                        np.arange(m), np.arange(n), fixed,
                    )
                row_alive[i] = False
                changed = True
        # empty columns
        for j in np.nonzero(col_alive)[0]:
            rows, _ = col_entries(j)
            if len(rows) == 0:
                if c[j] > 0:
                    tgt = lb[j]
                elif c[j] < 0:
                    tgt = ub[j]
                else:
                    tgt = np.clip(0.0, lb[j], ub[j])
                if not np.isfinite(tgt):
                    return PresolveResult(
                        PresolveStatus.DUAL_INFEASIBLE, None,
                        np.arange(m), np.arange(n), fixed,
                    )
                fix_var(j, float(tgt))
                changed = True
        # forcing/infeasible rows via activity bounds
        for i in np.nonzero(row_alive)[0]:
            idx, val = row_entries(i)
            if len(idx) == 0:
                continue
            t_lo = np.where(val > 0, val * lb[idx], val * ub[idx])
            t_hi = np.where(val > 0, val * ub[idx], val * lb[idx])
            act_lo, act_hi = t_lo.sum(), t_hi.sum()
            if act_lo > cu[i] + feas_tol * (1 + abs(cu[i])) or \
               act_hi < cl[i] - feas_tol * (1 + abs(cl[i])):
                return PresolveResult(
                    PresolveStatus.PRIMAL_INFEASIBLE, None,
                    np.arange(m), np.arange(n), fixed,
                )
            if act_lo >= cl[i] - feas_tol and act_hi <= cu[i] + feas_tol:
                row_alive[i] = False  # redundant (free) row
                changed = True
        if not changed:
            break
        changed_any = changed_any or changed

    kept_rows = np.nonzero(row_alive)[0]
    kept_cols = np.nonzero(col_alive)[0]
    if len(kept_cols) == 0:
        # everything fixed: represent as an empty LP
        reduced = QuadraticProgram(
            objective_vector=np.zeros(0),
            constraint_matrix=sp.csr_matrix((0, 0)),
            constraint_lower=np.zeros(0),
            constraint_upper=np.zeros(0),
            variable_lower=np.zeros(0),
            variable_upper=np.zeros(0),
            objective_constant=qp.objective_constant
            + float(np.nansum(qp.objective_vector * np.nan_to_num(fixed))),
        )
        return PresolveResult(PresolveStatus.REDUCED, reduced,
                              kept_rows, kept_cols, fixed, singleton_log)
    sub = sp.csr_matrix(a[np.ix_(kept_rows, kept_cols)])
    obj_shift = float(np.nansum(
        np.where(col_alive, 0.0, qp.objective_vector * np.nan_to_num(fixed))
    ))
    reduced = QuadraticProgram(
        objective_vector=c[kept_cols],
        constraint_matrix=sub,
        constraint_lower=cl[kept_rows],
        constraint_upper=cu[kept_rows],
        variable_lower=lb[kept_cols],
        variable_upper=ub[kept_cols],
        objective_constant=qp.objective_constant + obj_shift,
        name=qp.name,
    )
    status = PresolveStatus.REDUCED if changed_any else \
        PresolveStatus.UNCHANGED
    return PresolveResult(status, reduced, kept_rows, kept_cols, fixed,
                          singleton_log)


# ---------------------------------------------------------------------------
# Substitution pass: duplicate rows, implied-free column singletons,
# doubleton equality rows.  Reference: glop/preprocessor.h:271-1074
# (DuplicateRow / ImpliedFree / DoubletonEqualityRow preprocessors).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ElimRecord:
    """Snapshot of one eliminated (row, col) pair, at elimination time."""
    kind: str            # 'free_singleton' | 'doubleton'
    row: int             # pivot row i (equality)
    col: int             # eliminated column j
    a_ij: float
    rhs: float           # equality right-hand side d
    c_j: float           # cost of x_j at elimination time
    row_cols: np.ndarray  # row i entries at elimination time (incl. j)
    row_vals: np.ndarray
    col_rows: np.ndarray  # column j entries at elimination time (incl. i)
    col_vals: np.ndarray
    partner: int = -1     # doubleton partner k
    a_ik: float = 0.0
    k_lb_old: float = -np.inf  # partner bounds before folding
    k_ub_old: float = np.inf


@dataclasses.dataclass
class _DupRowRecord:
    """row[drop] == scale * row[keep]; merged bounds live on `keep`."""
    keep: int
    drop: int
    scale: float
    lo_from_drop: bool   # merged lower bound strictly from the dropped row
    hi_from_drop: bool


@dataclasses.dataclass
class _SubstResult:
    """Substitution-pass result; same duck-typed surface as PresolveResult."""
    status: PresolveStatus
    reduced: Optional[QuadraticProgram]
    kept_rows: np.ndarray
    kept_cols: np.ndarray
    fixed_values: np.ndarray   # all-nan: substituted cols are not constants
    log: list = dataclasses.field(default_factory=list)  # LIFO undo records

    def postsolve(self, x_reduced: np.ndarray) -> np.ndarray:
        x = np.array(self.fixed_values)
        x[self.kept_cols] = x_reduced
        for rec in reversed(self.log):
            if isinstance(rec, _DupRowRecord):
                continue
            other = rec.row_cols != rec.col
            acc = rec.rhs - float(
                rec.row_vals[other] @ x[rec.row_cols[other]])
            x[rec.col] = acc / rec.a_ij
        return x

    def postsolve_duals(self, qp: QuadraticProgram, x: np.ndarray,
                        y_reduced: np.ndarray, tol: float = 1e-7
                        ) -> Tuple[np.ndarray, np.ndarray]:
        qp = qp.as_minimization()
        m, n = qp.num_constraints, qp.num_variables
        y = np.zeros(m)
        y[self.kept_rows] = y_reduced
        # Running reduced costs, valid for the problem state at each replay
        # point.  Kept columns start at the reduced problem's reduced costs.
        rc_run = np.zeros(n)
        if self.reduced is not None and self.reduced.num_variables:
            a_red = sp.csc_matrix(self.reduced.constraint_matrix)
            rc_run[self.kept_cols] = np.asarray(
                self.reduced.objective_vector - a_red.T @ y_reduced,
                dtype=np.float64)
        for rec in reversed(self.log):
            if isinstance(rec, _DupRowRecord):
                yk = y[rec.keep]
                if yk > 0 and rec.lo_from_drop:
                    y[rec.drop] = yk / rec.scale
                    y[rec.keep] = 0.0
                elif yk < 0 and rec.hi_from_drop:
                    y[rec.drop] = yk / rec.scale
                    y[rec.keep] = 0.0
                continue
            i, j = rec.row, rec.col
            other = rec.col_rows != i
            rho = rec.c_j - float(
                rec.col_vals[other] @ y[rec.col_rows[other]])
            y_star = rho / rec.a_ij
            if rec.kind == 'doubleton':
                k = rec.partner
                scale = 1.0 + abs(x[k])
                interior = (x[k] > rec.k_lb_old + tol * scale
                            and x[k] < rec.k_ub_old - tol * scale)
                if interior and abs(rc_run[k]) > tol:
                    # x_k sits on a bound folded from x_j: the dual slack
                    # belongs to x_j (at its own bound), not x_k.
                    y[i] = y_star + rc_run[k] / rec.a_ik
                    rc_run[j] = -rec.a_ij * rc_run[k] / rec.a_ik
                    rc_run[k] = 0.0
                    continue
            y[i] = y_star
            rc_run[j] = 0.0
        at = sp.csc_matrix(qp.constraint_matrix)
        r = np.asarray(qp.objective_vector - at.T @ y, dtype=np.float64)
        lb, ub = qp.variable_lower, qp.variable_upper
        rc = np.where(
            r > 0,
            np.where(np.isfinite(lb), r, 0.0),
            np.where(np.isfinite(ub), r, 0.0),
        )
        return y, rc


def _fold_interval(lo_j: float, hi_j: float, shift: float, ratio: float
                   ) -> Tuple[float, float]:
    """Bounds on x_k implied by lo_j <= shift + ratio * x_k <= hi_j."""
    if ratio > 0:
        lo = (lo_j - shift) / ratio if np.isfinite(lo_j) else -np.inf
        hi = (hi_j - shift) / ratio if np.isfinite(hi_j) else np.inf
    else:
        lo = (hi_j - shift) / ratio if np.isfinite(hi_j) else -np.inf
        hi = (lo_j - shift) / ratio if np.isfinite(lo_j) else np.inf
    return lo, hi


def _subst_pass(qp: QuadraticProgram, feas_tol: float = 1e-9,
                max_col_fill: int = 50, max_sweeps: int = 5
                ) -> _SubstResult:
    """Eliminate variables via equality-row substitution.

    Reference: glop/preprocessor.h ImpliedFreePreprocessor,
    DoubletonEqualityRowPreprocessor, DuplicateRowPreprocessor."""
    qp = qp.as_minimization()
    m, n = qp.num_constraints, qp.num_variables
    nan = np.full(n, np.nan)
    if not qp.is_lp() or m == 0 or n == 0:
        return _SubstResult(PresolveStatus.UNCHANGED, qp,
                            np.arange(m), np.arange(n), nan)
    a_csr = sp.csr_matrix(qp.constraint_matrix).astype(np.float64)
    rows: list = [dict() for _ in range(m)]
    cols: list = [dict() for _ in range(n)]
    for i in range(m):
        s, e = a_csr.indptr[i], a_csr.indptr[i + 1]
        for j, v in zip(a_csr.indices[s:e], a_csr.data[s:e]):
            if v != 0.0:
                rows[i][int(j)] = float(v)
                cols[int(j)][i] = float(v)
    cl = np.array(qp.constraint_lower, dtype=np.float64)
    cu = np.array(qp.constraint_upper, dtype=np.float64)
    lb = np.array(qp.variable_lower, dtype=np.float64)
    ub = np.array(qp.variable_upper, dtype=np.float64)
    c = np.array(qp.objective_vector, dtype=np.float64)
    const = float(qp.objective_constant)
    row_alive = np.ones(m, dtype=bool)
    col_alive = np.ones(n, dtype=bool)
    log: list = []

    def infeasible() -> _SubstResult:
        return _SubstResult(PresolveStatus.PRIMAL_INFEASIBLE, None,
                            np.arange(m), np.arange(n), nan, log)

    # --- duplicate (proportional) rows ------------------------------------
    groups: dict = {}
    for i in range(m):
        if len(rows[i]) >= 1:
            groups.setdefault(tuple(sorted(rows[i])), []).append(i)
    for support, members in groups.items():
        if len(members) < 2:
            continue
        keep = members[0]
        base = np.array([rows[keep][j] for j in support])
        bnorm = np.max(np.abs(base))
        for drop in members[1:]:
            vals = np.array([rows[drop][j] for j in support])
            s = vals[0] / base[0]
            if not np.all(np.abs(vals - s * base)
                          <= 1e-12 * max(bnorm * abs(s), 1.0)):
                continue
            # activity(drop) = s * activity(keep): map drop's bounds
            lo2, hi2 = _fold_interval(cl[drop], cu[drop], 0.0, s)
            new_lo = max(cl[keep], lo2)
            new_hi = min(cu[keep], hi2)
            if new_lo > new_hi + feas_tol * (1.0 + abs(new_lo)):
                return infeasible()
            log.append(_DupRowRecord(
                keep=keep, drop=drop, scale=s,
                lo_from_drop=lo2 > cl[keep],
                hi_from_drop=hi2 < cu[keep]))
            cl[keep], cu[keep] = new_lo, new_hi
            row_alive[drop] = False
            for j in rows[drop]:
                del cols[j][drop]
            rows[drop] = {}

    # --- equality-row substitutions ---------------------------------------
    def is_equality(i: int) -> bool:
        return (np.isfinite(cl[i]) and np.isfinite(cu[i])
                and abs(cu[i] - cl[i]) <= feas_tol * (1.0 + abs(cl[i])))

    def snapshot(i: int, j: int) -> Tuple[np.ndarray, ...]:
        rcx = np.fromiter(rows[i].keys(), dtype=np.int64)
        rvx = np.fromiter(rows[i].values(), dtype=np.float64)
        ccx = np.fromiter(cols[j].keys(), dtype=np.int64)
        cvx = np.fromiter(cols[j].values(), dtype=np.float64)
        return rcx, rvx, ccx, cvx

    def drop_pivot(i: int, j: int) -> None:
        for jj in rows[i]:
            if jj != j:
                del cols[jj][i]
        rows[i] = {}
        cols[j] = {}
        row_alive[i] = False
        col_alive[j] = False

    for _ in range(max_sweeps):
        changed = False
        # implied-free column singletons in equality rows
        for j in range(n):
            if not col_alive[j] or len(cols[j]) != 1:
                continue
            i = next(iter(cols[j]))
            if not is_equality(i):
                continue
            a_ij = cols[j][i]
            row_max = max(abs(v) for v in rows[i].values())
            if abs(a_ij) < 1e-8 * max(row_max, 1.0):
                continue
            d = 0.5 * (cl[i] + cu[i])
            # implied range of x_j over the other columns' bounds
            olo = ohi = 0.0
            for k, v in rows[i].items():
                if k == j:
                    continue
                t0 = v * lb[k] if v > 0 else v * ub[k]
                t1 = v * ub[k] if v > 0 else v * lb[k]
                olo += t0
                ohi += t1
            imp_lo, imp_hi = _fold_interval(d - ohi, d - olo, 0.0, a_ij)
            s_j = 1.0 + max(abs(imp_lo) if np.isfinite(imp_lo) else 0.0,
                            abs(imp_hi) if np.isfinite(imp_hi) else 0.0)
            if not (imp_lo >= lb[j] - feas_tol * s_j
                    and imp_hi <= ub[j] + feas_tol * s_j):
                continue
            rcx, rvx, ccx, cvx = snapshot(i, j)
            log.append(_ElimRecord(
                'free_singleton', i, j, a_ij, d, c[j], rcx, rvx, ccx, cvx))
            shift = c[j] / a_ij
            for k, v in rows[i].items():
                if k != j:
                    c[k] -= shift * v
            const += shift * d
            drop_pivot(i, j)
            changed = True
        # doubleton equality rows
        for i in range(m):
            if not row_alive[i] or len(rows[i]) != 2 or not is_equality(i):
                continue
            (j0, v0), (j1, v1) = rows[i].items()
            d = 0.5 * (cl[i] + cu[i])
            # pick the pivot column: less fill, then larger pivot magnitude
            cand = []
            for (jj, vv, kk, vk) in ((j0, v0, j1, v1), (j1, v1, j0, v0)):
                if len(cols[jj]) <= max_col_fill and \
                        abs(vv) >= 1e-8 * max(abs(v0), abs(v1)):
                    cand.append((len(cols[jj]), -abs(vv), jj, vv, kk, vk))
            if not cand:
                continue
            cand.sort()
            _, _, j, a_ij, k, a_ik = cand[0]
            # fold x_j's bounds onto x_k: x_j = d/a_ij - (a_ik/a_ij) x_k
            f_lo, f_hi = _fold_interval(lb[j], ub[j], d / a_ij,
                                        -a_ik / a_ij)
            k_lb_old, k_ub_old = lb[k], ub[k]
            new_lb = max(lb[k], f_lo)
            new_ub = min(ub[k], f_hi)
            if new_lb > new_ub + feas_tol * (1.0 + abs(new_lb)):
                return infeasible()
            rcx, rvx, ccx, cvx = snapshot(i, j)
            log.append(_ElimRecord(
                'doubleton', i, j, a_ij, d, c[j], rcx, rvx, ccx, cvx,
                partner=k, a_ik=a_ik, k_lb_old=k_lb_old, k_ub_old=k_ub_old))
            lb[k], ub[k] = new_lb, new_ub
            # substitute x_j out of every other row
            shift = c[j] / a_ij
            c[k] -= shift * a_ik
            const += shift * d
            for r in list(cols[j]):
                if r == i:
                    continue
                a_rj = cols[j][r]
                factor = a_rj / a_ij
                new_rk = rows[r].get(k, 0.0) - factor * a_ik
                if abs(new_rk) <= 1e-12 * max(abs(a_rj), abs(a_ik), 1.0):
                    rows[r].pop(k, None)
                    cols[k].pop(r, None)
                else:
                    rows[r][k] = new_rk
                    cols[k][r] = new_rk
                del rows[r][j]
                if np.isfinite(cl[r]):
                    cl[r] -= factor * d
                if np.isfinite(cu[r]):
                    cu[r] -= factor * d
            drop_pivot(i, j)
            changed = True
        if not changed:
            break

    if not log:
        return _SubstResult(PresolveStatus.UNCHANGED, qp,
                            np.arange(m), np.arange(n), nan)
    kept_rows = np.nonzero(row_alive)[0]
    kept_cols = np.nonzero(col_alive)[0]
    col_pos = {int(j): p for p, j in enumerate(kept_cols)}
    data, ri, ci = [], [], []
    for p, i in enumerate(kept_rows):
        for j, v in rows[i].items():
            ri.append(p)
            ci.append(col_pos[j])
            data.append(v)
    sub = sp.csr_matrix((data, (ri, ci)),
                        shape=(len(kept_rows), len(kept_cols)))
    reduced = QuadraticProgram(
        objective_vector=c[kept_cols],
        constraint_matrix=sub,
        constraint_lower=cl[kept_rows],
        constraint_upper=cu[kept_rows],
        variable_lower=lb[kept_cols],
        variable_upper=ub[kept_cols],
        objective_constant=const,
        name=qp.name,
    )
    return _SubstResult(PresolveStatus.REDUCED, reduced,
                        kept_rows, kept_cols, nan, log)


# ---------------------------------------------------------------------------
# The chain of reductions.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChainedPresolveResult:
    """Composition of presolve stages; same surface as PresolveResult."""
    status: PresolveStatus
    reduced: Optional[QuadraticProgram]
    kept_rows: np.ndarray     # original row ids kept
    kept_cols: np.ndarray     # original col ids kept
    fixed_values: np.ndarray  # constant cols only (nan for kept/substituted)
    stages: list = dataclasses.field(default_factory=list)
    stage_qps: list = dataclasses.field(default_factory=list)

    def postsolve(self, x_reduced: np.ndarray) -> np.ndarray:
        x = x_reduced
        for s in reversed(self.stages):
            x = s.postsolve(x)
        return x

    def postsolve_duals(self, qp: QuadraticProgram, x: np.ndarray,
                        y_reduced: np.ndarray, tol: float = 1e-7
                        ) -> Tuple[np.ndarray, np.ndarray]:
        del qp  # stage-input problems were captured at presolve time
        # forward-project the primal into every stage's input space
        xs = [x]
        for s in self.stages[:-1]:
            xs.append(xs[-1][s.kept_cols])
        y = y_reduced
        rc = np.zeros(0)
        for s, qpi, xi in zip(reversed(self.stages),
                              reversed(self.stage_qps), reversed(xs)):
            y, rc = s.postsolve_duals(qpi, xi, y, tol=tol)
        return y, rc


def presolve(qp: QuadraticProgram, max_rounds: int = 10,
             feas_tol: float = 1e-9, substitutions: bool = True):
    """Run basic + substitution passes to a fix point (reference
    MainLpPreprocessor rule chain, preprocessor.h:271)."""
    qp0 = qp.as_minimization()
    m0, n0 = qp0.num_constraints, qp0.num_variables
    first = _basic_pass(qp0, max_rounds, feas_tol)
    if first.status in (PresolveStatus.PRIMAL_INFEASIBLE,
                        PresolveStatus.DUAL_INFEASIBLE):
        return first
    stages = [first]
    stage_qps = [qp0]
    cur = first.reduced

    def bad(status: PresolveStatus) -> PresolveResult:
        return PresolveResult(status, None, np.arange(m0), np.arange(n0),
                              np.full(n0, np.nan))

    if substitutions:
        for _ in range(3):
            if cur.num_variables == 0 or not cur.is_lp():
                break
            sub = _subst_pass(cur, feas_tol)
            if sub.status in (PresolveStatus.PRIMAL_INFEASIBLE,
                              PresolveStatus.DUAL_INFEASIBLE):
                return bad(sub.status)
            if sub.status == PresolveStatus.UNCHANGED:
                break
            stages.append(sub)
            stage_qps.append(cur)
            cur = sub.reduced
            nxt = _basic_pass(cur, max_rounds, feas_tol)
            if nxt.status in (PresolveStatus.PRIMAL_INFEASIBLE,
                              PresolveStatus.DUAL_INFEASIBLE):
                return bad(nxt.status)
            if nxt.status != PresolveStatus.REDUCED:
                break
            stages.append(nxt)
            stage_qps.append(cur)
            cur = nxt.reduced
    if len(stages) == 1:
        return first
    # compose original-space index maps and constant-col values
    rows = np.arange(m0)
    col_ids = np.arange(n0)
    fixed = np.full(n0, np.nan)
    for s in stages:
        if isinstance(s, PresolveResult):
            was_fixed = ~np.isnan(s.fixed_values)
            fixed[col_ids[was_fixed]] = s.fixed_values[was_fixed]
        rows = rows[s.kept_rows]
        col_ids = col_ids[s.kept_cols]
    return ChainedPresolveResult(
        status=PresolveStatus.REDUCED, reduced=cur,
        kept_rows=rows, kept_cols=col_ids, fixed_values=fixed,
        stages=stages, stage_qps=stage_qps,
    )
