"""Revised primal + dual simplex with bounded variables (host).

Capability parity: ``ortools/glop`` scoped to the role glop plays in this
framework — the *exact* host-side LP oracle producing vertex solutions,
duals and reduced costs (the control-heavy simplex stays on the host by
design, SURVEY §2.15 last row; PDHG is the at-scale path).  Round 2 adds
the reference's three performance pillars:

- **product-form basis updates** standing in for Forrest-Tomlin
  (``glop/rank_one_update.h``): one LU factorization per
  ``refactorization_period`` pivots (reference default 64,
  ``glop/parameters.proto:224``) with eta-vector updates in between;
- **devex pricing** (``glop/primal_edge_norms.cc``): reference-framework
  devex weights, reduced costs computed vectorized (one BLAS matvec per
  iteration instead of a per-column Python loop);
- **dual simplex** (``glop/revised_simplex.cc:3058`` DualMinimize): used
  by ``RevisedSimplex.resolve`` to re-optimize after variable-bound
  changes from a dual-feasible basis — the warm-start pattern of
  branch-and-bound node re-solves.

Formulation: rows become equalities  A x - s = 0  with slack bounds
s_i in [l_i, u_i]; columns z = (x, s) carry all bounds.  Phase 1 drives
basic infeasibilities to zero with the composite (piecewise-linear)
objective; phase 2 optimizes c.  Bland's rule fallback against cycling.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.utils.status import MPSolverStatus

_AT_LOWER, _AT_UPPER, _FREE = 0, 1, 2
_REFACTOR_PERIOD = 64


@dataclasses.dataclass
class SimplexResult:
    status: MPSolverStatus
    primal_solution: np.ndarray
    dual_solution: np.ndarray
    reduced_costs: np.ndarray
    objective_value: float
    iterations: int


class _Factorization:
    """LU of a basis with product-form (eta) rank-one updates.

    B_{k+1} = B_k E_k,  E_k = I + (w - e_r) e_r^T  where w = B_k^{-1} a_in.
    Stands in for the reference's Forrest-Tomlin update
    (glop/rank_one_update.h).

    The base factorization is SPARSE (scipy splu, the analogue of the
    reference's Markowitz LU, glop/markowitz.h) when the basis is large
    and sparse — on structured MIP node LPs this is the difference
    between O(m^3) dense refactors and ~nnz work — and dense LAPACK
    otherwise.
    """

    def __init__(self, b_mat):
        if sp.issparse(b_mat):
            if not np.all(np.isfinite(b_mat.data)):
                raise ValueError("non-finite basis matrix")
            import warnings as _warnings

            with _warnings.catch_warnings():
                # scipy's splu WARNS (not raises) on an exactly singular
                # basis and then produces NaN solves; promote to an error
                # so callers repair the basis instead of silently
                # poisoning every reduced cost downstream.  (Depending on
                # the scipy version the category is MatrixRankWarning or
                # linalg's LinAlgWarning.)
                from scipy.linalg import LinAlgWarning as _LAW

                _warnings.simplefilter("error", spla.MatrixRankWarning)
                _warnings.simplefilter("error", _LAW)
                self._splu = spla.splu(sp.csc_matrix(b_mat),
                                       permc_spec="COLAMD")
            self.lu = None
        else:
            if not np.all(np.isfinite(b_mat)):
                raise ValueError("non-finite basis matrix")
            self.lu = sla.lu_factor(b_mat, check_finite=False)
            self._splu = None
            # lapack getrf does not raise on exact singularity either:
            # a zero U diagonal yields inf/NaN at the first solve
            diag = np.abs(np.diag(self.lu[0]))
            scale = max(1.0, diag.max() if diag.size else 1.0)
            if diag.size and diag.min() <= 1e-13 * scale:
                raise ValueError("singular basis matrix")
        self.etas: List[Tuple[int, np.ndarray]] = []
        # Accuracy probe: a NEAR-singular basis factorizes without any
        # warning yet solves inaccurately — the root cause of "OPTIMAL"
        # claims at wrong objectives once nearly-dependent cut rows enter
        # the LP.  One solve + one residual matvec per refactorization.
        m = b_mat.shape[0]
        if m:
            rng = np.random.default_rng(m)
            e = rng.standard_normal(m)
            z = self._base_solve(e, trans=False)
            res = (b_mat @ z) - e
            norm_e = float(np.linalg.norm(e))
            # LU is backward stable, so the residual stays small even for
            # terrible conditioning — also reject on solution blow-up
            # (cond estimate; basis entries are O(1) after scaling)
            if not np.all(np.isfinite(z)) or \
                    float(np.linalg.norm(res)) > 1e-7 * norm_e or \
                    float(np.linalg.norm(z)) > 1e9 * norm_e:
                raise ValueError("ill-conditioned basis matrix")

    def _base_solve(self, b: np.ndarray, trans: bool) -> np.ndarray:
        if self._splu is not None:
            return self._splu.solve(b, trans="T" if trans else "N")
        return sla.lu_solve(self.lu, b, trans=1 if trans else 0,
                            check_finite=False)

    def ftran(self, b: np.ndarray) -> np.ndarray:
        """Solve B x = b."""
        x = self._base_solve(b, trans=False)
        for r, w in self.etas:
            xr = x[r] / w[r]
            x = x - w * xr
            x[r] = xr
        return x

    def btran(self, c: np.ndarray) -> np.ndarray:
        """Solve B^T y = c."""
        z = np.array(c, dtype=np.float64)
        for r, w in reversed(self.etas):
            zr = z[r]
            z[r] = 0.0
            z[r] = (zr - w @ z) / w[r]
        return self._base_solve(z, trans=True)

    def update(self, r: int, w: np.ndarray) -> bool:
        """Record pivot (entering column's B^{-1} a at leaving row r).
        Returns False when the pivot is too small (needs refactorization).
        """
        if abs(w[r]) < 1e-9:
            return False
        self.etas.append((r, np.array(w, dtype=np.float64)))
        return True

    @property
    def num_updates(self) -> int:
        return len(self.etas)


class RevisedSimplex:
    """Stateful bounded-variable simplex: primal solve + dual re-solve."""

    def __init__(self, qp: QuadraticProgram):
        if not qp.is_lp():
            raise ValueError("simplex solves LPs only")
        self.qp = qp
        qpm = qp.as_minimization()
        self.sign = -1.0 if qp.maximize else 1.0
        self.m = m = qpm.num_constraints
        self.n = n = qpm.num_variables
        a = (sp.csr_matrix(qpm.constraint_matrix).toarray()
             if m else np.zeros((0, n)))
        self.tab = np.hstack([a, -np.eye(m)]) if m else np.zeros((0, n))
        self.lb = np.concatenate([qpm.variable_lower, qpm.constraint_lower])
        self.ub = np.concatenate([qpm.variable_upper, qpm.constraint_upper])
        self.cost = np.concatenate([qpm.objective_vector, np.zeros(m)])
        self.obj_const = qpm.objective_constant
        self.total = n + m
        self.basis = np.arange(n, n + m)
        self.in_basis = np.zeros(self.total, dtype=bool)
        self.in_basis[self.basis] = True
        self.nb_status = np.full(self.total, _AT_LOWER, dtype=np.int8)
        for j in range(self.total):
            if np.isfinite(self.lb[j]):
                self.nb_status[j] = _AT_LOWER
            elif np.isfinite(self.ub[j]):
                self.nb_status[j] = _AT_UPPER
            else:
                self.nb_status[j] = _FREE
        self.iters = 0
        self._fact: Optional[_Factorization] = None
        # incremental basic-value cache (recomputed at refactorizations)
        self._xb: Optional[np.ndarray] = None
        # sparse column view of [A | -I] for sparse basis refactorization
        # (worth it when the basis is big and A is sparse)
        nnz_a = int(sp.csr_matrix(qpm.constraint_matrix).nnz) if m else 0
        use_sparse = m >= 96 and nnz_a <= 0.25 * max(1, m * n)
        self.tab_sp = sp.csc_matrix(self.tab) if use_sparse else None

    # -- bounds (for warm restarts) --------------------------------------
    def set_objective(self, c: np.ndarray) -> None:
        """Change the structural objective in place (feasibility-pump
        distance re-solves).  The current basis stays primal feasible, so
        a warm ``primal_solve`` continues from it."""
        self.cost[: self.n] = np.asarray(c, dtype=np.float64)
        self._xb = self._xb  # basic values unaffected

    def set_variable_bounds(self, var_lb: np.ndarray, var_ub: np.ndarray
                            ) -> None:
        """Change structural variable bounds (B&B node bounds)."""
        self.lb[: self.n] = var_lb
        self.ub[: self.n] = var_ub
        self._xb = None
        # nonbasic variables must sit on a still-finite bound (vectorized)
        nb = ~self.in_basis[: self.n]
        st = self.nb_status[: self.n]
        lo_fin = np.isfinite(self.lb[: self.n])
        up_fin = np.isfinite(self.ub[: self.n])
        bad_lo = nb & (st == _AT_LOWER) & ~lo_fin
        st[bad_lo] = np.where(up_fin[bad_lo], _AT_UPPER, _FREE)
        bad_up = nb & (st == _AT_UPPER) & ~up_fin
        st[bad_up] = np.where(lo_fin[bad_up], _AT_LOWER, _FREE)

    # -- anti-cycling perturbations ----------------------------------------
    # Reference: glop shifts bounds / perturbs costs to break degenerate
    # cycling (GlopParameters relative_cost_perturbation + the bound-shift
    # logic of revised_simplex.cc) and removes the perturbation before
    # claiming optimality.  Here: primal degeneracy -> shift finite bounds
    # outward by tiny deterministic amounts (ratio steps become strictly
    # positive), then restore + dual-simplex cleanup; dual degeneracy ->
    # perturb costs in the dual-feasible direction, then restore +
    # primal-simplex cleanup.  Both restores are exact (saved copies).
    _MAX_PERTURB_ROUNDS = 3

    def _shift_bounds(self) -> None:
        if getattr(self, "_lb_orig", None) is not None:
            return
        self._lb_orig = self.lb.copy()
        self._ub_orig = self.ub.copy()
        rng = np.random.default_rng(self.total)
        u = 0.5 + rng.random(self.total)
        eps = 1e-7 * u
        lo_fin = np.isfinite(self.lb)
        up_fin = np.isfinite(self.ub)
        self.lb = np.where(lo_fin, self.lb - eps * (1.0 + np.abs(self.lb)),
                           self.lb)
        self.ub = np.where(up_fin, self.ub + eps * (1.0 + np.abs(self.ub)),
                           self.ub)
        self._xb = None

    def _restore_bounds(self) -> bool:
        """Returns True when bounds were shifted (and are now restored)."""
        if getattr(self, "_lb_orig", None) is None:
            return False
        self.lb = self._lb_orig
        self.ub = self._ub_orig
        self._lb_orig = self._ub_orig = None
        self._xb = None
        return True

    def _perturb_costs(self) -> None:
        if getattr(self, "_cost_orig", None) is not None:
            return
        self._cost_orig = self.cost.copy()
        rng = np.random.default_rng(self.total + 1)
        u = 0.5 + rng.random(self.total)
        eps = 1e-7 * u * (1.0 + np.abs(self.cost))
        # perturb in the dual-feasible direction for the CURRENT statuses:
        # d_j must stay >= 0 at lower bounds and <= 0 at upper bounds.
        nb = ~self.in_basis
        delta = np.zeros(self.total)
        delta[nb & (self.nb_status == _AT_LOWER)] = 1.0
        delta[nb & (self.nb_status == _AT_UPPER)] = -1.0
        self.cost = self.cost + eps * delta

    def _restore_costs(self) -> bool:
        if getattr(self, "_cost_orig", None) is None:
            return False
        self.cost = self._cost_orig
        self._cost_orig = None
        return True

    def _reset_to_slack_basis(self) -> bool:
        """Reset to the always-nonsingular all-slack basis (un-warm but
        sound); nonbasic statuses re-derived from finite bounds."""
        self.in_basis[:] = False
        self.basis = np.arange(self.n, self.n + self.m)
        self.in_basis[self.basis] = True
        for j in range(self.total):
            if self.in_basis[j]:
                continue
            if np.isfinite(self.lb[j]):
                self.nb_status[j] = _AT_LOWER
            elif np.isfinite(self.ub[j]):
                self.nb_status[j] = _AT_UPPER
            else:
                self.nb_status[j] = _FREE
        self._xb = None
        return self._refactorize()

    def _stall_restart(self) -> bool:
        """Escalation ladder for a no-progress stall: restart from the
        all-slack basis alternating the pricing rule (devex <-> Bland;
        each cures oscillations the other causes on composite phase-1
        objectives), adding shifted bounds from the second round.
        Returns False when the ladder is exhausted."""
        rounds = getattr(self, "_stall_rounds", 0)
        self._stall_rounds = rounds + 1
        if rounds == 0:
            self._force_bland = True
        elif rounds == 1:
            self._force_bland = False
            if getattr(self, "_lb_orig", None) is None:
                self._shift_bounds()
        elif rounds == 2:
            self._force_bland = True
        else:
            return False
        return self._reset_to_slack_basis()

    # -- linear algebra helpers -------------------------------------------
    def _refactorize(self) -> bool:
        try:
            if self.tab_sp is not None:
                self._fact = _Factorization(self.tab_sp[:, self.basis])
            else:
                self._fact = _Factorization(self.tab[:, self.basis])
            return True
        except Exception:
            if self.tab_sp is not None:
                # singular for splu but maybe rank-revealing for dense
                try:
                    self._fact = _Factorization(self.tab[:, self.basis])
                    return True
                except Exception:
                    pass
            return self._repair_singular_basis()

    def _repair_singular_basis(self) -> bool:
        """A (near-)singular basis — e.g. after appending nearly-parallel
        cut rows (reference: glop 'basis refactorization + repair'
        role).  Reset to the always-nonsingular all-slack basis and let
        phase 1 re-enter the structural columns; sound, just un-warm."""
        if getattr(self, "_repairing", False):
            return False
        self._repairs = getattr(self, "_repairs", 0) + 1
        if self._repairs > 8:
            return False  # persistent degeneracy: report ABNORMAL
        self._repairing = True
        try:
            self.in_basis[:] = False
            self.basis = np.arange(self.n, self.n + self.m)
            self.in_basis[self.basis] = True
            for j in range(self.total):
                if self.in_basis[j]:
                    continue
                if np.isfinite(self.lb[j]):
                    self.nb_status[j] = _AT_LOWER
                elif np.isfinite(self.ub[j]):
                    self.nb_status[j] = _AT_UPPER
                else:
                    self.nb_status[j] = _FREE
            self._xb = None
            # deterministic re-pricing walks straight back into the same
            # singular basis; Bland's rule breaks the cycle
            self._force_bland = True
            return self._refactorize()
        finally:
            self._repairing = False

    def _certify_optimal(self, tol: float = 1e-6) -> bool:
        """Independent check of an OPTIMAL claim: fresh factorization,
        primal feasibility of the basic values, and the reduced-cost sign
        conditions — a warm dual solve's 'primal feasible again' claim is
        only as good as its (possibly ill-conditioned) reduced costs."""
        if not self._refactorize():
            return False
        self._xb = xb = self._compute_xb()
        if not np.all(np.isfinite(xb)):
            return False
        lbb, ubb = self.lb[self.basis], self.ub[self.basis]
        scale = 1.0 + float(np.abs(xb).max(initial=0.0))
        below = np.where(np.isfinite(lbb), lbb - xb, -np.inf)
        above = np.where(np.isfinite(ubb), xb - ubb, -np.inf)
        if max(float(below.max(initial=-np.inf)),
               float(above.max(initial=-np.inf))) > tol * scale:
            return False
        y = self._fact.btran(self.cost[self.basis])
        d = self.cost - y @ self.tab
        if not np.all(np.isfinite(d)):
            return False
        cscale = 1.0 + float(np.abs(self.cost).max(initial=0.0))
        nb = ~self.in_basis
        bad = ((nb & (self.nb_status == _AT_LOWER) & (d < -tol * cscale))
               | (nb & (self.nb_status == _AT_UPPER) & (d > tol * cscale))
               | (nb & (self.nb_status == _FREE)
                  & (np.abs(d) > tol * cscale)))
        return not bool(bad.any())

    def _nb_values(self) -> np.ndarray:
        v = np.where(self.nb_status == _AT_LOWER, self.lb,
                     np.where(self.nb_status == _AT_UPPER, self.ub, 0.0))
        v = np.where(np.isfinite(v), v, 0.0)
        v[self.basis] = 0.0
        return v

    def _compute_xb(self) -> np.ndarray:
        v = self._nb_values()
        rhs = -(self.tab @ v)
        return self._fact.ftran(rhs)

    def _pivot(self, leaving_pos: int, entering: int, w: np.ndarray,
               leaving_to_upper: bool) -> bool:
        out = self.basis[leaving_pos]
        self.in_basis[out] = False
        self.nb_status[out] = _AT_UPPER if leaving_to_upper else _AT_LOWER
        self.basis[leaving_pos] = entering
        self.in_basis[entering] = True
        if (self._fact.num_updates >= _REFACTOR_PERIOD
                or not self._fact.update(leaving_pos, w)):
            return self._refactorize()
        return True

    # -- primal simplex ----------------------------------------------------
    def primal_solve(self, max_iterations: int = 50_000, tol: float = 1e-9,
                     deadline: float = math.inf) -> MPSolverStatus:
        """Two-phase primal simplex from the current basis."""
        try:
            return self._primal_loop(max_iterations, tol, deadline)
        finally:
            # safety net: no exit path may leave shifted bounds behind
            # (the OPTIMAL path restores + cleans up explicitly first)
            self._restore_bounds()

    def _primal_loop(self, max_iterations: int, tol: float,
                     deadline: float) -> MPSolverStatus:
        if self.m == 0:
            return MPSolverStatus.OPTIMAL
        if not self._refactorize():
            return MPSolverStatus.ABNORMAL
        self._xb = None
        devex = np.ones(self.total)
        degenerate_steps = 0
        for phase in (1, 2):
            # anti-stall: pricing can LOOP with real-sized steps on the
            # composite phase-1 objective (it changes every iteration, so
            # neither devex progress arguments nor Bland's anti-cycling
            # guarantee apply — both observed oscillating on different
            # LPs).  When the best phase measure stops improving over a
            # long window, restart from the all-slack basis with the
            # OTHER pricing rule (devex <-> Bland), optionally with
            # shifted bounds — the ladder in _stall_restart.  Phase 2 has
            # a fixed objective, where Bland alone is a finite fallback.
            best_measure = math.inf
            stall_steps = 0
            checkpoint = math.inf
            check_iters = 0
            while True:
                if self.iters >= max_iterations:
                    return MPSolverStatus.ABNORMAL
                if (self.iters & 127) == 0 and math.isfinite(deadline) \
                        and time.perf_counter() > deadline:
                    return MPSolverStatus.NOT_SOLVED
                if self._xb is None:
                    self._xb = self._compute_xb()
                xb = self._xb
                lbb, ubb = self.lb[self.basis], self.ub[self.basis]
                if phase == 1:
                    viol_lo = np.where(np.isfinite(lbb), lbb - xb, 0.0)
                    viol_hi = np.where(np.isfinite(ubb), xb - ubb, 0.0)
                    infeas = (np.maximum(viol_lo, 0.0).sum()
                              + np.maximum(viol_hi, 0.0).sum())
                    if infeas <= tol * (1.0 + np.abs(xb).sum()):
                        break
                    measure = float(infeas)
                    cb = np.where(viol_lo > tol, -1.0,
                                  np.where(viol_hi > tol, 1.0, 0.0))
                else:
                    cb = self.cost[self.basis]
                    measure = float(cb @ xb)
                if not math.isfinite(best_measure) or \
                        measure < best_measure - 1e-10 * (
                            1.0 + abs(best_measure)):
                    best_measure = measure
                    stall_steps = 0
                else:
                    stall_steps += 1
                check_iters += 1
                if check_iters >= 2000:
                    check_iters = 0
                    if math.isfinite(checkpoint) and \
                            best_measure >= checkpoint - 1e-9 * (
                                1.0 + abs(checkpoint)):
                        # no net progress over a whole window
                        if not self._stall_restart():
                            return MPSolverStatus.ABNORMAL
                        self._xb = None
                        best_measure = math.inf
                        checkpoint = math.inf
                        stall_steps = degenerate_steps = 0
                        devex[:] = 1.0
                        continue
                    checkpoint = best_measure

                y = self._fact.btran(cb)
                # vectorized reduced costs over ALL columns
                d = (self.cost if phase == 2 else 0.0) - y @ self.tab
                if not np.all(np.isfinite(d)):
                    # near-singular basis slipped past the factorization
                    # probe: repair instead of iterating on NaN
                    if self._repair_singular_basis():
                        self._xb = None
                        continue
                    return MPSolverStatus.ABNORMAL
                use_bland = (degenerate_steps > 200
                             or (phase == 2 and stall_steps > 300)
                             or getattr(self, "_force_bland", False))
                cand_dir = np.zeros(self.total)
                nb = ~self.in_basis
                at_lo = nb & (self.nb_status == _AT_LOWER) & (d < -tol)
                at_up = nb & (self.nb_status == _AT_UPPER) & (d > tol)
                free = nb & (self.nb_status == _FREE) & (np.abs(d) > tol)
                cand_dir[at_lo] = 1.0
                cand_dir[at_up] = -1.0
                cand_dir[free] = -np.sign(d[free])
                cand = np.nonzero(cand_dir != 0.0)[0]
                if len(cand) == 0:
                    # claim INFEASIBLE/OPTIMAL only from a fresh, finite
                    # factorization (stale etas / NaN xb empty the set)
                    if (self._fact.num_updates > 0
                            or not np.all(np.isfinite(xb))):
                        if not self._refactorize():
                            return MPSolverStatus.ABNORMAL
                        self._xb = None
                        continue
                    if phase == 1:
                        # shifted bounds RELAX the problem: relaxed
                        # infeasible => original infeasible (sound)
                        self._restore_bounds()
                        return MPSolverStatus.INFEASIBLE
                    if self._restore_bounds():
                        # optimal for the shifted bounds only; the basis
                        # stays dual feasible under bound restoration, so
                        # dual simplex is the exact cleanup
                        return self.dual_solve(
                            max_iterations=max_iterations,
                            deadline=deadline)
                    return (MPSolverStatus.OPTIMAL
                            if self._certify_optimal()
                            else MPSolverStatus.ABNORMAL)
                if use_bland:
                    entering = int(cand[0])
                else:
                    score = d[cand] ** 2 / devex[cand]
                    entering = int(cand[int(np.argmax(score))])
                direction = cand_dir[entering]

                w = self._fact.ftran(self.tab[:, entering]) * direction
                flip_t = math.inf
                if np.isfinite(self.ub[entering] - self.lb[entering]):
                    flip_t = self.ub[entering] - self.lb[entering]
                # vectorized bounded-variable ratio test
                lo_fin = np.isfinite(lbb)
                up_fin = np.isfinite(ubb)
                tgt = np.full(self.m, np.nan)
                to_up = np.zeros(self.m, dtype=bool)
                pos = w > 1e-11
                neg = w < -1e-11
                if phase == 1:
                    m1 = pos & up_fin & (xb > ubb + tol)
                    tgt[m1] = ubb[m1]
                    to_up[m1] = True
                    m3 = neg & lo_fin & (xb < lbb - tol)
                    tgt[m3] = lbb[m3]
                m2 = pos & np.isnan(tgt) & lo_fin
                tgt[m2] = lbb[m2]
                m4 = neg & np.isnan(tgt) & up_fin
                tgt[m4] = ubb[m4]
                to_up[m4] = True
                valid = ~np.isnan(tgt)
                t_max = math.inf
                t_raw = 0.0  # raw ratio of the selected row (may be < 0)
                leaving_pos = -1
                leaving_to_upper = False
                if np.any(valid):
                    with np.errstate(invalid="ignore", divide="ignore"):
                        t_all_raw = np.where(valid, (xb - tgt) / w, np.inf)
                    t_all = np.maximum(t_all_raw, 0.0)
                    t_min = float(np.min(t_all))
                    if t_min < flip_t - 1e-12:
                        ties = np.nonzero(t_all <= t_min + 1e-12)[0]
                        if use_bland:
                            i_sel = int(ties[int(np.argmin(
                                self.basis[ties]))])
                        else:
                            # stability: largest |pivot| among ties
                            i_sel = int(ties[int(np.argmax(
                                np.abs(w[ties])))])
                        t_max = float(t_all[i_sel])
                        t_raw = float(t_all_raw[i_sel])
                        leaving_pos = i_sel
                        leaving_to_upper = bool(to_up[i_sel])
                if leaving_pos < 0 and math.isfinite(flip_t):
                    t_max = flip_t
                if math.isinf(t_max):
                    if phase == 1:
                        return MPSolverStatus.ABNORMAL
                    return MPSolverStatus.UNBOUNDED
                self.iters += 1
                degenerate_steps = (degenerate_steps + 1 if t_max <= 1e-12
                                    else 0)
                if degenerate_steps > 300:
                    rounds = getattr(self, "_perturb_rounds", 0)
                    if (rounds < self._MAX_PERTURB_ROUNDS
                            and getattr(self, "_lb_orig", None) is None):
                        self._perturb_rounds = rounds + 1
                        self._shift_bounds()
                        degenerate_steps = 0
                        continue
                if degenerate_steps > 3000:
                    # cycling despite Bland entering + perturbation:
                    # give up cleanly — callers fall back to another
                    # LP engine
                    self._restore_bounds()
                    return MPSolverStatus.ABNORMAL
                if leaving_pos < 0:
                    self.nb_status[entering] = (
                        _AT_UPPER if self.nb_status[entering] == _AT_LOWER
                        else _AT_LOWER)
                    self._xb = xb - t_max * w
                else:
                    # devex weight update (reference primal_edge_norms.cc):
                    # gamma_j' = max(gamma_j, (alpha_j/alpha_q)^2 gamma_q)
                    # approximated at the reference framework reset scale.
                    wq = w[leaving_pos] * direction
                    if abs(wq) > 1e-11:
                        gq = max(devex[entering], 1.0)
                        devex[self.basis[leaving_pos]] = max(
                            1.0, gq / (wq * wq))
                    # incremental basic values: step by the RAW ratio (a
                    # negative raw step snaps a beyond-bound leaving
                    # variable to its bound, exactly like a recompute);
                    # the entering variable lands at nb_value + dir*t.
                    nbv_e = (self.lb[entering]
                             if self.nb_status[entering] == _AT_LOWER
                             else self.ub[entering]
                             if self.nb_status[entering] == _AT_UPPER
                             else 0.0)
                    xb_new = xb - t_raw * w
                    xb_new[leaving_pos] = nbv_e + direction * t_raw
                    self._xb = xb_new
                    if not self._pivot(leaving_pos, entering, w * direction,
                                       leaving_to_upper):
                        return MPSolverStatus.ABNORMAL
                    if self._fact.num_updates == 0:
                        self._xb = None  # refactorized: refresh values
                    if np.max(devex) > 1e8:
                        devex[:] = 1.0
        return MPSolverStatus.OPTIMAL

    # -- dual simplex --------------------------------------------------------
    def dual_solve(self, max_iterations: int = 50_000, tol: float = 1e-9,
                   deadline: float = math.inf) -> MPSolverStatus:
        """Dual simplex from the current (dual-feasible) basis.

        Reference: glop/revised_simplex.cc:3058 DualMinimize.  Requires the
        current reduced costs to be sign-consistent with nb_status (true
        after a primal solve and unchanged costs); primal infeasibilities
        from changed BOUNDS are driven out.  Falls back to ABNORMAL when
        dual feasibility is violated (caller should primal-solve instead).
        """
        try:
            return self._dual_loop(max_iterations, tol, deadline)
        finally:
            self._restore_costs()

    def _dual_loop(self, max_iterations: int, tol: float,
                   deadline: float) -> MPSolverStatus:
        if self.m == 0:
            return MPSolverStatus.OPTIMAL
        if not self._refactorize():
            return MPSolverStatus.ABNORMAL
        self._xb = None
        d: Optional[np.ndarray] = None  # incremental reduced costs
        # Dual steepest-edge row weights (reference
        # glop/dual_edge_norms.{h,cc}; Forrest-Goldfarb update).  Partial
        # initialization to ones — any positive weights give a correct
        # algorithm; exactness improves as pivots update them.
        dse = np.ones(self.m)
        degenerate_steps = 0
        for it in range(max_iterations):
            if (it & 127) == 0 and math.isfinite(deadline) \
                    and time.perf_counter() > deadline:
                return MPSolverStatus.NOT_SOLVED
            if self._xb is None:
                self._xb = self._compute_xb()
                d = None
            xb = self._xb
            if d is None:
                y = self._fact.btran(self.cost[self.basis])
                d = self.cost - y @ self.tab
                if not (np.all(np.isfinite(d))
                        and np.all(np.isfinite(xb))):
                    # near-singular basis: repair, else give up cleanly
                    if self._repair_singular_basis():
                        self._xb = None
                        d = None
                        continue
                    return MPSolverStatus.ABNORMAL
            lbb, ubb = self.lb[self.basis], self.ub[self.basis]
            below = np.where(np.isfinite(lbb), lbb - xb, -math.inf)
            above = np.where(np.isfinite(ubb), xb - ubb, -math.inf)
            viol = np.maximum(below, above)
            feas = viol <= tol * (1.0 + np.abs(xb))
            if feas.all():
                if self._restore_costs():
                    # optimal for the PERTURBED costs only; bounds were
                    # never touched, so the basis is primal feasible for
                    # the true problem — primal simplex is the exact
                    # cleanup for the (slightly) broken dual feasibility
                    return self.primal_solve(max_iterations=max_iterations,
                                             deadline=deadline)
                # primal feasible again — certify before claiming
                if self._certify_optimal():
                    return MPSolverStatus.OPTIMAL
                return MPSolverStatus.ABNORMAL  # caller re-solves primal
            # steepest-edge choice: maximize viol^2 / ||rho_r||^2
            score = np.where(feas, -math.inf,
                             viol * np.abs(viol) / np.maximum(dse, 1e-12))
            r = int(np.argmax(score))
            leaving_above = above[r] >= below[r]
            # row r of B^{-1} N:  rho = B^{-T} e_r;  alpha_j = rho . a_j
            e_r = np.zeros(self.m)
            e_r[r] = 1.0
            rho = self._fact.btran(e_r)
            alpha = rho @ self.tab  # all columns
            # leaving variable moves DOWN to its upper bound if above,
            # UP to its lower bound if below; entering must move opposingly.
            nb = ~self.in_basis
            # direction the entering variable's increase moves x_B[r]:
            # x_B[r] changes by -alpha_j * t_j (t = entering move, signed
            # by its own direction of feasibility).
            # For leaving above (x_r must decrease): need alpha_j * dir_j > 0
            # For leaving below (x_r must increase): need alpha_j * dir_j < 0
            dirs = np.zeros(self.total)
            dirs[nb & (self.nb_status == _AT_LOWER)] = 1.0
            dirs[nb & (self.nb_status == _AT_UPPER)] = -1.0
            dirs[nb & (self.nb_status == _FREE)] = 0.0  # handled below
            move = alpha * dirs
            if leaving_above:
                cand_mask = nb & (move > 1e-11)
            else:
                cand_mask = nb & (move < -1e-11)
            # free nonbasics can move either way
            free_mask = nb & (self.nb_status == _FREE) & (
                np.abs(alpha) > 1e-11)
            cand_mask |= free_mask
            cand = np.nonzero(cand_mask)[0]
            if len(cand) == 0:
                # dual unbounded = primal infeasible — but only claim it
                # from a FRESH factorization with finite state (stale eta
                # chains / NaN silently empty the candidate set)
                if (self._fact.num_updates > 0
                        or not (np.all(np.isfinite(alpha))
                                and np.all(np.isfinite(xb))
                                and np.all(np.isfinite(d)))):
                    if not self._refactorize():
                        return MPSolverStatus.ABNORMAL
                    self._xb = None
                    d = None
                    continue
                return MPSolverStatus.INFEASIBLE
            # dual ratio test: minimize |d_j / alpha_j| over candidates
            ratios = np.abs(d[cand]) / np.maximum(np.abs(alpha[cand]), 1e-30)
            entering = int(cand[int(np.argmin(ratios))])
            w = self._fact.ftran(self.tab[:, entering])
            if abs(w[r]) < 1e-9:
                if not self._refactorize():
                    return MPSolverStatus.ABNORMAL
                self._xb = None
                w = self._fact.ftran(self.tab[:, entering])
                if abs(w[r]) < 1e-9:
                    return MPSolverStatus.ABNORMAL
                xb = self._xb = self._compute_xb()
                d = None
            self.iters += 1
            # incremental updates: entering moves by t so that x_B[r] hits
            # its violated bound; reduced costs shift along the alpha row.
            tgt = ubb[r] if leaving_above else lbb[r]
            t = (xb[r] - tgt) / w[r]
            # dual degeneracy: the entering column's reduced cost is ~0,
            # so the dual objective does not move — cost perturbation
            # breaks the tie set exactly like glop's
            # relative_cost_perturbation
            dual_step = abs(d[entering]) if d is not None else 1.0
            degenerate_steps = (degenerate_steps + 1 if dual_step <= 1e-12
                                else 0)
            if degenerate_steps > 300:
                rounds = getattr(self, "_perturb_rounds", 0)
                if (rounds < self._MAX_PERTURB_ROUNDS
                        and getattr(self, "_cost_orig", None) is None):
                    self._perturb_rounds = rounds + 1
                    self._perturb_costs()
                    d = None
                    degenerate_steps = 0
            if degenerate_steps > 3000:
                return MPSolverStatus.ABNORMAL
            nbv_e = (self.lb[entering]
                     if self.nb_status[entering] == _AT_LOWER
                     else self.ub[entering]
                     if self.nb_status[entering] == _AT_UPPER
                     else 0.0)
            xb_new = xb - t * w
            xb_new[r] = nbv_e + t
            self._xb = xb_new
            if d is not None:
                ratio = d[entering] / alpha[entering]
                d = d - ratio * alpha
                d[entering] = 0.0
            # Forrest-Goldfarb DSE weight update: with w = B^{-1}a_q and
            # tau = B^{-1} rho_r,
            #   beta_r' = beta_r / w_r^2
            #   beta_i' = beta_i - 2 (w_i/w_r) tau_i + (w_i/w_r)^2 beta_r
            beta_r = max(float(rho @ rho), 1e-12)  # exact ||rho_r||^2
            tau = self._fact.ftran(rho)
            ratio_w = w / w[r]
            dse = dse - 2.0 * ratio_w * tau + (ratio_w * ratio_w) * beta_r
            dse[r] = beta_r / (w[r] * w[r])
            np.maximum(dse, 1e-10, out=dse)
            if not self._pivot(r, entering, w, leaving_to_upper=leaving_above):
                return MPSolverStatus.ABNORMAL
            if self._fact.num_updates == 0:
                self._xb = None  # refactorized: refresh values + costs
                d = None
                dse[:] = 1.0
        return MPSolverStatus.ABNORMAL

    def resolve(self, var_lb: np.ndarray, var_ub: np.ndarray,
                max_iterations: int = 50_000,
                deadline: float = math.inf) -> MPSolverStatus:
        """Warm re-solve after bound changes: dual simplex first (the
        basis stays dual feasible under bound changes), primal fallback."""
        self.set_variable_bounds(var_lb, var_ub)
        st = self.dual_solve(max_iterations=max_iterations,
                             deadline=deadline)
        if st in (MPSolverStatus.OPTIMAL, MPSolverStatus.INFEASIBLE,
                  MPSolverStatus.NOT_SOLVED):
            return st
        return self.primal_solve(max_iterations=max_iterations,
                                 deadline=deadline)

    # -- solution assembly --------------------------------------------------
    def result(self, status: MPSolverStatus) -> SimplexResult:
        n, m = self.n, self.m
        if status not in (MPSolverStatus.OPTIMAL,):
            nanv = math.nan
            if status == MPSolverStatus.UNBOUNDED:
                nanv = -math.inf if self.sign > 0 else math.inf
            return SimplexResult(status, np.zeros(n), np.zeros(m),
                                 np.zeros(n), nanv, self.iters)
        if m == 0:
            x = np.where(self.cost >= 0, self.lb, self.ub)
            x = np.where(np.isfinite(x), x, 0.0)
            if np.any(~np.isfinite(
                    np.where(self.cost >= 0, self.lb, self.ub))
                    & (self.cost != 0)):
                return SimplexResult(MPSolverStatus.UNBOUNDED, np.zeros(n),
                                     np.zeros(0), self.cost[:n].copy(),
                                     -math.inf if self.sign > 0 else math.inf,
                                     0)
            obj = self.sign * (self.obj_const + self.cost @ x)
            return SimplexResult(MPSolverStatus.OPTIMAL, x[:n], np.zeros(0),
                                 self.sign * self.cost[:n], obj, 0)
        if self._fact is None:
            self._refactorize()
        xb = self._compute_xb()
        z = self._nb_values()
        z[self.basis] = xb
        y = self._fact.btran(self.cost[self.basis])
        rc_struct = self.cost[:n] - (y @ self.tab[:, :n] if m else 0.0)
        x = z[:n]
        obj = self.sign * (self.obj_const + self.cost[:n] @ x)
        return SimplexResult(
            status=MPSolverStatus.OPTIMAL,
            primal_solution=x,
            dual_solution=self.sign * y,
            reduced_costs=self.sign * rc_struct,
            objective_value=obj,
            iterations=self.iters,
        )


def _pow2_scaling(a: sp.csr_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """Row/column equilibration factors restricted to powers of two
    (reference glop ScalingPreprocessor + lp_data/matrix_scaler with
    GlopParameters scaling; powers of two make every transform exact in
    floating point, so postsolve introduces NO roundoff)."""
    m, n = a.shape
    r = np.ones(m)
    c = np.ones(n)
    abs_a = sp.csr_matrix((np.abs(a.data), a.indices, a.indptr), shape=a.shape)
    for _ in range(2):
        row_max = np.asarray(abs_a.max(axis=1).todense()).ravel()
        rr = np.where(row_max > 0, 2.0 ** np.round(-np.log2(
            np.where(row_max > 0, row_max, 1.0))), 1.0)
        abs_a = sp.diags(rr) @ abs_a
        r *= rr
        col_max = np.asarray(abs_a.max(axis=0).todense()).ravel()
        cc = np.where(col_max > 0, 2.0 ** np.round(-np.log2(
            np.where(col_max > 0, col_max, 1.0))), 1.0)
        abs_a = abs_a @ sp.diags(cc)
        c *= cc
    return r, c


def solve(qp: QuadraticProgram, max_iterations: int = 50_000,
          tol: float = 1e-9, scaling: bool = True,
          dualize: bool = False) -> SimplexResult:
    """One-shot primal solve (the original module API).

    With ``scaling`` the problem is equilibrated by powers of two before
    the simplex and the solution mapped back exactly: x = C x',
    y = R y', reduced costs d = C^{-1} d' (all multiplications by exact
    powers of two)."""
    errs = qp.validate()
    if errs:
        return SimplexResult(MPSolverStatus.MODEL_INVALID,
                             np.zeros(qp.num_variables),
                             np.zeros(qp.num_constraints),
                             np.zeros(qp.num_variables), math.nan, 0)
    # Dualizer (reference glop/preprocessor.h Dualizer): solve through
    # the explicit dual.  Opt-in: with the current full-pricing simplex
    # the dual's 2m+2n columns cost more per pivot than the primal's
    # m rows save (measured 8x slower on skewed random LPs), so callers
    # choose it explicitly where their structure warrants it.
    if (dualize and not qp.maximize and qp.is_lp()
            and qp.num_constraints >= max(4 * qp.num_variables, 64)):
        res_v = solve_dualized(qp, max_iterations=max_iterations, tol=tol)
        if res_v is not None:
            return res_v
    r = c = None
    if scaling and qp.num_constraints and qp.is_lp():
        a = sp.csr_matrix(qp.constraint_matrix)
        if a.nnz:
            r, c = _pow2_scaling(a)
            if np.all(r == 1.0) and np.all(c == 1.0):
                r = c = None
            else:
                import dataclasses as _dc

                qp = _dc.replace(
                    qp,
                    constraint_matrix=sp.diags(r) @ a @ sp.diags(c),
                    objective_vector=np.asarray(qp.objective_vector) * c,
                    constraint_lower=np.asarray(qp.constraint_lower) * r,
                    constraint_upper=np.asarray(qp.constraint_upper) * r,
                    variable_lower=np.asarray(qp.variable_lower) / c,
                    variable_upper=np.asarray(qp.variable_upper) / c,
                )
    sx = RevisedSimplex(qp)
    if sx.m == 0:
        res = sx.result(MPSolverStatus.OPTIMAL)
    else:
        status = sx.primal_solve(max_iterations=max_iterations, tol=tol)
        res = sx.result(status)
    if r is not None and res.status == MPSolverStatus.OPTIMAL:
        # exact unscaling (powers of two): x = C x', y = R y', d = d'/C
        res = dataclasses.replace(
            res,
            primal_solution=res.primal_solution * c,
            dual_solution=res.dual_solution * r,
            reduced_costs=res.reduced_costs / c,
        )
    return res


def _dualize(qp: QuadraticProgram):
    """Build the explicit dual of  min c'x s.t. l<=Ax<=u, p<=x<=q  as a
    minimization LP over nonnegative (lambda, mu, s, t):

        min  -l'lambda + u'mu - p's + q't
        s.t. A'(lambda - mu) + (s - t) = c

    entries with an infinite bound drop their dual variable.  Returns
    (dual_qp, mapping) where mapping recovers the PRIMAL solution from
    the dual solve:  x = -y_D (duals of the equality rows),
    y = lambda - mu,  d = s - t  (reference glop/preprocessor.h
    DualizerPreprocessor role)."""
    a = sp.csc_matrix(qp.constraint_matrix)
    m, n = a.shape
    l = np.asarray(qp.constraint_lower, dtype=np.float64)
    u = np.asarray(qp.constraint_upper, dtype=np.float64)
    p = np.asarray(qp.variable_lower, dtype=np.float64)
    q = np.asarray(qp.variable_upper, dtype=np.float64)
    c = np.asarray(qp.objective_vector, dtype=np.float64)
    at = sp.csr_matrix(a.T)  # [n, m]

    cols = []
    costs = []
    kinds = []  # (kind, index): "lam" i | "mu" i | "s" j | "t" j
    lam_idx = np.nonzero(np.isfinite(l))[0]
    mu_idx = np.nonzero(np.isfinite(u))[0]
    s_idx = np.nonzero(np.isfinite(p))[0]
    t_idx = np.nonzero(np.isfinite(q))[0]
    blocks = []
    if len(lam_idx):
        blocks.append(at[:, lam_idx])
        costs.append(-l[lam_idx])
        kinds += [("lam", int(i)) for i in lam_idx]
    if len(mu_idx):
        blocks.append(-at[:, mu_idx])
        costs.append(u[mu_idx])
        kinds += [("mu", int(i)) for i in mu_idx]
    eye = sp.identity(n, format="csc")
    if len(s_idx):
        blocks.append(eye[:, s_idx])
        costs.append(-p[s_idx])
        kinds += [("s", int(j)) for j in s_idx]
    if len(t_idx):
        blocks.append(-eye[:, t_idx])
        costs.append(q[t_idx])
        kinds += [("t", int(j)) for j in t_idx]
    if not blocks:
        return None
    a_d = sp.hstack(blocks, format="csr")
    c_d = np.concatenate(costs)
    nd = a_d.shape[1]
    dual_qp = QuadraticProgram(
        objective_vector=c_d,
        constraint_matrix=a_d,
        constraint_lower=c,
        constraint_upper=c,
        variable_lower=np.zeros(nd),
        variable_upper=np.full(nd, np.inf),
    )
    return dual_qp, kinds, (m, n)


def solve_dualized(qp: QuadraticProgram, max_iterations: int = 50_000,
                   tol: float = 1e-9) -> Optional[SimplexResult]:
    """Solve ``qp`` through its explicit dual (profitable when m >> n:
    the dual has only n rows).  Returns None unless the dual solves to
    OPTIMAL (callers fall back to the primal path)."""
    if qp.maximize or not qp.is_lp():
        return None
    built = _dualize(qp)
    if built is None:
        return None
    dual_qp, kinds, (m, n) = built
    res_d = solve(dual_qp, max_iterations=max_iterations, tol=tol,
                  scaling=True, dualize=False)
    if res_d.status != MPSolverStatus.OPTIMAL:
        return None
    x = -res_d.dual_solution  # duals of the equality rows
    z = res_d.primal_solution
    y = np.zeros(m)
    d = np.zeros(n)
    for val, (kind, idx) in zip(z, kinds):
        if kind == "lam":
            y[idx] += val
        elif kind == "mu":
            y[idx] -= val
        elif kind == "s":
            d[idx] += val
        else:
            d[idx] -= val
    obj = float(np.asarray(qp.objective_vector) @ x) + qp.objective_constant
    return SimplexResult(MPSolverStatus.OPTIMAL, x, y, d, obj,
                         res_d.iterations)
