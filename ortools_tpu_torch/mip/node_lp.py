"""Node-LP backends for the batched branch-and-bound (port of
``ortools_tpu/mip/node_lp.py``).

Capability parity: the reference solves B&B/CP node relaxations with a
warm-started dual simplex embedded in the search
(``ortools/sat/linear_programming_constraint.h:442`` holds a
``glop::RevisedSimplex``; bound-change re-solves enter at
``glop/revised_simplex.cc:3058`` DualMinimize).  The MIP tree gets the same
two-speed design:

- ``PdhgNodeBackend`` — batched PDHG (``pdlp/batched.py``): B node LPs
  advance together, and every product is a batched SpMM on the card.  The
  scale path.
- ``SimplexNodeBackend`` — one persistent host ``RevisedSimplex`` (the
  port's copy of ``glop/simplex.py``, with the native core of
  ``_native/smalllp.cc``) re-solved per node with the dual simplex.  An LP
  the simplex cannot finish goes to ``pdlp.solve`` on the B&B's device, in
  the B&B's LP dtype.

``choose_backend`` picks per model size; ``MipParams.node_lp`` overrides.
The B&B's ``device`` reaches both backends.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.pdlp.batched import BatchSolver
from ortools_tpu_torch.pdlp.params import PdhgParams
from ortools_tpu_torch.utils.status import MPSolverStatus


@dataclasses.dataclass
class NodeLpResult:
    """Per-node LP results (leading axis = node). Mirrors the
    pdlp.batched.BatchSolveResult fields the B&B consumes."""
    primal_solution: np.ndarray
    dual_solution: np.ndarray
    # Valid lower bound on each node LP (exact optimum for the simplex
    # backend; exact Lagrangian dual value for PDHG) — safe to prune on.
    dual_bound: np.ndarray
    primal_infeasible: np.ndarray  # bool — certified infeasible
    optimal: np.ndarray  # bool — LP solved to optimality
    skipped: np.ndarray  # bool — not attempted (deadline); re-enqueue as-is


class PdhgNodeBackend:
    """Batched-PDHG node LPs at one static batch shape.

    The backend keeps one ``BatchSolver`` across its calls: the scaled
    problem, σ_max, and the majors with their buffers and captured CUDA
    graphs, which hold for a fixed batch size B.  A short batch is
    therefore padded by repeating its first node, so that every call runs
    on the same graphs and a second call captures nothing.  The
    branch-and-bound raises ``iteration_limit`` for a batch that holds a
    retried node; only the host loop reads it, so a call whose
    ``lp_params`` differ from the solver's in ``iteration_limit`` alone
    keeps the solver and passes the limit to it.  A call with other
    ``lp_params`` builds a new solver.  ``device`` and ``v0`` (the
    power-iteration start) are those of ``solve_batch``."""

    name = "pdhg"

    def __init__(self, qp_min: QuadraticProgram, lp_params: PdhgParams,
                 batch_size: int, device="cuda", v0=None):
        self.qp = qp_min
        self.lp_params = lp_params
        self.batch_size = batch_size
        self.device = device
        self.v0 = v0
        self._solver: Optional[BatchSolver] = None

    def _solver_for(self, params: PdhgParams) -> BatchSolver:
        """The kept solver, unless ``params`` differ from its params in
        more than ``iteration_limit``."""
        kept = None if self._solver is None else self._solver.params
        if kept is None or dataclasses.replace(
                params, iteration_limit=kept.iteration_limit) != kept:
            self._solver = BatchSolver(self.qp, params, self.batch_size,
                                       device=self.device, v0=self.v0)
        return self._solver

    def solve(self, lbs, ubs, warm_x=None, warm_y=None, lp_params=None,
              deadline: float = math.inf) -> NodeLpResult:
        n_real = lbs.shape[0]
        pad = self.batch_size - n_real

        def padded(v):
            if v is None or pad <= 0:
                return v
            return np.concatenate([v, np.repeat(v[:1], pad, axis=0)])

        params = lp_params or self.lp_params
        solver = self._solver_for(params)
        res = solver.solve(padded(lbs), padded(ubs), padded(warm_x),
                           padded(warm_y), deadline,
                           iteration_limit=params.iteration_limit)
        return NodeLpResult(
            primal_solution=res.primal_solution[:n_real],
            dual_solution=res.dual_solution[:n_real],
            dual_bound=res.dual_bound[:n_real],
            primal_infeasible=res.primal_infeasible[:n_real],
            optimal=res.optimal[:n_real],
            skipped=np.zeros(n_real, dtype=bool),
        )


class SimplexNodeBackend:
    """Sequential warm-started dual-simplex node LPs on the host.

    One ``RevisedSimplex`` instance persists across every node of the
    tree; each node re-solve starts from the previous node's basis
    (reference: revised_simplex warm `Solve` after `SetVariableBounds`).
    ``device`` and ``lp_dtype`` are those of the PDHG fallback."""

    name = "simplex"

    def __init__(self, qp_min: QuadraticProgram, max_iterations: int = 50_000,
                 device="cuda", lp_dtype: torch.dtype = torch.float32):
        from ortools_tpu_torch.glop.simplex import RevisedSimplex

        self.qp = qp_min
        self.max_iterations = max_iterations
        self.device = device
        self.lp_dtype = lp_dtype
        self._sx = RevisedSimplex(qp_min)
        self._cold = True
        self.m = qp_min.num_constraints
        self.n = qp_min.num_variables
        # native hot path (_native/smalllp.cc): dense dual re-solves with
        # Python-side certificate verification; None when out of range
        self._native = None
        self._native_seeded = False
        try:
            from ortools_tpu_torch.glop.native_simplex import NativeSmallLp

            self._native = NativeSmallLp(qp_min)
            # cold all-slack dual-feasible start: the native core can
            # solve from scratch, so node LPs never have to wait for a
            # Python-simplex OPTIMAL to seed the basis
            if self._native.seed_all_slack():
                self._native_seeded = True
        except Exception:
            self._native = None

    def _native_resolve(self, lb, ub):
        """Try the native dual simplex.  Returns (status, x, y, obj) or
        None to fall through to the Python path."""
        if self._native is None or not self._native_seeded:
            return None
        try:
            st, x, y, obj, _bound = self._native.resolve(lb, ub)
        except Exception:
            return None
        if st == MPSolverStatus.OPTIMAL:
            return st, x, y, obj
        if st == MPSolverStatus.INFEASIBLE:
            return st, None, None, math.nan
        # ABNORMAL from a warm basis: retry once from the cold all-slack
        # dual-feasible start before paying for the Python fallback
        try:
            if self._native.seed_all_slack():
                st, x, y, obj, _bound = self._native.resolve(lb, ub)
                if st == MPSolverStatus.OPTIMAL:
                    return st, x, y, obj
                if st == MPSolverStatus.INFEASIBLE:
                    return st, None, None, math.nan
        except Exception:
            pass
        # unverified: Python fallback, then re-seed
        self._native_seeded = False
        return None

    def _seed_native(self) -> None:
        """Export the Python simplex's basis into the native core."""
        if self._native is None:
            return
        try:
            self._native.seed_basis(self._sx.basis, self._sx.nb_status)
            self._native_seeded = True
        except Exception:
            self._native_seeded = False

    def resolve_raw(self, lb: np.ndarray, ub: np.ndarray,
                    deadline: float = math.inf
                    ) -> Tuple[MPSolverStatus, Optional[np.ndarray],
                               Optional[np.ndarray], float]:
        """Re-solve with new variable bounds.  Returns
        (status, x, y, objective); x/y are None unless OPTIMAL."""
        from ortools_tpu_torch.glop.simplex import RevisedSimplex

        native = self._native_resolve(lb, ub)
        if native is not None:
            return native
        sx = self._sx
        if self._cold:
            sx.set_variable_bounds(lb, ub)
            st = sx.primal_solve(max_iterations=self.max_iterations,
                                 deadline=deadline)
            self._cold = False
        else:
            st = sx.resolve(lb, ub, max_iterations=self.max_iterations,
                            deadline=deadline)
        if st == MPSolverStatus.OPTIMAL:
            self._seed_native()
        if st == MPSolverStatus.ABNORMAL:
            # numerically stuck basis: rebuild from scratch once
            self._sx = sx = RevisedSimplex(self.qp)
            sx.set_variable_bounds(lb, ub)
            st = sx.primal_solve(max_iterations=self.max_iterations,
                                 deadline=deadline)
        if st in (MPSolverStatus.ABNORMAL, MPSolverStatus.UNBOUNDED):
            # simplex cannot finish this LP (e.g. degenerate cycling on
            # nearly-dependent cut rows): solve it with the in-house
            # first-order engine instead — PDHG has no basis to corrupt.
            st2, x2, y2, obj2 = self._pdhg_fallback(lb, ub, deadline)
            if st2 is not None:
                return st2, x2, y2, obj2
        if st != MPSolverStatus.OPTIMAL:
            # NOT_SOLVED (deadline) / UNBOUNDED / ABNORMAL: the caller
            # keeps the parent bound — never prune on an unproven status
            return st, None, None, math.nan
        r = sx.result(st)
        return st, r.primal_solution, r.dual_solution, r.objective_value

    def _pdhg_fallback(self, lb, ub, deadline):
        """Solve one node LP with ``pdlp.solve`` on the B&B's device, in its
        LP dtype.  Returns (status, x, y, obj) or (None, ...) when PDHG
        can't certify.  Only a numerical failure of the solve counts as
        that; a CUDA error or a failed kernel build or launch propagates."""
        from ortools_tpu_torch.pdlp import PdhgParams, solve as _pdlp_solve
        from ortools_tpu_torch.utils.status import TerminationReason

        remaining = (deadline - time.perf_counter()
                     if math.isfinite(deadline) else 60.0)
        if remaining < 3.0:
            # a cold PDHG solve builds its problem and captures its
            # graphs; not worth starting
            return None, None, None, math.nan
        dtype = self.lp_dtype
        params = PdhgParams(
            dtype=dtype,
            eps_optimal_absolute=1e-7 if dtype == torch.float64 else 1e-6,
            eps_optimal_relative=1e-7 if dtype == torch.float64 else 1e-6,
            iteration_limit=50_000,
            time_sec_limit=min(15.0, remaining),
        )
        qp_node = dataclasses.replace(self.qp, variable_lower=np.asarray(lb),
                                      variable_upper=np.asarray(ub))
        try:
            r = _pdlp_solve(qp_node, params, device=self.device)
        except (ValueError, ArithmeticError):
            return None, None, None, math.nan
        if r.termination_reason == TerminationReason.OPTIMAL:
            return (MPSolverStatus.OPTIMAL, r.primal_solution,
                    r.dual_solution, float(r.primal_objective))
        if r.termination_reason == TerminationReason.PRIMAL_INFEASIBLE:
            return MPSolverStatus.INFEASIBLE, None, None, math.nan
        return None, None, None, math.nan

    def solve(self, lbs, ubs, warm_x=None, warm_y=None, lp_params=None,
              deadline: float = math.inf) -> NodeLpResult:
        b = lbs.shape[0]
        xs = np.zeros((b, self.n))
        ys = np.zeros((b, self.m))
        bound = np.full(b, -math.inf)
        infeas = np.zeros(b, dtype=bool)
        opt = np.zeros(b, dtype=bool)
        skipped = np.zeros(b, dtype=bool)
        for i in range(b):
            if time.perf_counter() > deadline:
                skipped[i] = True
                continue
            st, x, y, obj = self.resolve_raw(lbs[i], ubs[i],
                                             deadline=deadline)
            if st == MPSolverStatus.OPTIMAL:
                xs[i], ys[i], bound[i], opt[i] = x, y, obj, True
            elif st == MPSolverStatus.INFEASIBLE:
                infeas[i] = True
            # UNBOUNDED/ABNORMAL: leave unsolved (bound = -inf, not
            # optimal) — the caller keeps the parent bound and branches.
        return NodeLpResult(xs, ys, bound, infeas, opt, skipped)


def choose_backend(qp_min: QuadraticProgram, lp_params, batch_size: int,
                   mode: str = "auto",
                   simplex_max_m: int = 1200,
                   simplex_max_mn: int = 1_200_000,
                   device="cuda"):
    """Pick the node-LP backend.  ``auto`` routes small pure-LP models to
    the host simplex (dense-tableau cost ~ m*(m+n) per pivot) and
    everything else to batched PDHG.  ``device`` is the B&B's; the simplex
    takes its PDHG fallback's dtype from ``lp_params``."""
    if mode == "pdhg":
        return PdhgNodeBackend(qp_min, lp_params, batch_size, device=device)
    if mode == "simplex":
        return SimplexNodeBackend(qp_min, device=device,
                                  lp_dtype=lp_params.dtype)
    m, n = qp_min.num_constraints, qp_min.num_variables
    has_q = not qp_min.is_lp()
    if not has_q and m <= simplex_max_m and m * (m + n) <= simplex_max_mn:
        return SimplexNodeBackend(qp_min, device=device,
                                  lp_dtype=lp_params.dtype)
    return PdhgNodeBackend(qp_min, lp_params, batch_size, device=device)
