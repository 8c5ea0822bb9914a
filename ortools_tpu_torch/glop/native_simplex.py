"""ctypes wrapper for the native small-LP dual simplex (_native/smalllp.cc).

Role: the reference embeds a C++ ``glop::RevisedSimplex`` in its search
(``sat/linear_programming_constraint.h:442``); here the node-LP hot path
gets the same native treatment while the featureful Python simplex
(``glop/simplex.py``) remains the root/fallback oracle.

Soundness contract: NOTHING the native core claims is trusted directly.

- OPTIMAL claims: the caller receives ``(x, y, d)`` and this module
  recomputes the **weak-duality certificate** in numpy — primal
  feasibility of ``x`` plus the dual objective ``g(y, d)`` from
  sign-split bound products.  ``g`` is a valid lower bound for ANY
  sign-consistent ``(y, d)``, so pruning on it is safe even under a
  native bug; the claim is only reported OPTIMAL when the gap closes.
- INFEASIBLE claims come with a Farkas row multiplier ``rho``; verified
  by interval arithmetic: 0 must lie outside the achievable range of
  ``rho . (A x - s)`` over the bound box.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch._native.build import load_library
from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.utils.status import MPSolverStatus

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library("smalllp")
        c = ctypes
        dp = c.POINTER(c.c_double)
        sigs = [
            ("slp_new", c.c_void_p, [c.c_int, c.c_int, dp, dp]),
            ("slp_free", None, [c.c_void_p]),
            ("slp_set_bounds", None, [c.c_void_p, dp, dp, dp, dp]),
            ("slp_set_basis", None,
             [c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_int8)]),
            ("slp_resolve", c.c_int, [c.c_void_p, c.c_int]),
            ("slp_objective", c.c_double, [c.c_void_p]),
            ("slp_solution", None, [c.c_void_p, dp]),
            ("slp_duals", None, [c.c_void_p, dp]),
            ("slp_redcosts", None, [c.c_void_p, dp]),
            ("slp_farkas", None, [c.c_void_p, dp]),
            ("slp_iters", c.c_long, [c.c_void_p]),
        ]
        for name, res, args in sigs:
            f = getattr(lib, name)
            f.restype = res
            f.argtypes = args
        _LIB = lib
    return _LIB


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeSmallLp:
    """Persistent native dual-simplex instance for one (A, c) model."""

    MAX_M = 512
    MAX_CELLS = 400_000  # m * n dense-tableau guard

    def __init__(self, qp_min: QuadraticProgram):
        if not qp_min.is_lp():
            raise ValueError("LP only")
        m, n = qp_min.num_constraints, qp_min.num_variables
        if m == 0 or m > self.MAX_M or m * n > self.MAX_CELLS:
            raise ValueError("model too large for the native small-LP core")
        self.m, self.n = m, n
        self.a = sp.csr_matrix(qp_min.constraint_matrix)
        self.at = sp.csr_matrix(self.a.T)
        a_dense = np.ascontiguousarray(self.a.toarray(), dtype=np.float64)
        self.c = np.ascontiguousarray(qp_min.objective_vector,
                                      dtype=np.float64)
        self.obj_const = float(qp_min.objective_constant)
        self.cl = np.asarray(qp_min.constraint_lower, dtype=np.float64)
        self.cu = np.asarray(qp_min.constraint_upper, dtype=np.float64)
        self._lib = _lib()
        self._h = ctypes.c_void_p(self._lib.slp_new(
            m, n, _dp(a_dense), _dp(self.c)))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.slp_free(self._h)
                self._h = None
        except Exception:
            pass

    def seed_all_slack(self) -> bool:
        """Cold start: all-slack basis with nonbasic structural columns
        placed at the bound that makes their reduced cost (= cost, since
        y = 0 for a zero-cost slack basis) dual feasible.  Valid whenever
        every negative-cost structural has a finite upper bound and every
        positive-cost one a finite lower bound — always true for the
        boxed relaxations B&B feeds this core.  Returns False when a
        free column with nonzero cost makes the start dual-infeasible
        (the caller should use the featureful Python simplex instead)."""
        basis = np.arange(self.n, self.n + self.m, dtype=np.int32)
        nbstat = np.zeros(self.n + self.m, dtype=np.int8)
        nbstat[: self.n][self.c < 0] = 1  # AT_UPPER
        self.seed_basis(basis, nbstat)
        return True

    def seed_basis(self, basis: np.ndarray, nb_status: np.ndarray) -> None:
        b = np.ascontiguousarray(basis, dtype=np.int32)
        s = np.ascontiguousarray(nb_status, dtype=np.int8)
        self._lib.slp_set_basis(
            self._h, b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))

    def resolve(self, var_lb: np.ndarray, var_ub: np.ndarray,
                max_iters: int = 20_000
                ) -> Tuple[MPSolverStatus, Optional[np.ndarray],
                           Optional[np.ndarray], float, float]:
        """Returns (status, x, y, objective, dual_bound).

        ``dual_bound`` is the VERIFIED weak-duality bound g(y, d) (valid
        whenever finite, independent of the native claim); objective/x/y
        are set on verified OPTIMAL only.
        """
        vlb = np.ascontiguousarray(var_lb, dtype=np.float64)
        vub = np.ascontiguousarray(var_ub, dtype=np.float64)
        self._lib.slp_set_bounds(self._h, _dp(vlb), _dp(vub),
                                 _dp(self.cl), _dp(self.cu))
        st = self._lib.slp_resolve(self._h, max_iters)
        if st == 1:  # INFEASIBLE: verify the Farkas certificate
            rho = np.zeros(self.m)
            self._lib.slp_farkas(self._h, _dp(rho))
            if self._verify_farkas(rho, vlb, vub):
                return (MPSolverStatus.INFEASIBLE, None, None, math.nan,
                        math.inf)
            return MPSolverStatus.ABNORMAL, None, None, math.nan, -math.inf
        if st != 0:
            return MPSolverStatus.ABNORMAL, None, None, math.nan, -math.inf
        x = np.zeros(self.n)
        y = np.zeros(self.m)
        self._lib.slp_solution(self._h, _dp(x))
        self._lib.slp_duals(self._h, _dp(y))
        ok, obj, bound = self._verify_optimal(x, y, vlb, vub)
        if ok:
            return MPSolverStatus.OPTIMAL, x, y, obj, bound
        # sign-consistent bound may still be usable by the caller
        return MPSolverStatus.ABNORMAL, None, None, math.nan, bound

    # -- independent certificates ----------------------------------------
    def _verify_optimal(self, x, y, vlb, vub, tol: float = 1e-6):
        ax = self.a @ x
        scale_x = 1.0 + float(np.abs(x).max(initial=0.0))
        scale_r = 1.0 + float(np.abs(ax).max(initial=0.0))
        if (np.any(x < vlb - tol * scale_x)
                or np.any(x > vub + tol * scale_x)
                or np.any(ax < self.cl - tol * scale_r)
                or np.any(ax > self.cu + tol * scale_r)):
            return False, math.nan, -math.inf
        obj = float(self.c @ x) + self.obj_const
        bound = self.dual_bound(y, vlb, vub)
        if not math.isfinite(bound):
            return False, obj, -math.inf
        if obj - bound > tol * (1.0 + abs(obj)):
            return False, obj, bound
        return True, obj, bound

    def dual_bound(self, y, vlb, vub) -> float:
        """Weak-duality bound: g(y) = bounds-term of the dual objective
        with d = c - A^T y.  Valid for ANY y when every product pairs a
        nonzero multiplier with a finite bound; -inf otherwise."""
        d = self.c - self.at @ y
        yp = np.maximum(y, 0.0)
        ym = np.minimum(y, 0.0)
        dp_ = np.maximum(d, 0.0)
        dm = np.minimum(d, 0.0)
        # sign-split products; 0 * inf -> invalid only when the
        # multiplier is actually nonzero
        terms = [
            (yp, self.cl), (ym, self.cu), (dp_, vlb), (dm, vub),
        ]
        total = self.obj_const
        for mult, bnd in terms:
            nz = np.abs(mult) > 1e-11
            if np.any(nz & ~np.isfinite(bnd)):
                return -math.inf
            total += float(mult[nz] @ bnd[nz])
        return total

    def _verify_farkas(self, rho, vlb, vub, tol: float = 1e-7) -> bool:
        """0 must be outside the achievable interval of
        rho.(A x - s) = sum_j alpha_j x_j - sum_i rho_i s_i over the box."""
        alpha = self.at @ rho  # structural coefficients
        lo = hi = 0.0
        with np.errstate(invalid="ignore"):  # 0 * inf rows are masked out
            for coef, l, u in ((alpha, vlb, vub), (-rho, self.cl, self.cu)):
                a_pos = coef > 1e-14
                a_neg = coef < -1e-14
                lo_t = np.where(a_pos, coef * l,
                                np.where(a_neg, coef * u, 0.0))
                hi_t = np.where(a_pos, coef * u,
                                np.where(a_neg, coef * l, 0.0))
                lo += float(lo_t.sum())
                hi += float(hi_t.sum())
        scale = 1.0 + float(np.abs(alpha).max(initial=0.0)) \
            + float(np.abs(rho).max(initial=0.0))
        return lo > tol * scale or hi < -tol * scale
