"""Vectorized bound propagation for linear constraints.

Capability parity: the reference's ``LinearPropagator``
(``ortools/sat/linear_propagation.h:176``) and classic bound strengthening
in presolve — recast from watch-list event propagation to whole-matrix
interval arithmetic fixed-point iteration (SURVEY §7 Phase 3): each round
computes all constraint activity bounds and all implied variable bounds at
once with sparse matrix ops; no per-literal queues.

Infinity-safe residual activities use the standard "count infinite
contributions per row" trick so one unbounded variable doesn't block
tightening the others.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def propagate_bounds(
    a: sp.csr_matrix,
    con_lb: np.ndarray,
    con_ub: np.ndarray,
    var_lb: np.ndarray,
    var_ub: np.ndarray,
    integrality: np.ndarray,
    max_rounds: int = 10,
    feas_tol: float = 1e-9,
    int_tol: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Tighten variable bounds; returns (lb, ub, feasible).

    feasible=False proves infeasibility of the node (activity bounds
    incompatible with constraint bounds, or crossed variable bounds).
    """
    a = sp.csr_matrix(a)
    lb = np.array(var_lb, dtype=np.float64)
    ub = np.array(var_ub, dtype=np.float64)
    m, n = a.shape
    if m == 0 or a.nnz == 0:
        return lb, ub, bool(np.all(lb <= ub + feas_tol))
    data = a.data
    indices = a.indices
    indptr = a.indptr
    row_of = np.repeat(np.arange(m), np.diff(indptr))

    for _ in range(max_rounds):
        if np.any(lb > ub + feas_tol):
            return lb, ub, False
        # Per-entry min/max contribution a_ij * x_j.
        lo_c = np.where(data > 0, data * lb[indices], data * ub[indices])
        hi_c = np.where(data > 0, data * ub[indices], data * lb[indices])
        lo_inf = ~np.isfinite(lo_c)
        hi_inf = ~np.isfinite(hi_c)
        lo_fin = np.where(lo_inf, 0.0, lo_c)
        hi_fin = np.where(hi_inf, 0.0, hi_c)
        min_act_fin = np.bincount(row_of, weights=lo_fin, minlength=m)
        max_act_fin = np.bincount(row_of, weights=hi_fin, minlength=m)
        n_lo_inf = np.bincount(row_of, weights=lo_inf.astype(np.float64),
                               minlength=m)
        n_hi_inf = np.bincount(row_of, weights=hi_inf.astype(np.float64),
                               minlength=m)
        min_act = np.where(n_lo_inf > 0, -np.inf, min_act_fin)
        max_act = np.where(n_hi_inf > 0, np.inf, max_act_fin)
        if np.any(min_act > con_ub + feas_tol * (1 + np.abs(con_ub))) or np.any(
            max_act < con_lb - feas_tol * (1 + np.abs(con_lb))
        ):
            return lb, ub, False

        # Residual activities excluding each entry (finite only when the
        # row has no other infinite contribution).  Row-level quantities are
        # gathered to entry level via row_of.
        n_lo_inf_e = n_lo_inf[row_of]
        n_hi_inf_e = n_hi_inf[row_of]
        res_min = np.where(
            (n_lo_inf_e == 0) | ((n_lo_inf_e == 1) & lo_inf),
            min_act_fin[row_of] - lo_fin,
            -np.inf,
        )
        res_max = np.where(
            (n_hi_inf_e == 0) | ((n_hi_inf_e == 1) & hi_inf),
            max_act_fin[row_of] - hi_fin,
            np.inf,
        )
        cu_e = con_ub[row_of]
        cl_e = con_lb[row_of]
        with np.errstate(invalid="ignore"):
            # a_ij > 0: x_j <= (cu - res_min)/a ; x_j >= (cl - res_max)/a
            # a_ij < 0: x_j >= (cu - res_min)/a ; x_j <= (cl - res_max)/a
            cand1 = (cu_e - res_min) / data  # ub if a>0 else lb
            cand2 = (cl_e - res_max) / data  # lb if a>0 else ub
        new_ub_c = np.where(data > 0, cand1, cand2)
        new_lb_c = np.where(data > 0, cand2, cand1)
        new_ub_c = np.where(np.isnan(new_ub_c), np.inf, new_ub_c)
        new_lb_c = np.where(np.isnan(new_lb_c), -np.inf, new_lb_c)

        # Fold entry candidates into per-variable bounds (min/max reduce).
        imp_ub = np.full(n, np.inf)
        np.minimum.at(imp_ub, indices, new_ub_c)
        imp_lb = np.full(n, -np.inf)
        np.maximum.at(imp_lb, indices, new_lb_c)

        cand_ub = np.minimum(ub, imp_ub)
        cand_lb = np.maximum(lb, imp_lb)
        cand_ub = np.where(
            integrality, np.floor(cand_ub + int_tol), cand_ub
        )
        cand_lb = np.where(
            integrality, np.ceil(cand_lb - int_tol), cand_lb
        )
        # Only accept meaningful tightenings to reach a fixed point fast.
        improved = (cand_ub < ub - 1e-12) | (cand_lb > lb + 1e-12)
        if not improved.any():
            break
        ub = cand_ub
        lb = cand_lb
    return lb, ub, bool(np.all(lb <= ub + feas_tol))
