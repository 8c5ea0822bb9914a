"""Judge a returned LP solution by the optimality conditions, in float64,
from the instance alone.

The measures are OR-Tools PDLP's (``ortools/pdlp/iteration_stats.cc``,
``termination.cc``), in the L2 norm and in the original space:

- primal residual: how far A x lies outside [con_lo, con_hi] and x outside
  [var_lo, var_hi], against eps_abs + eps_rel * |combined bounds|;
- dual residual: the part of the reduced costs c - A^T y that no finite
  variable bound absorbs, with duals of the wrong sign on one-sided rows,
  against eps_abs + eps_rel * |c|;
- gap: |c.x - dual objective| against eps_abs + eps_rel * (|c.x| + |dual|).

Each tolerance is the configuration's, plus what evaluating the same
quantity in the configuration's precision (unit roundoff ``u``) may move it
by: the program evaluates its own termination test in that precision, and
the reference in float64.  For float64 that allowance is below 1e-14 of the
tolerance.  A ratio of 1 or less meets the configuration's tolerance.
"""

from __future__ import annotations

import numpy as np

from reference.lp import Instance, matvec, rmatvec


def _abs_matvec(inst: Instance, x: np.ndarray) -> np.ndarray:
    return np.bincount(inst.rows, weights=np.abs(inst.vals * x[inst.cols]),
                       minlength=inst.m)


def _abs_rmatvec(inst: Instance, y: np.ndarray) -> np.ndarray:
    return np.bincount(inst.cols, weights=np.abs(inst.vals * y[inst.rows]),
                       minlength=inst.n)


def combined_bounds_norm(lo: np.ndarray, hi: np.ndarray) -> float:
    bv = np.maximum(np.where(np.isfinite(lo), np.abs(lo), 0.0),
                    np.where(np.isfinite(hi), np.abs(hi), 0.0))
    return float(np.linalg.norm(bv))


def _times(a: np.ndarray, bound: np.ndarray) -> np.ndarray:
    """a * bound, 0 where a is 0 (so that 0 * inf never appears)."""
    return np.where(a != 0, a * np.where(a != 0, bound, 0.0), 0.0)


def judge(inst: Instance, x: np.ndarray, y: np.ndarray, var_lo: np.ndarray,
          var_hi: np.ndarray, eps_abs: float, eps_rel: float,
          u: float) -> dict:
    """The residual and gap ratios of (x, y) on ``inst`` with the variable
    bounds ``var_lo``, ``var_hi``, the objectives, and the Lagrangian bound
    of y.  ``lagrangian`` is con_term(y) + sum of min over each variable's
    box of r_j x_j, r = c - A^T y; ``lagrangian_finite`` leaves out the
    infinite terms (r_j < 0 at an infinite upper bound, r_j > 0 at an
    infinite lower one), which are the dual residual's entries."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ax = matvec(inst, x)
    primal_viol = np.concatenate([
        np.maximum(inst.con_lo - ax, 0.0) + np.maximum(ax - inst.con_hi, 0.0),
        np.maximum(var_lo - x, 0.0) + np.maximum(x - var_hi, 0.0)])
    primal_res = float(np.linalg.norm(primal_viol))
    norm_b = combined_bounds_norm(inst.con_lo, inst.con_hi)
    k_row = int(np.bincount(inst.rows, minlength=inst.m).max())
    k_col = int(np.bincount(inst.cols, minlength=inst.n).max())
    tol_p = (eps_abs + eps_rel * norm_b
             + u * (k_row + 2) * (np.linalg.norm(_abs_matvec(inst, x)) + norm_b))

    r = inst.c - rmatvec(inst, y)
    lo_fin, hi_fin = np.isfinite(var_lo), np.isfinite(var_hi)
    rc = np.where(r > 0, np.where(lo_fin, r, 0.0), np.where(hi_fin, r, 0.0))
    row_lo_fin, row_hi_fin = np.isfinite(inst.con_lo), np.isfinite(inst.con_hi)
    wrong_sign = (np.where(row_lo_fin, 0.0, np.maximum(y, 0.0))
                  + np.where(row_hi_fin, 0.0, np.maximum(-y, 0.0)))
    dual_res = float(np.linalg.norm(np.concatenate([r - rc, wrong_sign])))
    norm_c = float(np.linalg.norm(inst.c))
    tol_d = (eps_abs + eps_rel * norm_c
             + u * (k_col + 2) * (np.linalg.norm(_abs_rmatvec(inst, y)) + norm_c))

    con_terms = (np.where(y > 0, _times(y, inst.con_lo), 0.0)
                 + np.where(y < 0, _times(y, inst.con_hi), 0.0))
    var_terms = (np.where(rc > 0, _times(rc, var_lo), 0.0)
                 + np.where(rc < 0, _times(rc, var_hi), 0.0))
    pobj = float(inst.c @ x)
    dobj = float(con_terms.sum() + var_terms.sum())
    tol_g = (eps_abs + eps_rel * (abs(pobj) + abs(dobj))
             + 4 * u * (np.abs(inst.c * x).sum() + np.abs(con_terms).sum()
                        + np.abs(var_terms).sum()))
    gap = abs(pobj - dobj)

    lin = (np.where(r > 0, _times(r, var_lo), 0.0)
           + np.where(r < 0, _times(r, var_hi), 0.0))
    finite = np.isfinite(lin)
    lagr_finite = float(con_terms.sum() + lin[finite].sum())
    return dict(
        primal_res=primal_res / tol_p,
        dual_res=dual_res / tol_d,
        gap=gap / tol_g,
        primal_objective=pobj,
        dual_objective=dobj,
        tol_gap=tol_g,
        lagrangian=lagr_finite if finite.all() else -np.inf,
        lagrangian_finite=lagr_finite,
    )


def round_to(v: np.ndarray, dtype_name: str) -> np.ndarray:
    """``v`` rounded to the named torch dtype and back to float64 (the
    control's answers in a lower precision)."""
    import torch

    t = torch.as_tensor(np.asarray(v, dtype=np.float64))
    return t.to(getattr(torch, dtype_name)).to(torch.float64).numpy()
