"""Whether an LP with given variable bounds has a feasible point, decided
without the program: the generator's own certificate where it finds a
point, else scipy's HiGHS on the feasibility problem (zero objective).

This is the one part of the reference that is not NumPy alone: deciding
that an LP has no feasible point takes an LP solver, and HiGHS shares
nothing with the program's PDHG.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from reference.lp import Instance


def is_feasible(inst: Instance, var_lo: np.ndarray, var_hi: np.ndarray,
                certificate=None, closed=()) -> bool:
    if certificate is not None and certificate(inst, closed) is not None:
        return True
    from scipy.optimize import linprog

    a = sp.csr_matrix((inst.vals, (inst.rows, inst.cols)), shape=(inst.m, inst.n))
    eq = inst.con_lo == inst.con_hi
    hi = ~eq & np.isfinite(inst.con_hi)
    lo = ~eq & np.isfinite(inst.con_lo)
    a_ub = sp.vstack([a[hi], -a[lo]]).tocsr()
    b_ub = np.concatenate([inst.con_hi[hi], -inst.con_lo[lo]])
    res = linprog(np.zeros(inst.n), A_ub=a_ub if a_ub.shape[0] else None,
                  b_ub=b_ub if a_ub.shape[0] else None,
                  A_eq=a[eq] if eq.any() else None,
                  b_eq=inst.con_lo[eq] if eq.any() else None,
                  bounds=np.stack([var_lo, var_hi], axis=1),
                  method="highs")
    if res.status == 2:
        return False
    if res.status == 0:
        return True
    raise RuntimeError(f"HiGHS could not decide feasibility: {res.message}")
