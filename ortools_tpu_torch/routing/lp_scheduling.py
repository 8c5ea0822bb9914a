"""LP optimization of dimension cumuls along fixed routes.

Capability parity: ``ortools/constraint_solver/routing_lp_scheduling.cc``
(DimensionCumulOptimizer) — once routes are fixed by the search, the cumul
values of a dimension (e.g. times) form a small LP: per consecutive visit
pair, ``cumul[next] - cumul[cur]`` lies in ``[transit, transit +
slack_max]``; visit windows bound each cumul; the objective minimizes the
span (end minus start, weighted by the dimension's global span cost) plus
total cumul start.  Solved exactly with this framework's glop simplex.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.utils.status import MPSolverStatus


def optimize_route_cumuls(
    model, routes_by_vehicle: List[List[int]], dimension_name: str,
) -> Optional[Dict[int, float]]:
    """Optimal cumul per visited index, or None if the windows make the
    fixed routes infeasible.

    ``routes_by_vehicle[v]`` lists node indices visited by vehicle v in
    order, EXCLUDING the start/end depots (RoutingModel convention used by
    ``solve_from_routes``)."""
    dim = model.get_dimension_or_die(dimension_name)
    transit = model._callbacks[dim.evaluator_index]

    # variable ids: one cumul per (vehicle, position) including depots
    var_of: Dict[int, int] = {}
    seqs: List[List[int]] = []
    nvar = 0
    for v, route in enumerate(routes_by_vehicle):
        seq = [model.start(v)] + list(route) + [model.end(v)]
        seqs.append(seq)
        for idx in seq:
            var_of[idx] = nvar
            nvar += 1
    INF = np.inf
    lb = np.full(nvar, -INF)
    ub = np.full(nvar, INF)
    c = np.zeros(nvar)
    rows, cols, vals, cl, cu = [], [], [], [], []
    r = 0
    for v, seq in enumerate(seqs):
        cap = dim.capacities[v] if v < len(dim.capacities) else None
        for pos, idx in enumerate(seq):
            k = var_of[idx]
            lo = dim.cumul_lb.get(idx, 0)
            hi = dim.cumul_ub.get(idx, cap if cap is not None else INF)
            lb[k] = max(lb[k], lo) if np.isfinite(lb[k]) else lo
            ub[k] = min(ub[k], hi) if np.isfinite(ub[k]) else hi
            if pos == 0 and dim.fix_start_cumul_to_zero:
                lb[k] = max(lb[k], 0.0)
                ub[k] = min(ub[k], 0.0)
        for a, b in zip(seq, seq[1:]):
            t = float(transit(a, b))
            ka, kb = var_of[a], var_of[b]
            # t <= cumul[b] - cumul[a] <= t + slack_max
            rows += [r, r]
            cols += [kb, ka]
            vals += [1.0, -1.0]
            cl.append(t)
            cu.append(t + float(dim.slack_max))
            r += 1
        # span objective: (end - start) * coeff; plus a tiny pull toward
        # early starts so the solution is canonical
        coeff = float(dim.span_cost_coefficient)
        c[var_of[seq[-1]]] += coeff if coeff else 1e-3
        c[var_of[seq[0]]] -= coeff if coeff else 0.0
        c[var_of[seq[0]]] += 1e-6
    a_mat = sp.csr_matrix((vals, (rows, cols)), shape=(r, nvar)) if r \
        else sp.csr_matrix((0, nvar))
    qp = QuadraticProgram(
        objective_vector=c,
        constraint_matrix=a_mat,
        constraint_lower=np.array(cl),
        constraint_upper=np.array(cu),
        variable_lower=lb,
        variable_upper=ub,
    )
    from ortools_tpu_torch.glop import solve as glop_solve

    res = glop_solve(qp)
    if res.status != MPSolverStatus.OPTIMAL:
        return None
    return {idx: float(res.primal_solution[k]) for idx, k in var_of.items()}
