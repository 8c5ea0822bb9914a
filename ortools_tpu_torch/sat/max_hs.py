"""Hitting-set core-guided optimization (MaxHS) on the CDCL core; the
PyTorch port of ``ortools_tpu/sat/max_hs.py``.

Capability parity: ``ortools/sat/max_hs.h`` (HittingSetOptimizer) — the
implicit-hitting-set max-SAT loop of Davies & Bacchus: alternate an exact
minimum-weight hitting set over the collected UNSAT cores (a tiny binary
covering MIP, solved by this framework's own branch-and-bound) with a
CDCL test of the complementary assumptions.  The hitting-set value is a
valid lower bound at every round; the first SAT answer closes the gap
and is therefore optimal.

Compared with the OLL descent (sat/core_guided.py) this pays a MIP per
round but never grows the formula with totalizers — the reference keeps
both in its portfolio for the same reason.

CP-SAT's solve reaches this loop under ``core_algorithm="max_hs"``
(``sat/solver.py::solve_model`` passes its ``device`` on); it can also be
called alone on a ``CpModelIR`` (``sat/model_ir.py``).  Each hitting-set
MIP runs on ``device``, the card by default.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.core_guided import _boolean_objective
from ortools_tpu_torch.sat.pure_sat import to_cnf
from ortools_tpu_torch.utils.device import lp_dtype, resolve_device


def _min_hitting_set(weights: List[int], cores: List[List[int]],
                     time_limit_sec: float, device
                     ) -> Optional[np.ndarray]:
    """Exact minimum-weight hitting set over core index-sets via the MIP
    layer on ``device``.  Returns the 0/1 selection or None when not
    proven optimal (the bound would be invalid)."""
    from ortools_tpu_torch.mip.branch_and_bound import solve as mip_solve
    from ortools_tpu_torch.models.lp import QuadraticProgram
    from ortools_tpu_torch.utils.status import MPSolverStatus

    n = len(weights)
    if not cores:
        return np.zeros(n)
    rows_i: List[int] = []
    cols: List[int] = []
    for r, core in enumerate(cores):
        rows_i.extend([r] * len(core))
        cols.extend(core)
    a = sp.csr_matrix((np.ones(len(cols)), (rows_i, cols)),
                      shape=(len(cores), n))
    qp = QuadraticProgram(
        objective_vector=np.asarray(weights, dtype=np.float64),
        constraint_matrix=a,
        constraint_lower=np.ones(len(cores)),
        constraint_upper=np.full(len(cores), np.inf),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
    )
    r = mip_solve(qp, max_nodes=5_000, node_batch_size=16,
                  time_limit_sec=time_limit_sec, cut_rounds=2,
                  rins_interval=0, local_branching_interval=0,
                  tree_cut_interval=0, device=device,
                  lp_dtype=lp_dtype(device))
    if r.status != MPSolverStatus.OPTIMAL:
        return None
    return np.round(r.solution)


def minimize_max_hs(
    model: ir.CpModelIR,
    deadline: Optional[float] = None,
    should_stop=None,
    conflict_slice: int = 50_000,
    hs_time_limit_sec: float = 10.0,
    *,
    device="cuda",
) -> Optional[Tuple[int, Optional[List[int]], int, int]]:
    """MaxHS optimization of a clause-like boolean model.

    Same contract as ``minimize_core_guided``: None when the model is
    outside the fragment, else ``(status, values, bound, num_conflicts)``
    with status 1=OPTIMAL, 0=INFEASIBLE, -1=UNKNOWN (bound = proven
    internal-sense lower bound so far).  The hitting-set MIPs run on
    ``device``."""
    device = resolve_device(device)
    if model.objective is None or model.assumptions:
        return None
    norm = _boolean_objective(model)
    if norm is None:
        return None
    weights, offset, _sense = norm
    base = dataclasses.replace(model, objective=None)
    clauses = to_cnf(base)
    if clauses is None:
        return None

    from ortools_tpu_torch.sat.cdcl import CdclSolver

    n_orig = len(model.variables)
    s = CdclSolver(num_vars=n_orig)
    for c in clauses:
        if not s.add_clause(c):
            return 0, None, 0, s.num_conflicts

    lits = sorted(weights)  # cost literals, fixed for the whole run
    wvec = [weights[l] for l in lits]
    lit_pos = {l: i for i, l in enumerate(lits)}
    cores: List[List[int]] = []
    lb = 0

    def expired() -> bool:
        if should_stop is not None and should_stop():
            return True
        return deadline is not None and time.monotonic() > deadline

    while True:
        remaining = (deadline - time.monotonic()
                     if deadline is not None else hs_time_limit_sec)
        if remaining <= 0:
            return -1, None, lb + offset, s.num_conflicts
        y = _min_hitting_set(wvec, cores,
                             min(hs_time_limit_sec, remaining), device)
        if y is None:
            return -1, None, lb + offset, s.num_conflicts
        lb = int(round(float(np.asarray(wvec) @ y)))
        # assume every cost literal OUTSIDE the hitting set is false
        assumptions = [-lits[i] for i in range(len(lits)) if y[i] < 0.5]
        st = s.solve(assumptions=assumptions,
                     conflict_budget=conflict_slice)
        while st == -1:
            if expired():
                return -1, None, lb + offset, s.num_conflicts
            st = s.solve(assumptions=assumptions,
                         conflict_budget=conflict_slice)
        if st == 1:
            # cost(model) <= w(hitting set) = lb and lb <= optimum:
            # the incumbent closes the gap — optimal
            m = s.model()
            values = [int(m[i]) for i in range(n_orig)]
            return 1, values, lb + offset, s.num_conflicts
        core = s.core()
        if not core:
            return 0, None, lb + offset, s.num_conflicts
        idxs = sorted({lit_pos[-c] for c in core if -c in lit_pos})
        if not idxs:
            return 0, None, lb + offset, s.num_conflicts
        cores.append(idxs)
