"""Boolean optimization (BOP), the PyTorch port of ``ortools_tpu/bop``.

Capability parity: ``ortools/bop`` — BopSolver (bop_solver.h:59) and the
IntegralSolver facade for integral LPs (integral_solver.h:28).  In the
reference BOP is a portfolio of SAT-based local search / LNS strategies
that predates CP-SAT; here the same entry points route to this framework's
CP-SAT layer (boolean models) and batched-B&B MIP (integral LPs), which
subsume BOP's capabilities.  Of them the port has the batched-B&B route,
which runs on the solver's device (the card by default).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.utils.device import lp_dtype, resolve_device
from ortools_tpu_torch.utils.status import MPSolverStatus, SolveStatus


@dataclasses.dataclass
class BopResult:
    status: SolveStatus
    solution: Optional[List[int]]
    objective_value: float


class IntegralSolver:
    """Solve an LP whose variables are all integral (integral_solver.h:28)
    with the MIP layer on ``device``."""

    def __init__(self, device="cuda") -> None:
        self.device = device

    def solve(self, qp: QuadraticProgram) -> BopResult:
        from ortools_tpu_torch.mip import MipParams, solve as mip_solve

        device = resolve_device(self.device)
        if qp.integrality is None or not np.all(qp.integrality):
            qp = dataclasses.replace(
                qp, integrality=np.ones(qp.num_variables, dtype=bool)
            )
        r = mip_solve(qp, MipParams(), device=device,
                      lp_dtype=lp_dtype(device))
        mapping = {
            MPSolverStatus.OPTIMAL: SolveStatus.OPTIMAL,
            MPSolverStatus.FEASIBLE: SolveStatus.FEASIBLE,
            MPSolverStatus.INFEASIBLE: SolveStatus.INFEASIBLE,
        }
        status = mapping.get(r.status, SolveStatus.UNKNOWN)
        sol = None
        if status in (SolveStatus.OPTIMAL, SolveStatus.FEASIBLE):
            sol = [int(round(v)) for v in r.solution]
        return BopResult(status, sol, r.objective_value)

    Solve = solve
