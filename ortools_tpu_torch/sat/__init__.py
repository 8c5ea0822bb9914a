from ortools_tpu_torch.sat.cp_model import (  # noqa: F401
    CpModel,
    CpSolver,
    CpSolverSolutionCallback,
    IntVar,
    LinearExpr,
)
from ortools_tpu_torch.utils.status import SolveStatus  # noqa: F401

# Status aliases mirroring the reference's cp_model module constants.
UNKNOWN = SolveStatus.UNKNOWN
MODEL_INVALID = SolveStatus.MODEL_INVALID
FEASIBLE = SolveStatus.FEASIBLE
INFEASIBLE = SolveStatus.INFEASIBLE
OPTIMAL = SolveStatus.OPTIMAL
