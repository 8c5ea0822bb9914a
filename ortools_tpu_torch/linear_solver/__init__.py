from ortools_tpu_torch.linear_solver.model_builder import (  # noqa: F401
    LinearExpr,
    Model,
    Solver,
    Variable,
)
from ortools_tpu_torch.utils.status import MPSolverStatus  # noqa: F401
