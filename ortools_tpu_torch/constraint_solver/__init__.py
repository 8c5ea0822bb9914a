from ortools_tpu_torch.constraint_solver.pywrapcp import (  # noqa: F401
    IntVar,
    Solver,
)
