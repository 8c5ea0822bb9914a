from ortools_tpu_torch.math_opt.model import (  # noqa: F401
    ComputeInfeasibleSubsystemResult,
    Model,
    ModelSubset,
    SolveResult,
    SolverType,
    TerminationReason,
    compute_infeasible_subsystem,
    solve,
)
