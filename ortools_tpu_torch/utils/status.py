"""Solver status and termination enums.

Capability parity: the status vocabularies of the reference —
``ortools/pdlp/solve_log.proto`` (TerminationReason),
``ortools/linear_solver/linear_solver.proto`` (MPSolverResponseStatus) and
``ortools/sat/cp_model.proto:717`` (CpSolverStatus) — merged into a small
set of enums used across the framework.
"""

import enum


class TerminationReason(enum.Enum):
    """Why an iterative solve stopped (PDLP-style vocabulary)."""

    UNSPECIFIED = 0
    OPTIMAL = 1
    PRIMAL_INFEASIBLE = 2
    DUAL_INFEASIBLE = 3
    TIME_LIMIT = 4
    ITERATION_LIMIT = 5
    KKT_MATRIX_PASS_LIMIT = 6
    NUMERICAL_ERROR = 7
    INVALID_PROBLEM = 8
    INVALID_PARAMETER = 9
    INTERRUPTED_BY_USER = 10
    PRIMAL_OR_DUAL_INFEASIBLE = 11

    @property
    def is_optimal(self) -> bool:
        return self is TerminationReason.OPTIMAL


class SolveStatus(enum.Enum):
    """CP/MIP solve status (CP-SAT-style vocabulary).

    Mirrors CpSolverStatus in the reference's cp_model.proto:717.
    """

    UNKNOWN = 0
    MODEL_INVALID = 1
    FEASIBLE = 2
    INFEASIBLE = 3
    OPTIMAL = 4


# MPSolver-style result statuses (reference linear_solver.h:426).
class MPSolverStatus(enum.Enum):
    OPTIMAL = 0
    FEASIBLE = 1
    INFEASIBLE = 2
    UNBOUNDED = 3
    ABNORMAL = 4
    MODEL_INVALID = 5
    NOT_SOLVED = 6
