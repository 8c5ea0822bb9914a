"""Termination reasons of the iterative solvers (copy of
``ortools_tpu/utils/status.py``'s ``TerminationReason``; the PDLP-style
vocabulary of the reference's ``ortools/pdlp/solve_log.proto``)."""

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
