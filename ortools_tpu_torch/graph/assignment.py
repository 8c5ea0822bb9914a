"""Linear sum assignment.

Capability parity: ``ortools/graph/linear_assignment.h`` and
``ortools/algorithms/hungarian.h:48`` — dense Hungarian (JV potentials,
O(n^3)) in the native core, with the reference's LinearSumAssignment-style
arc API on top.
"""

from __future__ import annotations

import ctypes
import enum
import math
from typing import Dict, Tuple

import numpy as np

from ortools_tpu_torch._native import load_library


def hungarian(cost_matrix: np.ndarray) -> Tuple[np.ndarray, float]:
    """Assign each row to a distinct column minimizing total cost.
    cost_matrix is [num_rows, num_cols] with num_rows <= num_cols.
    Returns (assignment[num_rows], total_cost)."""
    c = np.ascontiguousarray(cost_matrix, dtype=np.float64)
    nr, nc = c.shape
    if nr > nc:
        raise ValueError("num_rows must be <= num_cols")
    lib = load_library("graph")
    lib.otpu_hungarian.restype = ctypes.c_double
    out = np.full(nr, -1, dtype=np.int32)
    total = lib.otpu_hungarian(
        ctypes.c_int32(nr), ctypes.c_int32(nc),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, float(total)


class Status(enum.Enum):
    OPTIMAL = 0
    INFEASIBLE = 1
    POSSIBLE_OVERFLOW = 2


class LinearSumAssignment:
    """Arc-based API over the dense Hungarian core (reference
    linear_assignment.h SimpleLinearSumAssignment)."""

    OPTIMAL = Status.OPTIMAL
    INFEASIBLE = Status.INFEASIBLE

    def __init__(self) -> None:
        self._arcs: Dict[Tuple[int, int], int] = {}
        self._num_left = 0
        self._num_right = 0
        self._assignment: Dict[int, int] = {}
        self._cost = 0

    def add_arc_with_cost(self, left: int, right: int, cost: int) -> int:
        key = (int(left), int(right))
        if key not in self._arcs or cost < self._arcs[key]:
            self._arcs[key] = int(cost)
        self._num_left = max(self._num_left, left + 1)
        self._num_right = max(self._num_right, right + 1)
        return len(self._arcs) - 1

    AddArcWithCost = add_arc_with_cost

    @property
    def num_nodes(self) -> int:
        return max(self._num_left, self._num_right)

    NumNodes = lambda self: self.num_nodes  # noqa: E731

    def solve(self) -> Status:
        n = self.num_nodes
        if self._num_left > self._num_right:
            return Status.INFEASIBLE
        big = np.float64(1e15)
        c = np.full((self._num_left, self._num_right), big)
        for (l, r), w in self._arcs.items():
            c[l, r] = w
        assignment, total = hungarian(c)
        # any row stuck on a "big" arc means no perfect matching exists
        for l in range(self._num_left):
            if c[l, assignment[l]] >= big:
                return Status.INFEASIBLE
        self._assignment = {l: int(assignment[l])
                            for l in range(self._num_left)}
        self._cost = int(round(total))
        return Status.OPTIMAL

    Solve = solve

    def optimal_cost(self) -> int:
        return self._cost

    OptimalCost = optimal_cost

    def right_mate(self, left: int) -> int:
        return self._assignment[left]

    RightMate = right_mate

    def assignment_cost(self, left: int) -> int:
        return self._arcs[(left, self._assignment[left])]

    AssignmentCost = assignment_cost
