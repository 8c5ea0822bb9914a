"""Min-cost flow.

Capability parity: ``ortools/graph/min_cost_flow.h:244`` (SimpleMinCostFlow)
— same arc/supply API; the solve runs in the native C++ core
(_native/graph.cc, successive shortest paths with potentials; the
reference uses cost-scaling push-relabel — same optima, different engine).
"""

from __future__ import annotations

import ctypes
import enum
from typing import List

import numpy as np

from ortools_tpu_torch._native import load_library


class Status(enum.Enum):
    NOT_SOLVED = 0
    OPTIMAL = 1
    FEASIBLE = 2
    INFEASIBLE = 3
    UNBALANCED = 4
    BAD_RESULT = 5
    BAD_COST_RANGE = 6


class SimpleMinCostFlow:
    NOT_SOLVED = Status.NOT_SOLVED
    OPTIMAL = Status.OPTIMAL
    INFEASIBLE = Status.INFEASIBLE
    UNBALANCED = Status.UNBALANCED

    def __init__(self) -> None:
        self._tails: List[int] = []
        self._heads: List[int] = []
        self._caps: List[int] = []
        self._costs: List[int] = []
        self._supplies: dict = {}
        self._flows: np.ndarray | None = None
        self._optimal_cost = 0

    def add_arc_with_capacity_and_unit_cost(self, tail: int, head: int,
                                            capacity: int,
                                            unit_cost: int) -> int:
        self._tails.append(int(tail))
        self._heads.append(int(head))
        self._caps.append(int(capacity))
        self._costs.append(int(unit_cost))
        return len(self._tails) - 1

    AddArcWithCapacityAndUnitCost = add_arc_with_capacity_and_unit_cost

    def set_node_supply(self, node: int, supply: int) -> None:
        self._supplies[int(node)] = int(supply)

    SetNodeSupply = set_node_supply

    @property
    def num_arcs(self) -> int:
        return len(self._tails)

    NumArcs = lambda self: self.num_arcs  # noqa: E731

    @property
    def num_nodes(self) -> int:
        nodes = set(self._tails) | set(self._heads) | set(self._supplies)
        return (max(nodes) + 1) if nodes else 0

    NumNodes = lambda self: self.num_nodes  # noqa: E731

    def tail(self, arc: int) -> int:
        return self._tails[arc]

    Tail = tail

    def head(self, arc: int) -> int:
        return self._heads[arc]

    Head = head

    def capacity(self, arc: int) -> int:
        return self._caps[arc]

    Capacity = capacity

    def unit_cost(self, arc: int) -> int:
        return self._costs[arc]

    UnitCost = unit_cost

    def supply(self, node: int) -> int:
        return self._supplies.get(node, 0)

    Supply = supply

    def solve(self) -> Status:
        n = self.num_nodes
        if sum(self._supplies.values()) != 0:
            return Status.UNBALANCED
        m = len(self._tails)
        lib = load_library("graph")
        lib.otpu_min_cost_flow.restype = ctypes.c_int32
        tails = np.asarray(self._tails, dtype=np.int32)
        heads = np.asarray(self._heads, dtype=np.int32)
        caps = np.asarray(self._caps, dtype=np.int64)
        costs = np.asarray(self._costs, dtype=np.int64)
        supplies = np.zeros(n, dtype=np.int64)
        for node, s in self._supplies.items():
            supplies[node] = s
        flows = np.zeros(m, dtype=np.int64)
        cost = ctypes.c_int64(0)
        status = lib.otpu_min_cost_flow(
            ctypes.c_int32(n), ctypes.c_int64(m),
            tails.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            heads.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            costs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            supplies.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            flows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.byref(cost),
        )
        if status != 0:
            return Status.INFEASIBLE
        self._flows = flows
        self._optimal_cost = int(cost.value)
        return Status.OPTIMAL

    Solve = solve

    def optimal_cost(self) -> int:
        return self._optimal_cost

    OptimalCost = optimal_cost

    def flow(self, arc: int) -> int:
        assert self._flows is not None, "solve() first"
        return int(self._flows[arc])

    Flow = flow
