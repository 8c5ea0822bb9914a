"""Max flow.

Capability parity: ``ortools/graph/max_flow.h:153`` (SimpleMaxFlow) — same
arc-list API; the solve runs in the native C++ push-relabel core
(_native/graph.cc, highest-label + gap heuristic like the reference's
GenericMaxFlow).
"""

from __future__ import annotations

import ctypes
import enum
from typing import List

import numpy as np

from ortools_tpu_torch._native import load_library


class Status(enum.Enum):
    OPTIMAL = 0
    BAD_INPUT = 1
    BAD_RESULT = 2


class SimpleMaxFlow:
    OPTIMAL = Status.OPTIMAL
    BAD_INPUT = Status.BAD_INPUT
    BAD_RESULT = Status.BAD_RESULT

    def __init__(self) -> None:
        self._tails: List[int] = []
        self._heads: List[int] = []
        self._caps: List[int] = []
        self._flows: np.ndarray | None = None
        self._optimal_flow = 0

    def add_arc_with_capacity(self, tail: int, head: int,
                              capacity: int) -> int:
        if tail < 0 or head < 0 or capacity < 0:
            raise ValueError("negative tail/head/capacity")
        self._tails.append(int(tail))
        self._heads.append(int(head))
        self._caps.append(int(capacity))
        return len(self._tails) - 1

    AddArcWithCapacity = add_arc_with_capacity

    @property
    def num_arcs(self) -> int:
        return len(self._tails)

    NumArcs = lambda self: self.num_arcs  # noqa: E731

    @property
    def num_nodes(self) -> int:
        if not self._tails:
            return 0
        return max(max(self._tails), max(self._heads)) + 1

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

    def solve(self, source: int, sink: int) -> Status:
        n = max(self.num_nodes, source + 1, sink + 1)
        m = len(self._tails)
        lib = load_library("graph")
        lib.otpu_max_flow.restype = ctypes.c_int64
        tails = np.asarray(self._tails, dtype=np.int32)
        heads = np.asarray(self._heads, dtype=np.int32)
        caps = np.asarray(self._caps, dtype=np.int64)
        flows = np.zeros(m, dtype=np.int64)
        value = lib.otpu_max_flow(
            ctypes.c_int32(n), ctypes.c_int64(m),
            tails.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            heads.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32(source), ctypes.c_int32(sink),
            flows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        self._optimal_flow = int(value)
        self._flows = flows
        return Status.OPTIMAL

    Solve = solve

    def optimal_flow(self) -> int:
        return self._optimal_flow

    OptimalFlow = optimal_flow

    def flow(self, arc: int) -> int:
        assert self._flows is not None, "solve() first"
        return int(self._flows[arc])

    Flow = flow
