"""Shortest paths.

Capability parity: ``ortools/graph/shortest_paths.h`` (Dijkstra) via the
native core, plus a Bellman-Ford in numpy for negative arc lengths.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ortools_tpu_torch._native import load_library


def dijkstra_shortest_path(
    num_nodes: int,
    tails: Sequence[int],
    heads: Sequence[int],
    lengths: Sequence[float],
    source: int,
    destination: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[List[int]]]:
    """Returns (distances, parents, path-to-destination or None).

    Arc lengths must be non-negative (use bellman_ford for negatives).
    """
    if any(l < 0 for l in lengths):
        raise ValueError("negative arc length; use bellman_ford")
    lib = load_library("graph")
    t = np.asarray(tails, dtype=np.int32)
    h = np.asarray(heads, dtype=np.int32)
    w = np.asarray(lengths, dtype=np.float64)
    dist = np.zeros(num_nodes, dtype=np.float64)
    parent = np.zeros(num_nodes, dtype=np.int32)
    lib.otpu_dijkstra(
        ctypes.c_int32(num_nodes), ctypes.c_int64(len(t)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int32(source),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    path = None
    if destination is not None and np.isfinite(dist[destination]):
        path = [destination]
        while path[-1] != source:
            path.append(int(parent[path[-1]]))
        path.reverse()
    return dist, parent, path


def bellman_ford(
    num_nodes: int,
    tails: Sequence[int],
    heads: Sequence[int],
    lengths: Sequence[float],
    source: int,
) -> Tuple[np.ndarray, bool]:
    """(distances, has_negative_cycle) — vectorized edge relaxation."""
    t = np.asarray(tails, dtype=np.int64)
    h = np.asarray(heads, dtype=np.int64)
    w = np.asarray(lengths, dtype=np.float64)
    dist = np.full(num_nodes, np.inf)
    dist[source] = 0.0
    for _ in range(num_nodes - 1):
        cand = dist[t] + w
        new = dist.copy()
        np.minimum.at(new, h, cand)
        if np.array_equal(new, dist):
            return dist, False
        dist = new
    cand = dist[t] + w
    new = dist.copy()
    np.minimum.at(new, h, cand)
    return dist, not np.array_equal(new, dist)
