"""General-graph matching: Edmonds' blossom + exact weighted matching; the
PyTorch port of ``ortools_tpu/graph/matching.py``.

Capability parity: ``ortools/graph/perfect_matching.{h,cc}`` (blossom-based
minimum-cost perfect matching).  Redesigned in two layers:

- ``max_cardinality_matching``: Edmonds' blossom algorithm (augmenting
  paths with blossom contraction) — the combinatorial core, used for
  feasibility ("does a perfect matching exist?") and as the Christofides
  fallback skeleton.
- ``min_weight_perfect_matching``: exact minimum-weight perfect matching.
  Instead of the reference's dual-adjustment blossom code, the weighted
  problem is solved as a degree-constrained binary program through this
  framework's own batched-PDHG branch-and-bound (mip/branch_and_bound.py)
  — odd-set (blossom) inequalities arrive implicitly via integrality.
  For larger graphs a greedy + 2-exchange polish provides the incumbent
  and the MIP proves/repairs it within a node budget.

Both matchers run on the host.  ``device`` reaches only the MIP fallback,
the one part that can use the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

INF = float("inf")


def max_cardinality_matching(n: int, edges: Sequence[Tuple[int, int]]
                             ) -> List[int]:
    """Edmonds' blossom algorithm; returns mate[] with -1 for unmatched."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for (u, v) in edges:
        if u == v:
            continue
        adj[u].append(v)
        adj[v].append(u)
    mate = [-1] * n
    parent = [0] * n
    base = [0] * n
    q: List[int] = []
    used = [False] * n
    blossom = [False] * n

    def lca(a: int, b: int) -> int:
        used2 = [False] * n
        while True:
            a = base[a]
            used2[a] = True
            if mate[a] == -1:
                break
            a = parent[mate[a]]
        while True:
            b = base[b]
            if used2[b]:
                return b
            b = parent[mate[b]]

    def mark_path(v: int, b: int, child: int) -> None:
        while base[v] != b:
            blossom[base[v]] = True
            blossom[base[mate[v]]] = True
            parent[v] = child
            child = mate[v]
            v = parent[mate[v]]

    def find_path(root: int) -> int:
        nonlocal q
        for i in range(n):
            used[i] = False
            parent[i] = -1
            base[i] = i
        used[root] = True
        q = [root]
        while q:
            v = q.pop(0)
            for to in adj[v]:
                if base[v] == base[to] or mate[v] == to:
                    continue
                if to == root or (mate[to] != -1
                                  and parent[mate[to]] != -1):
                    cur = lca(v, to)
                    for i in range(n):
                        blossom[i] = False
                    mark_path(v, cur, to)
                    mark_path(to, cur, v)
                    for i in range(n):
                        if blossom[base[i]]:
                            base[i] = cur
                            if not used[i]:
                                used[i] = True
                                q.append(i)
                elif parent[to] == -1:
                    parent[to] = v
                    if mate[to] == -1:
                        # augment along the path ending at `to`
                        u = to
                        while u != -1:
                            pv = parent[u]
                            ppv = mate[pv]
                            mate[u] = pv
                            mate[pv] = u
                            u = ppv
                        return 1
                    used[mate[to]] = True
                    q.append(mate[to])
        return 0

    for v in range(n):
        if mate[v] == -1:
            find_path(v)
    return mate


def _greedy_perfect(dist: np.ndarray, nodes: List[int]
                    ) -> Optional[List[Tuple[int, int]]]:
    """Greedy + 2-exchange polish; None if |nodes| is odd."""
    if len(nodes) % 2:
        return None
    free = set(nodes)
    pairs: List[Tuple[int, int]] = []
    order = sorted(
        ((dist[a, b], a, b) for i, a in enumerate(nodes)
         for b in nodes[i + 1:]),
    )
    for (_, a, b) in order:
        if a in free and b in free:
            pairs.append((a, b))
            free.discard(a)
            free.discard(b)
    while free:  # disconnected cost structure: pair arbitrarily
        a = free.pop()
        b = free.pop()
        pairs.append((a, b))
    improved = True
    while improved:
        improved = False
        for i in range(len(pairs)):
            for j in range(i + 1, len(pairs)):
                a, b = pairs[i]
                c, d = pairs[j]
                cur = dist[a, b] + dist[c, d]
                if dist[a, c] + dist[b, d] < cur - 1e-12:
                    pairs[i], pairs[j] = (a, c), (b, d)
                    improved = True
                elif dist[a, d] + dist[b, c] < cur - 1e-12:
                    pairs[i], pairs[j] = (a, d), (b, c)
                    improved = True
    return pairs


def min_weight_perfect_matching(
    dist: np.ndarray, nodes: Optional[List[int]] = None,
    exact_limit: int = 400, max_nodes: int = 2000,
    time_budget: Optional[float] = 30.0, *, device="cuda",
) -> List[Tuple[int, int]]:
    """Minimum-weight perfect matching on the complete graph over
    ``nodes`` (all vertices by default).  Exact through the dedicated
    blossom matcher (graph/blossom.py — the reference's
    graph/perfect_matching.h algorithm) up to ``exact_limit`` vertices;
    greedy + 2-exchange beyond (documented approximation).  The exact
    matcher runs under ``time_budget`` seconds (None = unlimited); on
    timeout the greedy + 2-exchange result is returned instead, so large
    odd-set instances degrade gracefully instead of blocking.  The MIP
    fallback below solves on ``device``."""
    if nodes is None:
        nodes = list(range(dist.shape[0]))
    k = len(nodes)
    assert k % 2 == 0, "perfect matching needs an even vertex count"
    if k == 0:
        return []
    if k == 2:
        return [(nodes[0], nodes[1])]
    greedy = _greedy_perfect(dist, nodes)
    if k > exact_limit:
        return greedy
    from ortools_tpu_torch.graph.blossom import (
        min_weight_perfect_matching_blossom)

    deadline = None
    if time_budget is not None:
        import time

        deadline = time.monotonic() + time_budget
    pairs = min_weight_perfect_matching_blossom(dist, nodes,
                                                deadline=deadline)
    if pairs is not None:
        return pairs
    if deadline is not None:
        import time

        if time.monotonic() > deadline:
            return greedy  # exact matcher timed out
    # unreachable for complete even graphs; MIP fallback below retained
    # as a safety net
    # Exact: binary edge variables, degree-1 equalities.
    from ortools_tpu_torch.mip.branch_and_bound import solve as mip_solve
    from ortools_tpu_torch.models.lp import QuadraticProgram
    from ortools_tpu_torch.utils.device import lp_dtype, resolve_device
    from ortools_tpu_torch.utils.status import MPSolverStatus

    device = resolve_device(device)
    edges = [(i, j) for i in range(k) for j in range(i + 1, k)]
    ne = len(edges)
    w = np.array([dist[nodes[i], nodes[j]] for (i, j) in edges])
    rows, cols, vals = [], [], []
    for e, (i, j) in enumerate(edges):
        rows += [i, j]
        cols += [e, e]
        vals += [1.0, 1.0]
    a = sp.csr_matrix((vals, (rows, cols)), shape=(k, ne))
    qp = QuadraticProgram(
        objective_vector=w,
        constraint_matrix=a,
        constraint_lower=np.ones(k),
        constraint_upper=np.ones(k),
        variable_lower=np.zeros(ne),
        variable_upper=np.ones(ne),
        integrality=np.ones(ne, dtype=bool),
    )
    res = mip_solve(qp, max_nodes=max_nodes, node_batch_size=16,
                    device=device, lp_dtype=lp_dtype(device))
    if res.status not in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE):
        return greedy
    greedy_cost = sum(dist[a_, b_] for a_, b_ in greedy) if greedy else INF
    if res.status != MPSolverStatus.OPTIMAL and \
            res.objective_value >= greedy_cost - 1e-9:
        return greedy
    out = []
    for e, (i, j) in enumerate(edges):
        if res.solution[e] > 0.5:
            out.append((nodes[i], nodes[j]))
    if len(out) != k // 2:
        return greedy
    return out
