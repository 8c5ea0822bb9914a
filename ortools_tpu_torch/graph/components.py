"""Connectivity, ordering and spanning structures.

Capability parity: ``ortools/graph`` —
strongly_connected_components.h (Tarjan), connected_components,
topologicalsorter, minimum_spanning_tree.h, eulerian_path.h,
cliques.{h,cc} (Bron-Kerbosch).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


def strongly_connected_components(
    num_nodes: int, arcs: Sequence[Tuple[int, int]]
) -> List[List[int]]:
    """Tarjan's SCC (iterative).  Returns components in reverse
    topological order (like the reference's visitor)."""
    adj: List[List[int]] = [[] for _ in range(num_nodes)]
    for t, h in arcs:
        adj[t].append(h)
    index = [0] * num_nodes
    low = [0] * num_nodes
    on_stack = [False] * num_nodes
    visited = [False] * num_nodes
    stack: List[int] = []
    comps: List[List[int]] = []
    counter = [1]

    for root in range(num_nodes):
        if visited[root]:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                visited[v] = True
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for k in range(pi, len(adj[v])):
                w = adj[v][k]
                if not visited[w]:
                    work[-1] = (v, k + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            work.pop()
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                comps.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return comps


def connected_components(
    num_nodes: int, edges: Sequence[Tuple[int, int]]
) -> List[int]:
    """Union-find; returns component id per node (0-based, dense)."""
    parent = list(range(num_nodes))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    remap: Dict[int, int] = {}
    out = []
    for v in range(num_nodes):
        r = find(v)
        if r not in remap:
            remap[r] = len(remap)
        out.append(remap[r])
    return out


class TopologicalSorter:
    """Parity: ortools/base topologicalsorter — incremental API."""

    def __init__(self) -> None:
        self._succ: Dict[object, List[object]] = {}
        self._nodes: List[object] = []

    def add_node(self, node) -> None:
        if node not in self._succ:
            self._succ[node] = []
            self._nodes.append(node)

    def add_edge(self, a, b) -> None:
        self.add_node(a)
        self.add_node(b)
        self._succ[a].append(b)

    def sort(self) -> Optional[List[object]]:
        """Topological order, or None if a cycle exists."""
        indeg: Dict[object, int] = {n: 0 for n in self._nodes}
        for a, outs in self._succ.items():
            for b in outs:
                indeg[b] += 1
        ready = [n for n in self._nodes if indeg[n] == 0]
        out = []
        while ready:
            n = ready.pop()
            out.append(n)
            for b in self._succ[n]:
                indeg[b] -= 1
                if indeg[b] == 0:
                    ready.append(b)
        return out if len(out) == len(self._nodes) else None


def minimum_spanning_tree(
    num_nodes: int, edges: Sequence[Tuple[int, int, float]]
) -> List[int]:
    """Kruskal; returns indices of chosen edges (forest if disconnected)."""
    order = sorted(range(len(edges)), key=lambda i: edges[i][2])
    parent = list(range(num_nodes))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    chosen = []
    for i in order:
        a, b, _ = edges[i]
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            chosen.append(i)
    return chosen


def eulerian_path(
    num_nodes: int, edges: Sequence[Tuple[int, int]]
) -> Optional[List[int]]:
    """Undirected Eulerian path/circuit (Hierholzer), or None."""
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(num_nodes)]
    for k, (a, b) in enumerate(edges):
        adj[a].append((b, k))
        adj[b].append((a, k))
    odd = [v for v in range(num_nodes) if len(adj[v]) % 2 == 1]
    if len(odd) not in (0, 2):
        return None
    m = len(edges)
    if m == 0:
        return []
    start = odd[0] if odd else next(
        v for v in range(num_nodes) if adj[v]
    )
    used = [False] * m
    ptr = [0] * num_nodes
    stack = [start]
    path: List[int] = []
    while stack:
        v = stack[-1]
        advanced = False
        while ptr[v] < len(adj[v]):
            w, k = adj[v][ptr[v]]
            ptr[v] += 1
            if not used[k]:
                used[k] = True
                stack.append(w)
                advanced = True
                break
        if not advanced:
            path.append(stack.pop())
    if len(path) != m + 1:
        return None  # disconnected edges
    return path[::-1]


def bron_kerbosch_cliques(
    num_nodes: int, edges: Sequence[Tuple[int, int]],
    callback: Optional[Callable[[List[int]], bool]] = None,
) -> List[List[int]]:
    """All maximal cliques (with pivoting).  callback may return False to
    stop early (reference cliques.h visitor style)."""
    neigh: List[set] = [set() for _ in range(num_nodes)]
    for a, b in edges:
        if a != b:
            neigh[a].add(b)
            neigh[b].add(a)
    out: List[List[int]] = []
    stop = [False]

    def expand(r: set, p: set, x: set) -> None:
        if stop[0]:
            return
        if not p and not x:
            clique = sorted(r)
            out.append(clique)
            if callback is not None and callback(clique) is False:
                stop[0] = True
            return
        pivot = max(p | x, key=lambda v: len(neigh[v] & p))
        for v in list(p - neigh[pivot]):
            expand(r | {v}, p & neigh[v], x & neigh[v])
            p.discard(v)
            x.add(v)

    expand(set(), set(range(num_nodes)), set())
    return out
