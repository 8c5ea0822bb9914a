"""Graph automorphism detection + partition/permutation utilities.

Capability parity:

- ``DynamicPartition`` (reference ``ortools/algorithms/dynamic_partition.h``):
  a partition of [0, n) refinable by subsets, with part indices stable
  across refinements.
- ``SparsePermutation`` (``ortools/algorithms/sparse_permutation.h``):
  a permutation stored as its non-trivial cycles.
- ``GraphSymmetryFinder`` (``ortools/algorithms/find_graph_symmetries.h:45``):
  automorphism-group generators of a colored undirected graph via
  iterated color refinement (1-WL) + individualization backtracking —
  the same refine/individualize skeleton as the reference's nauty-style
  search, without its orbit-pruning sophistication (a node budget bounds
  the search instead).

Used for CP symmetry detection (reference cp_model_symmetries.cc builds a
colored graph of the model and feeds it to this finder).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class SparsePermutation:
    """Permutation of [0, n) stored as non-trivial cycles."""

    def __init__(self, n: int, cycles: Optional[List[List[int]]] = None):
        self.size = n
        self.cycles: List[List[int]] = cycles or []

    @staticmethod
    def from_mapping(perm: Sequence[int]) -> "SparsePermutation":
        n = len(perm)
        seen = [False] * n
        cycles = []
        for s in range(n):
            if seen[s] or perm[s] == s:
                seen[s] = True
                continue
            cyc = []
            j = s
            while not seen[j]:
                seen[j] = True
                cyc.append(j)
                j = perm[j]
            if len(cyc) > 1:
                cycles.append(cyc)
        return SparsePermutation(n, cycles)

    def to_mapping(self) -> List[int]:
        out = list(range(self.size))
        for cyc in self.cycles:
            for i, v in enumerate(cyc):
                out[v] = cyc[(i + 1) % len(cyc)]
        return out

    def apply(self, i: int) -> int:
        for cyc in self.cycles:
            if i in cyc:
                return cyc[(cyc.index(i) + 1) % len(cyc)]
        return i

    def is_identity(self) -> bool:
        return not self.cycles

    def support(self) -> List[int]:
        return [v for cyc in self.cycles for v in cyc]


class DynamicPartition:
    """Partition of [0, n) with subset refinement.

    ``refine(subset)`` splits every part P into (P ∩ subset, P \\ subset);
    the intersection keeps the original part index when the whole part is
    inside, otherwise the remainder keeps it and the intersection gets a
    fresh index (reference semantics: stable part numbering)."""

    def __init__(self, n: int):
        self.n = n
        self.part_of = [0] * n
        self.parts: List[List[int]] = [list(range(n))] if n else []

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    def part(self, p: int) -> List[int]:
        return list(self.parts[p])

    def refine(self, subset: Iterable[int]) -> List[int]:
        """Split parts by the subset; returns the new part indices."""
        subset = set(subset)
        touched: Dict[int, List[int]] = {}
        for v in subset:
            touched.setdefault(self.part_of[v], []).append(v)
        new_parts = []
        for p, inside in touched.items():
            if len(inside) == len(self.parts[p]):
                continue  # whole part inside: no split
            inside_set = set(inside)
            outside = [v for v in self.parts[p] if v not in inside_set]
            self.parts[p] = outside
            q = len(self.parts)
            self.parts.append(sorted(inside))
            for v in inside:
                self.part_of[v] = q
            new_parts.append(q)
        return new_parts

    def as_colors(self) -> List[int]:
        return list(self.part_of)


def _refine_colors(adj: List[List[int]], colors: List[int]) -> List[int]:
    """1-WL color refinement to a fix point; colors canonicalized to
    dense ints ordered by (old color, signature)."""
    n = len(adj)
    colors = list(colors)
    for _ in range(n + 1):
        sigs = []
        for v in range(n):
            neigh = sorted(colors[u] for u in adj[v])
            sigs.append((colors[v], tuple(neigh)))
        remap: Dict[Tuple, int] = {}
        new_colors = []
        for s in sorted(set(sigs)):
            remap[s] = len(remap)
        for v in range(n):
            new_colors.append(remap[sigs[v]])
        if new_colors == colors:
            break
        colors = new_colors
    return colors


class GraphSymmetryFinder:
    """Automorphism generators of a colored undirected graph."""

    def __init__(self, num_nodes: int,
                 edges: Iterable[Tuple[int, int]],
                 node_colors: Optional[Sequence[int]] = None,
                 node_budget: int = 20_000):
        self.n = num_nodes
        self.adj: List[List[int]] = [[] for _ in range(num_nodes)]
        self.edge_set = set()
        for (u, v) in edges:
            if (u, v) in self.edge_set or (v, u) in self.edge_set:
                continue
            self.edge_set.add((u, v))
            self.adj[u].append(v)
            self.adj[v].append(u)
        self.colors0 = list(node_colors) if node_colors is not None \
            else [0] * num_nodes
        self.node_budget = node_budget

    # -- automorphism validity -------------------------------------------
    def _is_automorphism(self, perm: List[int]) -> bool:
        if any(self.colors0[perm[v]] != self.colors0[v]
               for v in range(self.n)):
            return False
        for (u, v) in self.edge_set:
            pu, pv = perm[u], perm[v]
            if (pu, pv) not in self.edge_set and \
                    (pv, pu) not in self.edge_set:
                return False
        return True

    def find_generators(self) -> List[SparsePermutation]:
        """Return a generating set (possibly overcomplete) of Aut(G)."""
        base_colors = _refine_colors(self.adj, self.colors0)
        gens: List[SparsePermutation] = []
        budget = [self.node_budget]

        # For each non-singleton refined cell, try to map its first
        # element to each other element; a successful completion is an
        # automorphism generator (individualization-refinement search).
        cells: Dict[int, List[int]] = {}
        for v in range(self.n):
            cells.setdefault(base_colors[v], []).append(v)
        for cell in cells.values():
            if len(cell) < 2:
                continue
            v0 = cell[0]
            for w in cell[1:]:
                perm = self._search_mapping(base_colors, v0, w, budget)
                if perm is not None:
                    sp_perm = SparsePermutation.from_mapping(perm)
                    if not sp_perm.is_identity():
                        gens.append(sp_perm)
                if budget[0] <= 0:
                    return gens
        return gens

    def _search_mapping(self, colors: List[int], v0: int, w0: int,
                        budget: List[int]) -> Optional[List[int]]:
        """Find ANY automorphism with perm[v0] = w0 by backtracking over
        color-consistent assignments (most-constrained vertex first)."""
        n = self.n
        perm: List[int] = [-1] * n
        used = [False] * n

        def candidates(v: int) -> List[int]:
            out = []
            for u in range(n):
                if used[u] or colors[u] != colors[v]:
                    continue
                ok = True
                for x in self.adj[v]:
                    if perm[x] >= 0:
                        pu = perm[x]
                        if (u, pu) not in self.edge_set and \
                                (pu, u) not in self.edge_set:
                            ok = False
                            break
                if ok:
                    out.append(u)
            return out

        def assign(v: int, u: int) -> None:
            perm[v] = u
            used[u] = True

        def unassign(v: int) -> None:
            used[perm[v]] = False
            perm[v] = -1

        def pick() -> Optional[int]:
            best, best_n = None, None
            for v in range(n):
                if perm[v] >= 0:
                    continue
                k = sum(1 for x in self.adj[v] if perm[x] >= 0)
                key = (-k, len(self.adj[v]))
                if best is None or key < best_n:
                    best, best_n = v, key
            return best

        # Iterative backtracking (an explicit frame stack — graphs from
        # CP models reach thousands of nodes, past Python's recursion
        # limit).  A frame's vertex is assigned while any deeper frame is
        # live and unassigned when its next candidate is tried.
        assign(v0, w0)
        first = pick()
        if first is None:
            return perm if self._is_automorphism(perm) else None
        frames: List[List] = [[first, candidates(first), 0]]
        while frames:
            budget[0] -= 1
            if budget[0] <= 0:
                return None
            top = frames[-1]
            v, cands, idx = top
            if idx > 0:
                unassign(v)
            if idx >= len(cands):
                frames.pop()
                continue
            top[2] = idx + 1
            assign(v, cands[idx])
            nv = pick()
            if nv is None:
                if self._is_automorphism(perm):
                    return perm
                continue  # same frame: next candidate after unassign
            frames.append([nv, candidates(nv), 0])
        return None
