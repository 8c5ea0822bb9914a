"""Maximum-weight general matching via Edmonds' blossom algorithm with
primal-dual blossom duals.

Capability parity: ``ortools/graph/perfect_matching.{h,cc}``
(BlossomGraph / MinCostPerfectMatching — an O(n^3) implementation of
Edmonds' algorithm).  This is an independent implementation of the same
classic algorithm following Galil's exposition ("Efficient algorithms for
finding maximum matching in graphs", ACM Computing Surveys 1986): an
alternating S/T forest over top-level blossoms, zero-slack edge scanning,
blossom shrink/expand, and the four-way dual update (delta1..delta4).

The per-stage scan omits the best-edge caching optimization of the
literature (each dual update rescans the edge list), giving O(n * m * n)
worst-case — ample for the dense Christofides odd-set instances this
backs (hundreds of vertices).

Weights may be float; integers stay exact throughout because duals are
maintained in half-units (internally doubled).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

_NO = -1


def max_weight_matching(n: int,
                        edges: Sequence[Tuple[int, int, float]],
                        max_cardinality: bool = False,
                        deadline: Optional[float] = None,
                        ) -> Optional[List[int]]:
    """Returns mate[] (length n, -1 = unmatched) maximizing total weight;
    with ``max_cardinality`` the matching is a maximum-cardinality one of
    maximum weight (the mode perfect matching rides on).

    ``deadline`` is an absolute ``time.monotonic()`` instant; when it
    passes (checked once per dual update) the search stops and returns
    ``None`` so callers can fall back to a heuristic matcher."""
    if n == 0 or not edges:
        return [_NO] * n

    nedge = len(edges)
    # doubled weights keep all slack arithmetic integral for int inputs
    wt = [2 * e[2] for e in edges]
    endpoint = []  # endpoint[2k] = i, endpoint[2k+1] = j of edge k
    for (i, j, _) in edges:
        assert 0 <= i < n and 0 <= j < n and i != j
        endpoint.append(i)
        endpoint.append(j)
    neighbend: List[List[int]] = [[] for _ in range(n)]
    for k in range(nedge):
        i, j = endpoint[2 * k], endpoint[2 * k + 1]
        neighbend[i].append(2 * k + 1)
        neighbend[j].append(2 * k)

    # max(0, maxweight): with all-negative weights the optimal non-max-
    # cardinality matching is empty; an unclamped negative seed dual would
    # admit weight-decreasing augmentations.
    maxw = max(max(wt), 0)
    # duals: vertices 0..n-1, blossoms n..2n-1
    dualvar = [maxw] * n + [0] * n
    mate = [_NO] * n          # mate[v] = remote endpoint index, or -1
    label = [0] * (2 * n)     # per top-level blossom: 0 free, 1 S, 2 T
    labelend = [_NO] * (2 * n)
    inblossom = list(range(n))
    blossomparent = [_NO] * (2 * n)
    blossomchilds: List[Optional[List[int]]] = [None] * (2 * n)
    blossombase = list(range(n)) + [_NO] * n
    blossomendps: List[Optional[List[int]]] = [None] * (2 * n)
    allowedge = [False] * nedge
    queue: List[int] = []

    def slack(k: int) -> float:
        i, j = endpoint[2 * k], endpoint[2 * k + 1]
        return dualvar[i] + dualvar[j] - wt[k]

    def blossom_leaves(b: int):
        if b < n:
            yield b
        else:
            for t in blossomchilds[b]:  # type: ignore[union-attr]
                if t < n:
                    yield t
                else:
                    yield from blossom_leaves(t)

    def assign_label(w: int, t: int, p: int) -> None:
        b = inblossom[w]
        label[w] = label[b] = t
        labelend[w] = labelend[b] = p
        if t == 1:  # S: scan its vertices
            queue.extend(blossom_leaves(b))
        elif t == 2:  # T: its base's mate becomes S
            base = blossombase[b]
            assign_label(endpoint[mate[base]], 1, mate[base] ^ 1)

    def scan_blossom(v: int, w: int) -> int:
        """Trace back from v and w to find a common ancestor blossom base
        (a new blossom) or -1 (augmenting path found)."""
        path = []
        base = _NO
        while v != _NO or w != _NO:
            b = inblossom[v]
            if label[b] & 4:
                base = blossombase[b]
                break
            path.append(b)
            label[b] |= 4
            if mate[blossombase[b]] == _NO:
                v = _NO
            else:
                v = endpoint[mate[blossombase[b]]]
                b = inblossom[v]
                v = endpoint[labelend[b]]
            if w != _NO:
                v, w = w, v
        for b in path:
            label[b] &= ~4
        return base

    def add_blossom(base: int, k: int) -> None:
        v, w = endpoint[2 * k], endpoint[2 * k + 1]
        bb = inblossom[base]
        bv = inblossom[v]
        bw = inblossom[w]
        b = blossombase.index(_NO, n)  # first unused blossom slot
        blossombase[b] = base
        blossomparent[b] = _NO
        blossomparent[bb] = b
        path: List[int] = []
        endps: List[int] = []
        while bv != bb:
            blossomparent[bv] = b
            path.append(bv)
            endps.append(labelend[bv])
            v = endpoint[labelend[bv]]
            bv = inblossom[v]
        path.append(bb)
        path.reverse()
        endps.reverse()
        endps.append(2 * k)
        while bw != bb:
            blossomparent[bw] = b
            path.append(bw)
            endps.append(labelend[bw] ^ 1)
            w = endpoint[labelend[bw]]
            bw = inblossom[w]
        blossomchilds[b] = path
        blossomendps[b] = endps
        label[b] = 1
        labelend[b] = labelend[bb]
        dualvar[b] = 0
        for leaf in blossom_leaves(b):
            if label[inblossom[leaf]] == 2:
                queue.append(leaf)
            inblossom[leaf] = b

    def expand_blossom(b: int, endstage: bool) -> None:
        for s in blossomchilds[b]:  # type: ignore[union-attr]
            blossomparent[s] = _NO
            if s < n:
                inblossom[s] = s
            elif endstage and dualvar[s] == 0:
                expand_blossom(s, endstage)
            else:
                for leaf in blossom_leaves(s):
                    inblossom[leaf] = s
        if (not endstage) and label[b] == 2:
            # relabel the T-blossom's children along the path from the
            # entry child to the base
            entrychild = inblossom[endpoint[labelend[b] ^ 1]]
            childs = blossomchilds[b]  # type: ignore[assignment]
            endps = blossomendps[b]  # type: ignore[assignment]
            j = childs.index(entrychild)
            if j & 1:  # odd: go forward around
                j -= len(childs)
                jstep = 1
                endptrick = 0
            else:
                jstep = -1
                endptrick = 1
            p = labelend[b]
            while j != 0:
                label[endpoint[p ^ 1]] = 0
                label[endpoint[endps[j - endptrick] ^ endptrick ^ 1]] = 0
                assign_label(endpoint[p ^ 1], 2, p)
                allowedge[endps[j - endptrick] // 2] = True
                j += jstep
                p = endps[j - endptrick] ^ endptrick
                allowedge[p // 2] = True
                j += jstep
            bv = childs[j]
            label[endpoint[p ^ 1]] = label[bv] = 2
            labelend[endpoint[p ^ 1]] = labelend[bv] = p
            j += jstep
            while childs[j % len(childs)] != entrychild:
                bv = childs[j % len(childs)]
                if label[bv] == 1:
                    j += jstep
                    continue
                for leaf in blossom_leaves(bv):
                    if label[leaf] != 0:
                        v = leaf
                        break
                else:
                    v = _NO
                if v != _NO:
                    label[v] = 0
                    label[endpoint[mate[blossombase[bv]]]] = 0
                    assign_label(v, 2, labelend[v])
                j += jstep
        label[b] = labelend[b] = _NO
        blossomchilds[b] = blossomendps[b] = None
        blossombase[b] = _NO

    def augment_blossom(b: int, v: int) -> None:
        t = v
        while blossomparent[t] != b:
            t = blossomparent[t]
        if t >= n:
            augment_blossom(t, v)
        childs = blossomchilds[b]  # type: ignore[assignment]
        endps = blossomendps[b]  # type: ignore[assignment]
        i = j = childs.index(t)
        if i & 1:
            j -= len(childs)
            jstep = 1
            endptrick = 0
        else:
            jstep = -1
            endptrick = 1
        while j != 0:
            j += jstep
            t = childs[j % len(childs)]
            p = endps[j - endptrick] ^ endptrick
            if t >= n:
                augment_blossom(t, endpoint[p])
            j += jstep
            t = childs[j % len(childs)]
            if t >= n:
                augment_blossom(t, endpoint[p ^ 1])
            mate[endpoint[p]] = p ^ 1
            mate[endpoint[p ^ 1]] = p
        blossomchilds[b] = childs[i:] + childs[:i]
        blossomendps[b] = endps[i:] + endps[:i]
        blossombase[b] = blossombase[blossomchilds[b][0]]

    def augment_matching(k: int) -> None:
        v, w = endpoint[2 * k], endpoint[2 * k + 1]
        for (s, p) in ((v, 2 * k + 1), (w, 2 * k)):
            while True:
                bs = inblossom[s]
                if bs >= n:
                    augment_blossom(bs, s)
                mate[s] = p
                if labelend[bs] == _NO:
                    break
                t = endpoint[labelend[bs]]
                bt = inblossom[t]
                s = endpoint[labelend[bt]]
                j2 = endpoint[labelend[bt] ^ 1]
                if bt >= n:
                    augment_blossom(bt, j2)
                mate[j2] = labelend[bt]
                p = labelend[bt] ^ 1

    for _stage in range(n):
        label[:] = [0] * (2 * n)
        allowedge[:] = [False] * nedge
        queue[:] = []
        for v in range(n):
            if mate[v] == _NO and label[inblossom[v]] == 0:
                assign_label(v, 1, _NO)
        augmented = False
        while True:
            while queue and not augmented:
                v = queue.pop()
                for p in neighbend[v]:
                    k = p // 2
                    w = endpoint[p]
                    if inblossom[v] == inblossom[w]:
                        continue
                    if not allowedge[k]:
                        kslack = slack(k)
                        if kslack <= 0:
                            allowedge[k] = True
                    if allowedge[k]:
                        bw = inblossom[w]
                        if label[bw] == 0:
                            assign_label(w, 2, p ^ 1)
                        elif label[bw] == 1:
                            base = scan_blossom(v, w)
                            if base >= 0:
                                add_blossom(base, k)
                            else:
                                augment_matching(k)
                                augmented = True
                                break
                        elif label[w] == 0:
                            label[w] = 2
                            labelend[w] = p ^ 1
            if augmented:
                break
            if deadline is not None:
                import time

                if time.monotonic() > deadline:
                    return None
            # dual update
            deltatype = -1
            delta = deltaedge = deltablossom = None
            if not max_cardinality:
                deltatype = 1
                delta = min(dualvar[:n])
            for k in range(nedge):
                i, j = endpoint[2 * k], endpoint[2 * k + 1]
                bi, bj = inblossom[i], inblossom[j]
                if bi == bj:
                    continue
                li, lj = label[bi], label[bj]
                if li == 1 and lj == 1:
                    d = slack(k) / 2
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 3
                        deltaedge = k
                elif (li == 1 and lj == 0) or (lj == 1 and li == 0):
                    d = slack(k)
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 2
                        deltaedge = k
            for b in range(n, 2 * n):
                if (blossombase[b] >= 0 and blossomparent[b] == _NO
                        and label[b] == 2):
                    d = dualvar[b]
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 4
                        deltablossom = b
            if deltatype == -1:
                # no further progress possible (max-cardinality mode)
                deltatype = 1
                delta = max(0, min(dualvar[:n]))
            for v in range(n):
                lb = label[inblossom[v]]
                if lb == 1:
                    dualvar[v] -= delta
                elif lb == 2:
                    dualvar[v] += delta
            for b in range(n, 2 * n):
                if blossombase[b] >= 0 and blossomparent[b] == _NO:
                    if label[b] == 1:
                        dualvar[b] += 2 * delta
                    elif label[b] == 2:
                        dualvar[b] -= 2 * delta
            if deltatype == 1:
                break  # optimum reached
            elif deltatype == 2:
                allowedge[deltaedge] = True
                i = endpoint[2 * deltaedge]
                if label[inblossom[i]] == 0:
                    i = endpoint[2 * deltaedge + 1]
                queue.append(i)
            elif deltatype == 3:
                allowedge[deltaedge] = True
                queue.append(endpoint[2 * deltaedge])
            else:
                expand_blossom(deltablossom, False)
        if not augmented:
            break
        # end of stage: expand all blossoms with zero dual
        for b in range(n, 2 * n):
            if (blossombase[b] >= 0 and blossomparent[b] == _NO
                    and label[b] == 1 and dualvar[b] == 0):
                expand_blossom(b, True)

    out = [_NO] * n
    for v in range(n):
        if mate[v] != _NO:
            out[v] = endpoint[mate[v]]
    return out


def min_weight_perfect_matching_blossom(
        dist, nodes: Sequence[int],
        deadline: Optional[float] = None,
) -> Optional[List[Tuple[int, int]]]:
    """Minimum-weight PERFECT matching on the complete graph over
    ``nodes`` through the blossom matcher: negate weights, shift to
    non-negative, run in max-cardinality mode.  Returns None when
    |nodes| is odd or the ``deadline`` (time.monotonic instant) passes."""
    k = len(nodes)
    if k % 2:
        return None
    if k == 0:
        return []
    import numpy as np

    sub = np.asarray(dist)[np.ix_(nodes, nodes)]
    maxd = float(sub.max())
    edges = [(i, j, maxd - float(sub[i, j]) + 1.0)
             for i in range(k) for j in range(i + 1, k)]
    mate = max_weight_matching(k, edges, max_cardinality=True,
                               deadline=deadline)
    if mate is None:
        return None
    pairs = []
    for i in range(k):
        j = mate[i]
        if j == _NO or j < i:
            continue
        pairs.append((nodes[i], nodes[j]))
    if len(pairs) != k // 2:
        return None  # complete even graph: should not happen
    return pairs
