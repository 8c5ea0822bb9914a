"""Fixed-charge capacitated multicommodity network design, class C: the
instances of Crainic, Gendreau and Farvolden (INFORMS J. Computing 12,
2000) that Crainic, Frangioni and Gendron (Discrete Appl. Math. 112, 2001)
solve, named ``|N|,|A|,|K|`` with F/V (high or low fixed costs) and T/L
(tight or loose capacities).

The design has arcs a with a variable cost c_a a unit of flow, a fixed cost
f_a and a capacity u_a, and commodities k with a demand d_k from an origin
to a destination.  Columns are the flows x[k, a] (``k * A + a``), then, in
the ``relaxation`` form, the designs y[a] (``K * A + a``).  Rows are the
conservation equalities of each commodity (``k * N + v``), the arc
capacities sum_k x[k, a] <= u_a y_a (``K * N + a``) and, in the
``relaxation`` form, the strong forcing rows x[k, a] <= min(d_k, u_a) y_a
(``K * N + A + k * A + a``).  Flows lie in [0, min(d_k, u_a)], designs in
[0, 1]: the strong LP relaxation, whose node LPs close an arc by y_a <= 0.
The ``all_open`` form is the multicommodity min-cost flow with every arc
open (y = 1): capacities u_a, no designs, no forcing rows.

The published files are not in the repository: the instance is drawn at its
published |N|, |A|, |K| from ``seed`` with the distributions the
configuration states (a directed Hamiltonian cycle, then distinct random
arcs; distinct origin-destination pairs; uniform demands, costs, fixed
costs, and capacities in multiples of the mean demand).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from reference.lp import Instance


def make(num_nodes: int, num_arcs: int, num_commodities: int, form: str,
         demand: Sequence[float], cost: Sequence[float],
         fixed_cost: Sequence[float], capacity: Sequence[float],
         seed: int, label: str = "") -> Instance:
    N, A, K = num_nodes, num_arcs, num_commodities
    if form not in ("relaxation", "all_open"):
        raise ValueError(f"form {form!r}")
    rng = np.random.default_rng(seed)
    cycle = rng.permutation(N)
    pairs = cycle * N + np.roll(cycle, -1)
    others = np.setdiff1d(np.arange(N * N), np.concatenate(
        [pairs, np.arange(N) * (N + 1)]))
    pairs = np.sort(np.concatenate(
        [pairs, rng.choice(others, size=A - N, replace=False)]))
    tails, heads = pairs // N, pairs % N
    od = rng.choice(np.setdiff1d(np.arange(N * N), np.arange(N) * (N + 1)),
                    size=K, replace=False)
    src, dst = od // N, od % N
    d = rng.uniform(*demand, size=K)
    c = rng.uniform(*cost, size=A)
    f = rng.uniform(*fixed_cost, size=A)
    u = rng.uniform(*capacity, size=A) * d.mean()

    relax = form == "relaxation"
    nx = K * A
    n = nx + (A if relax else 0)
    xcol = (np.arange(K)[:, None] * A + np.arange(A)[None, :])  # [K, A]
    rows, cols, vals = [], [], []
    # conservation: out of v minus into v
    rows += [(np.arange(K)[:, None] * N + tails[None, :]).ravel(),
             (np.arange(K)[:, None] * N + heads[None, :]).ravel()]
    cols += [xcol.ravel(), xcol.ravel()]
    vals += [np.ones(nx), -np.ones(nx)]
    # capacities
    cap_row = K * N + np.arange(A)
    rows.append(np.broadcast_to(cap_row, (K, A)).ravel())
    cols.append(xcol.ravel())
    vals.append(np.ones(nx))
    x_hi = np.minimum(d[:, None], u[None, :])  # [K, A]
    if relax:
        ycol = nx + np.arange(A)
        rows.append(cap_row)
        cols.append(ycol)
        vals.append(-u)
        force_row = K * N + A + xcol
        rows += [force_row.ravel(), force_row.ravel()]
        cols += [xcol.ravel(), np.broadcast_to(ycol, (K, A)).ravel()]
        vals += [np.ones(nx), -x_hi.ravel()]
    m = K * N + A + (nx if relax else 0)
    b = np.zeros(K * N)
    b[np.arange(K) * N + src] = d
    b[np.arange(K) * N + dst] = -d
    con_hi = np.concatenate([b, np.zeros(m - K * N) if relax else u])
    con_lo = np.concatenate([b, np.full(m - K * N, -np.inf)])
    obj = np.concatenate([np.broadcast_to(c, (K, A)).ravel(),
                          f if relax else np.zeros(0)])
    var_hi = np.concatenate([x_hi.ravel(), np.ones(A) if relax else np.zeros(0)])
    return Instance(
        m=m, n=n,
        rows=np.concatenate(rows).astype(np.int64),
        cols=np.concatenate(cols).astype(np.int64),
        vals=np.concatenate(vals).astype(np.float64),
        c=obj, con_lo=con_lo, con_hi=con_hi,
        var_lo=np.zeros(n), var_hi=var_hi,
        name=f"{label or f'{N},{A},{K}'} {form}",
        branch_columns=(nx + np.arange(A)) if relax else np.zeros(0, np.int64),
        data=dict(N=N, A=A, K=K, tails=tails, heads=heads, src=src, dst=dst,
                  demand=d, capacity=u, relax=relax),
    )


def _path(data: dict, usable: np.ndarray, s: int, t: int):
    """Arcs of a fewest-arcs path from ``s`` to ``t`` over the ``usable``
    arcs, or None: a breadth-first search, one level at a time."""
    tails, heads, N = data["tails"], data["heads"], data["N"]
    pred = np.full(N, -1, dtype=np.int64)
    seen = np.zeros(N, dtype=bool)
    seen[s] = True
    frontier = seen.copy()
    while not seen[t]:
        step = usable & frontier[tails] & ~seen[heads]
        if not step.any():
            return None
        arcs = np.nonzero(step)[0]
        hs, first = np.unique(heads[arcs], return_index=True)
        pred[hs] = arcs[first]
        seen[hs] = True
        frontier[:] = False
        frontier[hs] = True
    path, v = [], t
    while v != s:
        path.append(pred[v])
        v = tails[pred[v]]
    return np.asarray(path[::-1], dtype=np.int64)


def certificate(inst: Instance, closed=()):
    """A point that meets every row and bound of ``inst`` with the arcs
    ``closed`` (indices into ``branch_columns``) shut, or None where the
    greedy routing finds none: each commodity, largest demand first, goes
    whole on a fewest-arcs path through open arcs with room for it, and
    every open arc gets y = 1.  None proves nothing; a point proves the
    LP (or the node) feasible."""
    data = inst.data
    A, K = data["A"], data["K"]
    room = data["capacity"].copy()
    usable_arc = np.ones(A, dtype=bool)
    usable_arc[np.asarray(closed, dtype=np.int64)] = False
    x = np.zeros(inst.n)
    for k in np.argsort(-data["demand"], kind="stable"):
        dk = data["demand"][k]
        path = _path(data, usable_arc & (room >= dk * (1.0 + 1e-9)),
                     data["src"][k], data["dst"][k])
        if path is None:
            return None
        room[path] -= dk
        x[k * A + path] = dk
    if data["relax"]:
        x[K * A:] = usable_arc.astype(np.float64)
    return x
