"""Synthetic MIPLIB-easy-like instance generators.

Stand-ins for the MIPLIB-easy battery in BASELINE.md (the real set is not
shipped): six structured binary/mixed families at the 100-1000 binary
scale, each with a scipy.optimize.milp (HiGHS) oracle cross-check in the
battery runner.  Families mirror common MIPLIB structure classes: covering,
multi-dimensional knapsack, fixed-charge flow, generalized assignment,
packing, and equality knapsack.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.models.lp import QuadraticProgram


def set_cover(n: int, m: int, density: float = 0.06, seed: int = 0
              ) -> QuadraticProgram:
    """min c.x  s.t.  A x >= 1, x binary."""
    rng = np.random.default_rng(seed)
    a = (rng.random((m, n)) < density).astype(float)
    a[np.arange(m), rng.integers(0, n, m)] = 1.0  # every row coverable
    c = 1.0 + rng.random(n)
    return QuadraticProgram(
        objective_vector=c,
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=np.ones(m),
        constraint_upper=np.full(m, np.inf),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
        name=f"set_cover_{n}x{m}_s{seed}",
    )


def multi_knapsack(n: int, m: int, tightness: float = 0.3, seed: int = 0
                   ) -> QuadraticProgram:
    """max v.x  s.t.  W x <= cap, x binary (m resource dimensions)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(5, 40, size=(m, n)).astype(float)
    cap = tightness * w.sum(axis=1)
    v = w.mean(axis=0) + rng.normal(scale=2.0, size=n)
    return QuadraticProgram(
        objective_vector=v,
        constraint_matrix=sp.csr_matrix(w),
        constraint_lower=np.full(m, -np.inf),
        constraint_upper=cap,
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
        maximize=True,
        name=f"mknap_{n}x{m}_s{seed}",
    )


def fixed_charge(n_arcs: int, seed: int = 0) -> QuadraticProgram:
    """Fixed-charge transportation: continuous flow f_a + binary open y_a,
    f_a <= cap_a * y_a, flow conservation on a bipartite graph."""
    rng = np.random.default_rng(seed)
    ns = max(2, n_arcs // 8)
    nd = max(2, n_arcs // 8)
    src = rng.integers(0, ns, n_arcs)
    dst = rng.integers(0, nd, n_arcs)
    supply = rng.integers(5, 20, ns).astype(float)
    total = supply.sum()
    demand = rng.random(nd)
    demand = np.floor(demand / demand.sum() * total * 0.8)
    cap = rng.integers(5, 25, n_arcs).astype(float)
    cflow = 1.0 + rng.random(n_arcs)
    copen = rng.integers(5, 30, n_arcs).astype(float)
    # variables: [f (n_arcs), y (n_arcs)]
    n = 2 * n_arcs
    rows, cols, vals = [], [], []
    cl, cu = [], []
    r = 0
    for s in range(ns):  # sum_{a out of s} f_a <= supply_s
        arcs = np.nonzero(src == s)[0]
        for a in arcs:
            rows.append(r); cols.append(a); vals.append(1.0)
        cl.append(-np.inf); cu.append(supply[s]); r += 1
    for d in range(nd):  # sum_{a into d} f_a >= demand_d
        arcs = np.nonzero(dst == d)[0]
        for a in arcs:
            rows.append(r); cols.append(a); vals.append(1.0)
        cl.append(demand[d]); cu.append(np.inf); r += 1
    for a in range(n_arcs):  # f_a - cap_a y_a <= 0
        rows.append(r); cols.append(a); vals.append(1.0)
        rows.append(r); cols.append(n_arcs + a); vals.append(-cap[a])
        cl.append(-np.inf); cu.append(0.0); r += 1
    amat = sp.csr_matrix((vals, (rows, cols)), shape=(r, n))
    integ = np.zeros(n, dtype=bool)
    integ[n_arcs:] = True
    return QuadraticProgram(
        objective_vector=np.concatenate([cflow, copen]),
        constraint_matrix=amat,
        constraint_lower=np.array(cl),
        constraint_upper=np.array(cu),
        variable_lower=np.zeros(n),
        variable_upper=np.concatenate([cap, np.ones(n_arcs)]),
        integrality=integ,
        name=f"fixed_charge_{n_arcs}_s{seed}",
    )


def assignment_gap(n_tasks: int, n_agents: int, seed: int = 0
                   ) -> QuadraticProgram:
    """Generalized assignment: each task to exactly one agent, agent
    capacities, minimize cost."""
    rng = np.random.default_rng(seed)
    n = n_tasks * n_agents
    cost = rng.integers(1, 20, size=(n_tasks, n_agents)).astype(float)
    load = rng.integers(3, 12, size=(n_tasks, n_agents)).astype(float)
    cap = np.full(n_agents, load.mean() * n_tasks / n_agents * 1.3)
    rows, cols, vals = [], [], []
    cl, cu = [], []
    r = 0
    for t in range(n_tasks):  # sum_a x[t,a] == 1
        for a in range(n_agents):
            rows.append(r); cols.append(t * n_agents + a); vals.append(1.0)
        cl.append(1.0); cu.append(1.0); r += 1
    for a in range(n_agents):  # sum_t load x[t,a] <= cap_a
        for t in range(n_tasks):
            rows.append(r); cols.append(t * n_agents + a)
            vals.append(load[t, a])
        cl.append(-np.inf); cu.append(cap[a]); r += 1
    amat = sp.csr_matrix((vals, (rows, cols)), shape=(r, n))
    return QuadraticProgram(
        objective_vector=cost.ravel(),
        constraint_matrix=amat,
        constraint_lower=np.array(cl),
        constraint_upper=np.array(cu),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
        name=f"gap_{n_tasks}x{n_agents}_s{seed}",
    )


def edge_packing(n: int, n_edges: int, seed: int = 0) -> QuadraticProgram:
    """max w.x  s.t.  x_i + x_j <= 1 per edge (independent set LP)."""
    rng = np.random.default_rng(seed)
    e = set()
    while len(e) < n_edges:
        i, j = rng.integers(0, n, 2)
        if i != j:
            e.add((min(i, j), max(i, j)))
    e = sorted(e)
    rows, cols, vals = [], [], []
    for r, (i, j) in enumerate(e):
        rows += [r, r]; cols += [i, j]; vals += [1.0, 1.0]
    amat = sp.csr_matrix((vals, (rows, cols)), shape=(len(e), n))
    w = 1.0 + rng.random(n)
    return QuadraticProgram(
        objective_vector=w,
        constraint_matrix=amat,
        constraint_lower=np.full(len(e), -np.inf),
        constraint_upper=np.ones(len(e)),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
        maximize=True,
        name=f"edge_packing_{n}_s{seed}",
    )


def equality_knapsack(n: int, seed: int = 0) -> QuadraticProgram:
    """min c.x  s.t.  w.x == b, x binary (subset-sum flavored)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(5, 50, n).astype(float)
    pick = rng.random(n) < 0.4
    b = float(w[pick].sum())
    c = w + rng.normal(scale=0.5, size=n)
    return QuadraticProgram(
        objective_vector=c,
        constraint_matrix=sp.csr_matrix(w[None, :]),
        constraint_lower=np.array([b]),
        constraint_upper=np.array([b]),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
        name=f"eq_knap_{n}_s{seed}",
    )


def miplib_like_battery(scale: float = 1.0) -> list:
    """The 20-instance battery (BASELINE 'MIPLIB-easy >= 80%' stand-in).

    ``scale`` multiplies instance sizes (1.0 => 100-1000 binaries).
    """
    def s(k):
        return max(2, int(round(k * scale)))

    return [
        set_cover(s(150), s(60), seed=1),
        set_cover(s(250), s(100), seed=2),
        set_cover(s(400), s(150), density=0.04, seed=3),
        multi_knapsack(s(100), 5, seed=4),
        multi_knapsack(s(200), 8, seed=5),
        multi_knapsack(s(300), 10, seed=6),
        fixed_charge(s(60), seed=7),
        fixed_charge(s(100), seed=8),
        fixed_charge(s(150), seed=9),
        assignment_gap(s(20), 5, seed=10),
        assignment_gap(s(30), 8, seed=11),
        assignment_gap(s(40), 10, seed=12),
        edge_packing(s(120), s(400), seed=13),
        edge_packing(s(200), s(800), seed=14),
        edge_packing(s(300), s(1500), seed=15),
        equality_knapsack(s(100), seed=16),
        equality_knapsack(s(200), seed=17),
        set_cover(s(200), s(80), density=0.08, seed=18),
        multi_knapsack(s(150), 6, tightness=0.25, seed=19),
        assignment_gap(s(25), 6, seed=20),
    ]
