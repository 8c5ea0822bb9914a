"""The port's graph algorithms (``ortools_tpu_torch/graph/``) against the
JAX package's, on the CPU.

- The copies' text: ``max_flow.py``, ``min_cost_flow.py``,
  ``shortest_paths.py``, ``assignment.py`` and ``components.py`` equal the
  JAX package's apart from import lines, ``tsp_paths.py`` apart from import
  lines and lines that name ``device``, and ``_native/graph.cc`` byte for
  byte.
- Max flow, min cost flow (with its statuses), assignment, Dijkstra and
  Bellman-Ford on seeded instances: every flow, cost, mate and distance
  equal to the JAX package's (both are exact integer or float algorithms
  on one native source).
- Components, MST, Eulerian paths, cliques, Held-Karp, the 1-tree bound
  and Christofides equal to the JAX package's; Christofides again with the
  blossom matcher patched to give up in both packages, so that matching's
  MIP fallback runs (on ``device="cpu"`` in the port).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.graph import assignment as JA
from ortools_tpu.graph import blossom as JB
from ortools_tpu.graph import components as JC
from ortools_tpu.graph import max_flow as JMF
from ortools_tpu.graph import min_cost_flow as JMCF
from ortools_tpu.graph import shortest_paths as JSP
from ortools_tpu.graph import tsp_paths as JT

import ortools_tpu_torch.graph as TG
from ortools_tpu_torch.graph import assignment as TA
from ortools_tpu_torch.graph import blossom as TB
from ortools_tpu_torch.graph import components as TC
from ortools_tpu_torch.graph import max_flow as TMF
from ortools_tpu_torch.graph import min_cost_flow as TMCF
from ortools_tpu_torch.graph import shortest_paths as TSP
from ortools_tpu_torch.graph import tsp_paths as TT

from tests.test_torch_cp_sat_parts import assert_device_diff
from tests.test_torch_mip_host import ROOT, assert_copy_text

torch.set_num_threads(1)

COPIES = ["graph/max_flow.py", "graph/min_cost_flow.py",
          "graph/shortest_paths.py", "graph/assignment.py",
          "graph/components.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equals_the_original_apart_from_imports(rel):
    assert_copy_text(rel)


def test_tsp_paths_differs_only_in_imports_and_device():
    assert_device_diff("graph/tsp_paths.py")


def test_graph_core_is_a_byte_copy():
    rel = "_native/graph.cc"
    assert ((ROOT / "ortools_tpu_torch" / rel).read_bytes()
            == (ROOT / "ortools_tpu" / rel).read_bytes())


def test_package_exports_the_jax_packages_names():
    import ortools_tpu.graph as JG
    for name in ("SimpleMaxFlow", "SimpleMinCostFlow",
                 "dijkstra_shortest_path", "LinearSumAssignment"):
        assert getattr(JG, name).__name__ == getattr(TG, name).__name__
    assert TG.SimpleMaxFlow is TMF.SimpleMaxFlow
    assert TG.LinearSumAssignment is TA.LinearSumAssignment


# ---------------------------------------------------------------------------
# Flows, assignment, shortest paths
# ---------------------------------------------------------------------------


def _arcs(seed, n, m, cap_hi=50, cost_hi=None):
    rng = np.random.default_rng(seed)
    tails = rng.integers(0, n, m)
    heads = (tails + 1 + rng.integers(0, n - 1, m)) % n
    caps = rng.integers(0, cap_hi, m)
    costs = rng.integers(0, cost_hi, m) if cost_hi else None
    return tails, heads, caps, costs


def _max_flow(mod, tails, heads, caps, s, t):
    mf = mod.SimpleMaxFlow()
    for a, b, c in zip(tails, heads, caps):
        mf.add_arc_with_capacity(int(a), int(b), int(c))
    st = mf.solve(s, t)
    return (st.name, mf.optimal_flow(), mf.num_nodes, mf.num_arcs,
            [mf.flow(a) for a in range(mf.num_arcs)])


@pytest.mark.parametrize("seed", range(6))
def test_max_flow_equals_jax(seed):
    n, m = 40 + 10 * seed, 300
    tails, heads, caps, _ = _arcs(seed, n, m)
    j = _max_flow(JMF, tails, heads, caps, 0, n - 1)
    t = _max_flow(TMF, tails, heads, caps, 0, n - 1)
    assert t == j
    assert t[0] == "OPTIMAL"
    a = sp.csr_matrix((caps.astype(np.int32), (tails, heads)), shape=(n, n))
    a.setdiag(0)
    a.eliminate_zeros()
    from scipy.sparse.csgraph import maximum_flow
    assert t[1] == maximum_flow(a, 0, n - 1).flow_value


def _min_cost_flow(mod, tails, heads, caps, costs, supplies):
    f = mod.SimpleMinCostFlow()
    for a, b, c, w in zip(tails, heads, caps, costs):
        f.add_arc_with_capacity_and_unit_cost(int(a), int(b), int(c),
                                              int(w))
    for node, s in supplies.items():
        f.set_node_supply(node, s)
    st = f.solve()
    out = [st.name, f.num_nodes, f.num_arcs]
    if st.name == "OPTIMAL":
        out += [f.optimal_cost(), [f.flow(a) for a in range(f.num_arcs)]]
    return out


MCF_CASES = {
    # name: (seed, n, m, supplies); the name's first word is the status
    "optimal_0": (0, 12, 60, {0: 9, 5: 4, 11: -13}),
    "optimal_1": (1, 30, 200, {0: 20, 29: -20}),
    "optimal_2": (2, 20, 120, {1: 7, 2: 7, 18: -6, 19: -8}),
    "infeasible": (3, 10, 12, {0: 300, 9: -300}),
    "unbalanced": (4, 10, 40, {0: 5, 9: -4}),
}


@pytest.mark.parametrize("name", list(MCF_CASES))
def test_min_cost_flow_equals_jax(name):
    seed, n, m, supplies = MCF_CASES[name]
    tails, heads, caps, costs = _arcs(seed, n, m, 25, 20)
    j = _min_cost_flow(JMCF, tails, heads, caps, costs, supplies)
    t = _min_cost_flow(TMCF, tails, heads, caps, costs, supplies)
    assert t == j
    assert t[0] == name.split("_")[0].upper()


@pytest.mark.parametrize("seed,nr,nc", [(0, 6, 6), (1, 12, 12), (2, 5, 9),
                                        (3, 40, 40)])
def test_assignment_equals_jax(seed, nr, nc):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 100, (nr, nc))
    jc, jv = JA.hungarian(cost.astype(float))
    tc, tv = TA.hungarian(cost.astype(float))
    np.testing.assert_array_equal(tc, jc)
    assert tv == jv
    if nr != nc:
        return
    out = []
    for mod in (JA, TA):
        lsa = mod.LinearSumAssignment()
        for i in range(nr):
            for k in range(nc):
                lsa.add_arc_with_cost(i, k, int(cost[i, k]))
        st = lsa.solve()
        out.append((st.name, lsa.optimal_cost(), lsa.num_nodes,
                    [lsa.right_mate(i) for i in range(nr)],
                    [lsa.assignment_cost(i) for i in range(nr)]))
    assert out[1] == out[0]
    from scipy.optimize import linear_sum_assignment
    r, c = linear_sum_assignment(cost)
    assert out[1][1] == int(cost[r, c].sum())


def test_assignment_infeasible_equals_jax():
    out = []
    for mod in (JA, TA):
        lsa = mod.LinearSumAssignment()
        lsa.add_arc_with_cost(0, 0, 3)
        lsa.add_arc_with_cost(1, 0, 4)
        out.append(lsa.solve().name)
    assert out[1] == out[0] == "INFEASIBLE"


@pytest.mark.parametrize("seed", range(4))
def test_shortest_paths_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n, m = 60, 400
    tails = rng.integers(0, n, m).tolist()
    heads = rng.integers(0, n, m).tolist()
    lens = rng.uniform(0, 10, m).tolist()
    jd, jp, jpath = JSP.dijkstra_shortest_path(n, tails, heads, lens, 0,
                                               n - 1)
    td, tp, tpath = TSP.dijkstra_shortest_path(n, tails, heads, lens, 0,
                                               n - 1)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)
    assert tpath == jpath
    from scipy.sparse.csgraph import dijkstra
    # scipy would sum parallel arcs: give it the shortest of each instead
    best = {}
    for a, b, w in zip(tails, heads, lens):
        best[a, b] = min(w, best.get((a, b), np.inf))
    keys = list(best)
    g = sp.csr_matrix(([best[k] for k in keys],
                       ([k[0] for k in keys], [k[1] for k in keys])),
                      shape=(n, n))
    np.testing.assert_allclose(td, dijkstra(g, indices=0), rtol=1e-12)
    signed = (np.array(lens) - 2.0).tolist()
    # a DAG (tail < head), so negative arcs make no negative cycle
    dag = [(a, b, w) for a, b, w in zip(tails, heads, signed) if a < b]
    args = (n, [a for a, _, _ in dag], [b for _, b, _ in dag],
            [w for _, _, w in dag], 0)
    jb, tb = JSP.bellman_ford(*args), TSP.bellman_ford(*args)
    for u, v in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(u))


# ---------------------------------------------------------------------------
# Components and tours
# ---------------------------------------------------------------------------


def _points(seed, n):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (n, 2))
    return np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)


@pytest.mark.parametrize("seed", range(3))
def test_components_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    arcs = [(int(a), int(b)) for a, b in rng.integers(0, n, (70, 2))]
    assert (TC.strongly_connected_components(n, arcs)
            == JC.strongly_connected_components(n, arcs))
    assert TC.connected_components(n, arcs) == JC.connected_components(n, arcs)
    d = _points(seed, 25)
    edges = [(i, j, float(d[i, j])) for i in range(25)
             for j in range(i + 1, 25)]
    assert (TC.minimum_spanning_tree(25, edges)
            == JC.minimum_spanning_tree(25, edges))
    small = [(int(a), int(b)) for a, b in rng.integers(0, 12, (30, 2))
             if a != b]
    assert (TC.bron_kerbosch_cliques(12, small)
            == JC.bron_kerbosch_cliques(12, small))
    # Eulerian: a circuit (doubled tree), a path, and none
    tree = TC.minimum_spanning_tree(25, edges)
    doubled = [edges[k][:2] for k in tree] * 2
    for es in (doubled, doubled + [(0, 1)], [(0, 1), (2, 3)]):
        assert TC.eulerian_path(25, es) == JC.eulerian_path(25, es)
    order = []
    for mod in (JC, TC):
        ts = mod.TopologicalSorter()
        for a, b in arcs:
            if a < b:
                ts.add_edge(a, b)
        order.append(ts.sort())
    assert order[1] == order[0] and order[1] is not None


@pytest.mark.parametrize("seed", range(3))
def test_tours_equal_jax(seed):
    d = _points(seed, 9)
    jc, jt = JT.held_karp_tsp(d)
    tc, tt = TT.held_karp_tsp(d)
    assert (tc, tt) == (jc, jt)
    d = _points(10 + seed, 14)
    assert TT.one_tree_lower_bound(d) == JT.one_tree_lower_bound(d)
    port = TT.christofides_tsp(d, device="cpu")
    assert port == JT.christofides_tsp(d)
    opt, _ = TT.held_karp_tsp(d)
    assert sorted(port[1]) == list(range(14))
    assert TT.one_tree_lower_bound(d) <= opt + 1e-6
    assert port[0] <= 1.5 * opt + 1e-9


@pytest.mark.parametrize("seed", range(2))
def test_christofides_mip_fallback_equals_jax(seed, monkeypatch):
    """With the blossom patched to give up in both packages, matching's MIP
    fallback runs (the port's on ``device="cpu"``) and the tours agree."""
    d = _points(20 + seed, 12)
    exact = TT.christofides_tsp(d, device="cpu")
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "min_weight_perfect_matching_blossom",
                            lambda *a, **k: None)
    calls = []
    from ortools_tpu_torch.mip import branch_and_bound as bnb
    orig = bnb.solve

    def spy(*a, **k):
        calls.append(k.get("device"))
        return orig(*a, **k)

    monkeypatch.setattr(bnb, "solve", spy)
    port = TT.christofides_tsp(d, device="cpu")
    assert port == JT.christofides_tsp(d)
    assert calls and all(str(c) == "cpu" for c in calls)
    assert port[0] == pytest.approx(exact[0], rel=1e-12)
