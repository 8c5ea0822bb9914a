"""Arc-flow formulation of (vector) bin packing, the PyTorch port of
``ortools_tpu/packing/arc_flow.py``.

Capability parity: ``ortools/packing/arc_flow_builder.{h,cc}`` (DP-built
arc-flow graph per Brandao & Pedroso) + ``arc_flow_solver.cc`` (solve the
flow MIP).  The graph is built by the same forward dynamic-programming
pass over capacity states; the min-bin solve rides this framework's own
batched-PDHG B&B instead of an external MIP solver, on ``device`` (the
card by default).

States are reachable capacity-usage vectors; an arc (s -> s + w_i, i)
places one unit of item i, loss arcs jump to the sink.  Minimizing flow
out of the source subject to item-demand and flow-conservation equals the
minimum number of bins.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class ArcFlowGraph:
    # arcs as (source_state, dest_state, item_index); item_index -1 = loss
    arcs: List[Tuple[int, int, int]]
    num_nodes: int
    source: int
    sink: int


def build_arc_flow_graph(
    bin_capacity: Sequence[int],
    item_sizes: Sequence[Sequence[int]],
    demands: Sequence[int],
) -> ArcFlowGraph:
    """Forward-DP arc-flow construction (arc_flow_builder.cc algorithm 1,
    non-recursive): items sorted by decreasing size; states are capacity
    vectors reachable by packing a prefix; loss arcs connect every state
    to the sink."""
    cap = tuple(int(c) for c in bin_capacity)
    ndim = len(cap)
    items = [tuple(int(x) for x in s) for s in item_sizes]
    order = sorted(range(len(items)), key=lambda i: items[i], reverse=True)

    zero = tuple([0] * ndim)
    states = {zero}
    arcs_set = set()
    frontier = [zero]
    # forward pass: per item (respecting demand multiplicity), extend all
    # current states
    for it in order:
        w = items[it]
        for _ in range(int(demands[it])):
            new_states = set()
            for s in list(states):
                t = tuple(s[d] + w[d] for d in range(ndim))
                if any(t[d] > cap[d] for d in range(ndim)):
                    continue
                arcs_set.add((s, t, it))
                if t not in states:
                    new_states.add(t)
            states |= new_states
            if not new_states:
                break
    # node ids: sorted states, then the sink
    ordered = sorted(states)
    node_id: Dict[Tuple[int, ...], int] = {
        s: k for k, s in enumerate(ordered)}
    sink = len(ordered)
    arcs = [(node_id[s], node_id[t], it) for (s, t, it) in sorted(arcs_set)]
    for s in ordered:
        if s != zero:
            arcs.append((node_id[s], sink, -1))  # loss arc
    # direct source->sink arc covers the "empty bin" flow identity
    return ArcFlowGraph(arcs=arcs, num_nodes=sink + 1,
                        source=node_id[zero], sink=sink)


def solve_vector_bin_packing(
    bin_capacity: Sequence[int],
    item_sizes: Sequence[Sequence[int]],
    demands: Sequence[int],
    max_nodes: int = 5000,
    *,
    device="cuda",
) -> Tuple[int, ArcFlowGraph]:
    """Minimum bins via the arc-flow MIP (arc_flow_solver.cc role), solved
    on ``device``.

    Variables = integer arc flows; constraints = flow conservation at the
    interior nodes and exact item demand coverage; objective = flow out of
    the source (number of bins).  Returns (num_bins, graph).
    """
    from ortools_tpu_torch.mip.branch_and_bound import solve as mip_solve
    from ortools_tpu_torch.models.lp import QuadraticProgram
    from ortools_tpu_torch.utils.device import lp_dtype, resolve_device
    from ortools_tpu_torch.utils.status import MPSolverStatus

    device = resolve_device(device)
    g = build_arc_flow_graph(bin_capacity, item_sizes, demands)
    na = len(g.arcs)
    n_items = len(item_sizes)
    total_demand = int(np.sum(demands))
    rows, cols, vals = [], [], []
    cl, cu = [], []
    r = 0
    # flow conservation at interior nodes: in - out == 0
    for node in range(g.num_nodes):
        if node in (g.source, g.sink):
            continue
        touched = False
        for e, (s, t, _) in enumerate(g.arcs):
            if t == node:
                rows.append(r); cols.append(e); vals.append(1.0)
                touched = True
            if s == node:
                rows.append(r); cols.append(e); vals.append(-1.0)
                touched = True
        if touched:
            cl.append(0.0); cu.append(0.0); r += 1
    # item coverage: sum of flows on item-i arcs == demand_i
    for i in range(n_items):
        for e, (_, _, it) in enumerate(g.arcs):
            if it == i:
                rows.append(r); cols.append(e); vals.append(1.0)
        cl.append(float(demands[i])); cu.append(float(demands[i])); r += 1
    a = sp.csr_matrix((vals, (rows, cols)), shape=(r, na))
    # objective: total flow leaving the source
    c = np.zeros(na)
    for e, (s, _, _) in enumerate(g.arcs):
        if s == g.source:
            c[e] = 1.0
    qp = QuadraticProgram(
        objective_vector=c,
        constraint_matrix=a,
        constraint_lower=np.array(cl),
        constraint_upper=np.array(cu),
        variable_lower=np.zeros(na),
        variable_upper=np.full(na, float(total_demand)),
        integrality=np.ones(na, dtype=bool),
    )
    res = mip_solve(qp, max_nodes=max_nodes, node_batch_size=16,
                    device=device, lp_dtype=lp_dtype(device))
    assert res.status in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE), \
        res.status
    return int(round(res.objective_value)), g


def parse_binpacking_2d(path: str, instance: int = 1
                        ) -> Tuple[Tuple[int, int], List[Tuple[int, int]]]:
    """2bp-format parser (reference binpacking_2d_parser.h): returns
    (bin_shape, item_shapes) for the 1-based ``instance`` in the file.

    Format per instance (http://or.dei.unibo.it/library/
    two-dimensional-bin-packing-problem):
        <n_items>
        <bin_height> <bin_width>          (some sets: width height)
        <h_i> <w_i>   x n_items
    Files may hold several instances back to back, with optional header
    comment lines per instance.
    """
    tokens: List[str] = []
    with open(path) as f:
        for line in f:
            # strip trailing comments of the "PROBLEM CLASS"-style headers
            parts = line.split()
            tokens.extend(parts)
    # tokenized scan: read instances until the requested index
    pos = 0

    def next_int() -> int:
        nonlocal pos
        while pos < len(tokens):
            try:
                v = int(tokens[pos])
                pos += 1
                return v
            except ValueError:
                pos += 1
        raise EOFError("2bp file exhausted")

    for k in range(1, instance + 1):
        n = next_int()
        h, w = next_int(), next_int()
        items = [(next_int(), next_int()) for _ in range(n)]
        if k == instance:
            return (h, w), items
    raise ValueError(f"instance {instance} not found")
