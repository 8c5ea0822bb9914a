"""CP-SAT certification path for routing models.

Capability parity: ``ortools/constraint_solver/routing_sat.cc`` — the
reference solves (small/medium) routing models exactly through CP-SAT by
encoding the VRP as one giant tour over a ``circuit`` constraint (vehicle
end -> next vehicle start arcs fixed to true), with dimension cumuls as
integer variables propagated along selected arcs.  This module is the
same role on this framework's CP stack: it certifies (or improves) the
local-search solution, and proves optimality when the CP solve finishes.

Scope (callers fall back to pure local search outside it): homogeneous
fleet (identical per-vehicle cost matrices and per-dimension capacities),
dimensions with integer transits, node time windows, optional nodes from
disjunctions (penalized self-loop arcs), fixed vehicle costs.  Pickup &
delivery, breaks, resources and span costs are out of the fragment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def solve_with_cp_sat(model, time_limit_sec: float = 10.0,
                      warm_routes: Optional[List[List[int]]] = None):
    """Exact solve/certification of a RoutingModel through CP-SAT.

    Returns ``(assignment, proven_optimal)`` or ``None`` when the model
    is outside the supported fragment or the CP solve finds nothing
    within the limit.  ``warm_routes`` (internal-index routes without
    depots, one list per vehicle) seed the solution hint.
    """
    mgr = model.manager
    if model._pd_pairs or model._resource_groups:
        return None
    node_of, cost, dims = model._build_matrices()
    nv = mgr.num_vehicles
    # homogeneous fleet only (the giant tour cannot tell which vehicle
    # serves a node)
    for v in range(1, nv):
        if not np.array_equal(cost[v], cost[0]):
            return None
    for d, _mat in dims:
        if d.capacities and len(set(d.capacities)) > 1:
            return None
        if d.span_cost_coefficient or d.breaks_per_vehicle:
            return None
    # the giant tour does not pin WHICH end depot closes which start's
    # segment, so all starts must share one node and all ends another —
    # then the pairing is cost-irrelevant and the decode below may
    # re-pair freely
    if len({mgr._starts[v] for v in range(nv)}) > 1 \
            or len({mgr._ends[v] for v in range(nv)}) > 1:
        return None
    n = mgr.get_number_of_indices()
    starts = [mgr.vehicle_start(v) for v in range(nv)]
    ends = [mgr.vehicle_end(v) for v in range(nv)]
    start_set, end_set = set(starts), set(ends)
    # visit copies of terminal NODES (e.g. the depot's plain index) are
    # never visited — only indices whose node is not a vehicle terminal
    terminal_nodes = set(mgr._starts) | set(mgr._ends)
    visits = [i for i in range(mgr.num_nodes)
              if node_of[i] not in terminal_nodes]
    optional: Dict[int, int] = {}
    for idxs, pen in model._disjunctions:
        for i in idxs:
            optional[i] = pen
    if len(visits) > 60:  # certification path is for small instances
        return None

    from ortools_tpu_torch.sat.cp_model import CpModel, CpSolver

    cp = CpModel()
    arc_cost = cost[0]
    obj_terms: List[Tuple[int, object]] = []
    obj_const = 0
    lits: Dict[Tuple[int, int], object] = {}
    arcs = []

    def add_arc(t: int, h: int, c: int) -> None:
        b = cp.new_bool_var(f"x_{t}_{h}")
        lits[(t, h)] = b
        arcs.append((t, h, b))
        if c:
            obj_terms.append((c, b))

    for v in range(nv):
        sv, ev = starts[v], ends[v]
        for j in visits:
            add_arc(sv, j, int(arc_cost[node_of[sv], node_of[j]]))
        # empty route: the reference pays the depot->depot arc only when
        # start and end are distinct nodes (routing/model.py _objective)
        empty_cost = (int(arc_cost[node_of[sv], node_of[ev]])
                      if node_of[sv] != node_of[ev] else 0)
        add_arc(sv, ev, empty_cost)
        for i in visits:
            add_arc(i, ev, int(arc_cost[node_of[i], node_of[ev]]))
    for i in visits:
        for j in visits:
            if i != j:
                add_arc(i, j, int(arc_cost[node_of[i], node_of[j]]))
    for i in visits:
        if i in optional:
            b = cp.new_bool_var(f"skip_{i}")
            lits[(i, i)] = b
            arcs.append((i, i, b))
            obj_terms.append((optional[i], b))
    # vehicle-end -> next-vehicle-start arcs are fixed true
    true_lit = cp.new_constant(1)
    for v in range(nv):
        arcs.append((ends[v], starts[(v + 1) % nv], true_lit))
    cp.add_circuit(arcs)

    # fixed vehicle cost: paid unless the route is empty
    for v in range(nv):
        c = int(model._fixed_vehicle_cost[v])
        if c:
            empty = lits[(starts[v], ends[v])]
            obj_terms.append((-c, empty))
            obj_const += c

    # dimensions: cumul variable per internal index, propagated along
    # selected arcs (NOT across the fixed end->start links: each vehicle
    # restarts its cumul)
    dim_cums = []  # (dimension, matrix, cumul vars) for warm hinting
    for d, mat in dims:
        cap = int(d.capacities[0]) if d.capacities else (1 << 40)
        cum = []
        for i in range(n):
            lo = int(d.cumul_lb.get(i, 0))
            hi = min(int(d.cumul_ub.get(i, cap)), cap)
            if i in start_set and d.fix_start_cumul_to_zero:
                lo = hi = 0
            if lo > hi:
                return None  # inconsistent window
            cum.append(cp.new_int_var(lo, hi, f"cum_{d.name}_{i}"))
        dim_cums.append((d, mat, cum))
        slack = max(0, int(d.slack_max))
        for (t, h), b in lits.items():
            if t == h:
                continue
            tr = int(mat[node_of[t], node_of[h]])
            e = cum[h] - cum[t]
            cp.add(e >= tr).only_enforce_if(b)
            if slack < cap:
                cp.add(e <= tr + slack).only_enforce_if(b)

    expr = obj_const
    for c, b in obj_terms:
        expr = expr + c * b
    cp.minimize(expr)

    if warm_routes is not None:
        nxt = {}
        for v, r in enumerate(warm_routes):
            seq = [starts[v]] + list(r) + [ends[v]]
            for a, b in zip(seq, seq[1:]):
                nxt[a] = b
        placed = {i for r in warm_routes for i in r}
        for (t, h), b in lits.items():
            if t == h:
                cp.add_hint(b, 0 if t in placed else 1)
            else:
                cp.add_hint(b, 1 if nxt.get(t) == h else 0)
        # hint the cumuls too: a complete feasible hint becomes the
        # incumbent immediately (solver-side hints are all-or-nothing,
        # the reference's QuickSolveWithHint contract)
        for d, mat, cum in dim_cums:
            slack = max(0, int(d.slack_max))
            hinted = set()
            for v, r in enumerate(warm_routes):
                cumul = 0
                prev = starts[v]
                cp.add_hint(cum[prev], 0)
                hinted.add(prev)
                for i in list(r) + [ends[v]]:
                    cumul += int(mat[node_of[prev], node_of[i]])
                    lo_i = int(d.cumul_lb.get(i, 0))
                    if slack > 0 and cumul < lo_i:
                        cumul = lo_i  # wait for the window
                    cp.add_hint(cum[i], cumul)
                    hinted.add(i)
                    prev = i
            for i in range(n):
                if i not in hinted:
                    # dropped / unused copies: any in-domain value
                    cp.add_hint(cum[i], int(d.cumul_lb.get(i, 0)))

    solver = CpSolver(device=model.device)
    solver.parameters.max_time_in_seconds = float(time_limit_sec)
    status = solver.solve(cp)
    name = solver.status_name(status)
    if name not in ("OPTIMAL", "FEASIBLE"):
        return None
    nexts = {}
    for (t, h), b in lits.items():
        if solver.value(b):
            nexts[t] = h
    routes = []
    dropped = [i for i in visits if nexts.get(i) == i]
    end_set_all = set(ends)
    for v in range(nv):
        r = []
        cur = nexts.get(starts[v])
        guard = 0
        # a segment may close at ANY end depot (see the same-node guard
        # above); the customers between start_v and that end belong to
        # vehicle v
        while cur is not None and cur not in end_set_all:
            r.append(cur)
            cur = nexts.get(cur)
            guard += 1
            if guard > n + 2:
                return None  # malformed tour: refuse rather than loop
        routes.append(r)
    from ortools_tpu_torch.routing.model import Assignment

    internal = [[starts[v]] + routes[v] + [ends[v]] for v in range(nv)]
    obj = model._objective(routes, dropped, cost, optional)
    return Assignment(model, internal, obj), name == "OPTIMAL"


def certify_lazy_sec(model, time_limit_sec: float = 60.0,
                     warm_routes: Optional[List[List[int]]] = None):
    """Exact VRP certification by lazy subtour elimination on the
    incremental LCG core.

    Reference roles: ``ortools/sat/circuit.h:60`` (the native circuit
    propagator's SCC reasoning, realized here as row generation) and
    ``ortools/sat/routing_cuts.h`` (subtour cuts).  Loop: solve the
    degree-constrained relaxation with the objective cutoff as an
    ASSUMPTION; a SAT point with subtours adds one subtour-elimination
    clause per offending component (some arc must leave the set — with
    optional nodes, "or this member is skipped") and re-solves on the
    SAME solver so learned clauses survive; a subtour-free SAT point
    improves the incumbent; UNSAT proves optimality — valid even under
    an incomplete SEC set, because missing rows only WEAKEN the
    relaxation.

    Returns ``(assignment, proven_optimal)`` or None."""
    import time as _time

    mgr = model.manager
    deadline = _time.perf_counter() + float(time_limit_sec)
    if model._pd_pairs or model._resource_groups:
        return None
    node_of, cost, dims = model._build_matrices()
    nv = mgr.num_vehicles
    for v in range(1, nv):
        if not np.array_equal(cost[v], cost[0]):
            return None
    for d, _mat in dims:
        if d.capacities and len(set(d.capacities)) > 1:
            return None
        if d.span_cost_coefficient or d.breaks_per_vehicle:
            return None
    if len({mgr._starts[v] for v in range(nv)}) > 1 \
            or len({mgr._ends[v] for v in range(nv)}) > 1:
        return None
    n = mgr.get_number_of_indices()
    starts = [mgr.vehicle_start(v) for v in range(nv)]
    ends = [mgr.vehicle_end(v) for v in range(nv)]
    end_set = set(ends)
    terminal_nodes = set(mgr._starts) | set(mgr._ends)
    visits = [i for i in range(mgr.num_nodes)
              if node_of[i] not in terminal_nodes]
    optional: Dict[int, int] = {}
    for idxs, pen in model._disjunctions:
        for i in idxs:
            optional[i] = pen
    if len(visits) > 80:
        return None

    from ortools_tpu_torch.sat.lcg import SAT, UNSAT, LcgSolver

    s = LcgSolver()
    arc_cost = cost[0]
    xvar: Dict[Tuple[int, int], int] = {}  # (t, h) -> 0/1 int var
    arc_c: Dict[Tuple[int, int], int] = {}

    def add_arc(t: int, h: int, c: int) -> None:
        xvar[(t, h)] = s.new_bool01()
        arc_c[(t, h)] = int(c)

    for v in range(nv):
        sv, ev = starts[v], ends[v]
        for j in visits:
            add_arc(sv, j, arc_cost[node_of[sv], node_of[j]])
        add_arc(sv, ev, arc_cost[node_of[sv], node_of[ev]]
                if node_of[sv] != node_of[ev] else 0)
        for i in visits:
            add_arc(i, ev, arc_cost[node_of[i], node_of[ev]])
    for i in visits:
        for j in visits:
            if i != j:
                add_arc(i, j, arc_cost[node_of[i], node_of[j]])
        if i in optional:
            add_arc(i, i, optional[i])

    fixed_const = 0
    for v in range(nv):
        c = int(model._fixed_vehicle_cost[v])
        if c:
            fixed_const += c
            arc_c[(starts[v], ends[v])] -= c

    # degree rows as native linears over the 0/1 arc ints
    outs: Dict[int, List[int]] = {}
    ins: Dict[int, List[int]] = {}
    for (t, h), x in xvar.items():
        outs.setdefault(t, []).append(x)
        ins.setdefault(h, []).append(x)
    for group in list(outs.values()) + list(ins.values()):
        s.add_linear([], group, [1] * len(group), 1, 1)

    # dimension cumuls along selected arcs
    for d, mat in dims:
        cap = int(d.capacities[0]) if d.capacities else (1 << 40)
        cum = []
        for i in range(n):
            lo = int(d.cumul_lb.get(i, 0))
            hi = min(int(d.cumul_ub.get(i, cap)), cap)
            if i in set(starts) and d.fix_start_cumul_to_zero:
                lo = hi = 0
            if lo > hi:
                return None
            cum.append(s.new_int(lo, hi))
        slack = max(0, int(d.slack_max))
        for (t, h), x in xvar.items():
            if t == h:
                continue
            tr = int(mat[node_of[t], node_of[h]])
            lit = s.ge(x, 1)
            s.add_linear([lit], [cum[h], cum[t]], [1, -1], tr, None)
            if slack < cap:
                s.add_linear([lit], [cum[h], cum[t]], [1, -1], None,
                             tr + slack)

    # objective: sum c * arc - obj_x == 0
    terms = [(x, c) for (t, h), x in xvar.items()
             for c in [arc_c[(t, h)]] if c]
    lo_o = sum(min(0, c) for _, c in terms)
    hi_o = sum(max(0, c) for _, c in terms)
    obj_x = s.new_int(int(lo_o), int(hi_o))
    s.add_linear([], [x for x, _ in terms] + [obj_x],
                 [c for _, c in terms] + [-1], 0, 0)
    if s.infeasible:
        return None

    def decode_routes(nxt: Dict[int, int]):
        routes = []
        for v in range(nv):
            r = []
            cur = nxt.get(starts[v])
            guard = 0
            while cur is not None and cur not in end_set:
                r.append(cur)
                cur = nxt.get(cur)
                guard += 1
                if guard > n + 2:
                    return None
            routes.append(r)
        return routes

    def warm_value(routes):
        tot = fixed_const
        placed = set()
        for v, r in enumerate(routes):
            seq = [starts[v]] + list(r) + [ends[v]]
            for a, b in zip(seq, seq[1:]):
                if (a, b) not in arc_c:
                    return None
                tot += arc_c[(a, b)]
            placed.update(r)
        for i in visits:
            if i not in placed:
                if i not in optional:
                    return None
                tot += optional[i]
        return tot

    best_routes = None
    best_obj = None
    if warm_routes is not None:
        wv = warm_value(warm_routes)
        if wv is not None:
            best_routes = [list(r) for r in warm_routes]
            best_obj = wv - fixed_const  # obj_x excludes the constant
        for v, r in enumerate(warm_routes or []):
            seq = [starts[v]] + list(r) + [ends[v]]
            nxt_w = dict(zip(seq, seq[1:]))
            for (t, h), x in xvar.items():
                if nxt_w.get(t) == h:
                    s.set_int_hint(x, 1)

    # Pure symmetric TSP: seed the search with the Held-Karp 1-tree
    # bound (graph/tsp_paths.py; reference one_tree_lower_bound.h).
    # When the bound meets the incumbent the certificate is immediate;
    # otherwise it becomes a root row that prunes the whole descent.
    if (nv == 1 and not dims and not optional
            and node_of[starts[0]] == node_of[ends[0]]):
        nodes_t = [node_of[starts[0]]] + [node_of[i] for i in visits]
        dmat = np.asarray(arc_cost, dtype=float)[np.ix_(nodes_t, nodes_t)]
        if np.allclose(dmat, dmat.T):
            import math as _math

            from ortools_tpu_torch.graph.tsp_paths import one_tree_lower_bound

            hk = one_tree_lower_bound(dmat, iterations=250)
            lb_int = int(_math.ceil(hk - 1e-6))
            if best_obj is not None and lb_int >= best_obj:
                internal = [[starts[0]] + list(best_routes[0])
                            + [ends[0]]]
                from ortools_tpu_torch.routing.model import Assignment

                obj = model._objective(best_routes, [], cost, optional)
                return Assignment(model, internal, obj), True
            s.add_linear([], [obj_x], [1], lb_int, None)

    n_sec = 0
    proven = False
    while _time.perf_counter() < deadline:
        assumptions = []
        if best_obj is not None:
            lit = s.le(obj_x, int(best_obj) - 1)
            from ortools_tpu_torch.sat.lcg import FALSE_EXT, TRUE_EXT
            if lit == FALSE_EXT:
                proven = True
                break
            if lit != TRUE_EXT:
                assumptions.append(lit)
        left = deadline - _time.perf_counter()
        if left <= 0:
            break
        st = s.solve(assumptions, conflict_budget=0,
                     time_budget=max(0.1, left))
        if st == UNSAT:
            if best_obj is not None:
                proven = True
            break
        if st != SAT:
            break
        nxt = {}
        for (t, h), x in xvar.items():
            if s.int_value(x) >= 1:
                nxt[t] = h
        # find components of the selected-arc functional graph
        seen: Dict[int, int] = {}
        comp_of: Dict[int, int] = {}
        ncomp = 0
        for start_node in list(nxt.keys()):
            if start_node in comp_of:
                continue
            path = []
            cur = start_node
            while cur is not None and cur not in comp_of \
                    and cur not in seen:
                seen[cur] = ncomp
                path.append(cur)
                cur = nxt.get(cur)
            cid = comp_of.get(cur, ncomp)
            for p2 in path:
                comp_of[p2] = cid
            ncomp += 1
        main_comp = comp_of.get(starts[0])
        subtours: Dict[int, List[int]] = {}
        for i, cid in comp_of.items():
            if cid == main_comp:
                continue
            if nxt.get(i) == i:
                continue  # skipped optional node (self-loop)
            subtours.setdefault(cid, []).append(i)
        if not subtours:
            routes = decode_routes(nxt)
            if routes is None:
                break
            val = int(s.int_value(obj_x))
            if best_obj is None or val < best_obj:
                best_obj = val
                best_routes = routes
            continue  # tighten the cutoff next round
        for comp in subtours.values():
            comp_set = set(comp)
            clause = []
            for (t, h), x in xvar.items():
                if t in comp_set and h not in comp_set:
                    clause.append(s.ge(x, 1))
            # optional members may all be skipped instead
            for i in comp:
                if (i, i) in xvar:
                    clause.append(s.ge(xvar[(i, i)], 1))
            if clause:
                s.add_clause(clause)
                n_sec += 1
            else:
                return None  # no escape arcs: malformed model
    if best_routes is None:
        return None
    from ortools_tpu_torch.routing.model import Assignment

    internal = [[starts[v]] + list(best_routes[v]) + [ends[v]]
                for v in range(nv)]
    dropped = [i for i in visits
               if all(i not in r for r in best_routes)]
    obj = model._objective(best_routes, dropped, cost, optional)
    return Assignment(model, internal, obj), proven


def certify_hetero(model, time_limit_sec: float = 60.0,
                   warm_routes: Optional[List[List[int]]] = None,
                   max_visits: int = 16, max_vehicles: int = 4):
    """Exact certification for HETEROGENEOUS fleets (per-vehicle cost
    matrices / capacities) via a vehicle-indexed encoding on the LCG
    core — the giant-tour form cannot tell which vehicle serves a node,
    so each vehicle gets its own arc copy (reference: the
    vehicle-indexed models of routing_sat.cc for non-interchangeable
    vehicles).

    Per vehicle v: arc bools over {start_v} + visits + {end_v},
    serve[v,i] indicators tied to in/out degree rows, its own dimension
    cumuls and capacities; across vehicles: each mandatory visit served
    exactly once (optional nodes may instead pay their penalty).  Lazy
    subtour elimination per vehicle; cutoff as assumption; UNSAT under
    the partial SEC set proves optimality (missing rows only weaken).

    Small instances only (arc count grows as vehicles * visits^2).
    Returns (assignment, proven_optimal) or None."""
    import time as _time

    mgr = model.manager
    deadline = _time.perf_counter() + float(time_limit_sec)
    if model._pd_pairs or model._resource_groups:
        return None
    node_of, cost, dims = model._build_matrices()
    nv = mgr.num_vehicles
    terminal_nodes = set(mgr._starts) | set(mgr._ends)
    visits = [i for i in range(mgr.num_nodes)
              if node_of[i] not in terminal_nodes]
    if len(visits) > max_visits or nv > max_vehicles:
        return None
    optional: Dict[int, int] = {}
    for idxs, pen in model._disjunctions:
        for i in idxs:
            optional[i] = pen
    for d, _mat in dims:
        if d.span_cost_coefficient or d.breaks_per_vehicle:
            return None

    from ortools_tpu_torch.sat.lcg import SAT, UNSAT, LcgSolver

    s = LcgSolver()
    starts = [mgr.vehicle_start(v) for v in range(nv)]
    ends = [mgr.vehicle_end(v) for v in range(nv)]

    xvar: Dict[Tuple[int, int, int], int] = {}  # (v, t, h) -> 0/1 int
    arc_c: Dict[Tuple[int, int, int], int] = {}

    def add_arc(v: int, t: int, h: int, c: int) -> None:
        xvar[(v, t, h)] = s.new_bool01()
        arc_c[(v, t, h)] = int(c)

    for v in range(nv):
        cm = cost[v]
        sv, ev = starts[v], ends[v]
        for j in visits:
            add_arc(v, sv, j, cm[node_of[sv], node_of[j]])
            add_arc(v, j, ev, cm[node_of[j], node_of[ev]])
        add_arc(v, sv, ev,
                cm[node_of[sv], node_of[ev]]
                if node_of[sv] != node_of[ev] else 0)
        for i in visits:
            for j in visits:
                if i != j:
                    add_arc(v, i, j, cm[node_of[i], node_of[j]])
    # serve indicators + skip bools for optional nodes
    serve = {(v, i): s.new_bool01() for v in range(nv) for i in visits}
    skip: Dict[int, int] = {}
    for i in visits:
        row_vars = [serve[(v, i)] for v in range(nv)]
        coefs = [1] * nv
        if i in optional:
            skip[i] = s.new_bool01()
            row_vars.append(skip[i])
            coefs.append(1)
        s.add_linear([], row_vars, coefs, 1, 1)
    # degree rows per vehicle
    for v in range(nv):
        sv, ev = starts[v], ends[v]
        outs_s = [xvar[(v, sv, j)] for j in visits] + [xvar[(v, sv, ev)]]
        s.add_linear([], outs_s, [1] * len(outs_s), 1, 1)
        ins_e = [xvar[(v, i, ev)] for i in visits] + [xvar[(v, sv, ev)]]
        s.add_linear([], ins_e, [1] * len(ins_e), 1, 1)
        for i in visits:
            outs = [xvar[(v, i, j)] for j in visits if j != i] \
                + [xvar[(v, i, ev)]]
            ins = [xvar[(v, sv, i)]] \
                + [xvar[(v, j, i)] for j in visits if j != i]
            s.add_linear([], outs + [serve[(v, i)]],
                         [1] * len(outs) + [-1], 0, 0)
            s.add_linear([], ins + [serve[(v, i)]],
                         [1] * len(ins) + [-1], 0, 0)
    # fixed vehicle costs: paid unless the empty arc start->end is taken
    fixed_terms = []
    fixed_const = 0
    for v in range(nv):
        c = int(model._fixed_vehicle_cost[v])
        if c:
            fixed_const += c
            arc_c[(v, starts[v], ends[v])] -= c
    # per-vehicle dimension cumuls
    for d, mat_any in dims:
        for v in range(nv):
            cap = int(d.capacities[v]) if d.capacities else (1 << 40)
            mat = mat_any
            cum = {}
            for i in [starts[v]] + visits + [ends[v]]:
                lo = int(d.cumul_lb.get(i, 0))
                hi = min(int(d.cumul_ub.get(i, cap)), cap)
                if i == starts[v] and d.fix_start_cumul_to_zero:
                    lo = hi = 0
                if lo > hi:
                    return None
                cum[i] = s.new_int(lo, hi)
            slack = max(0, int(d.slack_max))
            for (vv, t, h), x in xvar.items():
                if vv != v or t == h:
                    continue
                tr = int(mat[node_of[t], node_of[h]])
                lit = s.ge(x, 1)
                s.add_linear([lit], [cum[h], cum[t]], [1, -1], tr, None)
                if slack < cap:
                    s.add_linear([lit], [cum[h], cum[t]], [1, -1],
                                 None, tr + slack)
    # objective
    terms = [(x, arc_c[k]) for k, x in xvar.items() if arc_c[k]]
    for i, pen in optional.items():
        if i in skip:
            terms.append((skip[i], int(pen)))
    lo_o = sum(min(0, c) for _, c in terms)
    hi_o = sum(max(0, c) for _, c in terms)
    obj_x = s.new_int(int(lo_o), int(hi_o))
    s.add_linear([], [x for x, _ in terms] + [obj_x],
                 [c for _, c in terms] + [-1], 0, 0)
    if s.infeasible:
        return None

    def routes_value(routes):
        tot = fixed_const
        placed = set()
        for v, r in enumerate(routes):
            seq = [starts[v]] + list(r) + [ends[v]]
            for a_, b_ in zip(seq, seq[1:]):
                if (v, a_, b_) not in arc_c:
                    return None
                tot += arc_c[(v, a_, b_)]
            placed.update(r)
        for i in visits:
            if i not in placed:
                if i not in optional:
                    return None
                tot += optional[i]
        return tot

    best_routes = None
    best_obj = None
    if warm_routes is not None:
        wv = routes_value(warm_routes)
        if wv is not None:
            best_routes = [list(r) for r in warm_routes]
            best_obj = wv - fixed_const
        for v, r in enumerate(warm_routes or []):
            seq = [starts[v]] + list(r) + [ends[v]]
            nxt_w = dict(zip(seq, seq[1:]))
            for (vv, t, h), x in xvar.items():
                if vv == v and nxt_w.get(t) == h:
                    s.set_int_hint(x, 1)

    proven = False
    while _time.perf_counter() < deadline:
        assumptions = []
        if best_obj is not None:
            from ortools_tpu_torch.sat.lcg import FALSE_EXT, TRUE_EXT

            lit = s.le(obj_x, int(best_obj) - 1)
            if lit == FALSE_EXT:
                proven = True
                break
            if lit != TRUE_EXT:
                assumptions.append(lit)
        left = deadline - _time.perf_counter()
        if left <= 0:
            break
        st = s.solve(assumptions, conflict_budget=0,
                     time_budget=max(0.1, left))
        if st == UNSAT:
            proven = best_obj is not None
            break
        if st != SAT:
            break
        # decode per vehicle; find subtours per vehicle
        any_sec = False
        routes = []
        for v in range(nv):
            nxt = {}
            for (vv, t, h), x in xvar.items():
                if vv == v and s.int_value(x) >= 1:
                    nxt[t] = h
            r = []
            cur = nxt.get(starts[v])
            guard = 0
            while cur is not None and cur != ends[v]:
                r.append(cur)
                cur = nxt.get(cur)
                guard += 1
                if guard > len(visits) + 2:
                    return None
            routes.append(r)
            on_tour = set(r)
            stray = [i for i in visits
                     if s.int_value(serve[(v, i)]) >= 1
                     and i not in on_tour]
            comp_left = set(stray)
            while comp_left:
                seed = comp_left.pop()
                comp = {seed}
                cur = nxt.get(seed)
                guard = 0
                while cur is not None and cur != seed:
                    comp.add(cur)
                    comp_left.discard(cur)
                    cur = nxt.get(cur)
                    guard += 1
                    if guard > len(visits) + 2:
                        break
                # SEC for vehicle v: some arc leaves comp, or some
                # member is not served by v
                clause = []
                for (vv, t, h), x in xvar.items():
                    if vv == v and t in comp and h not in comp:
                        clause.append(s.ge(x, 1))
                for i in comp:
                    clause.append(-s.ge(serve[(v, i)], 1))
                s.add_clause(clause)
                any_sec = True
        if any_sec:
            continue
        val = int(s.int_value(obj_x))
        if best_obj is None or val < best_obj:
            best_obj = val
            best_routes = routes
    if best_routes is None:
        return None
    from ortools_tpu_torch.routing.model import Assignment

    internal = [[starts[v]] + list(best_routes[v]) + [ends[v]]
                for v in range(nv)]
    dropped = [i for i in visits
               if all(i not in r for r in best_routes)]
    obj = model._objective(best_routes, dropped, cost, optional)
    return Assignment(model, internal, obj), proven
