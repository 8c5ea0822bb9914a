"""Deterministic interleaved search portfolio.

Capability parity: the reference's parallel portfolio layer (SURVEY §2.4.6)
— SolveCpModelParallel (cp_model_solver.cc:3360) with `interleave_search`:
diverse workers advance in fixed round-robin slices of deterministic work
(here: branch counts, the dtime analogue), sharing the incumbent and
objective bound between slices (the SharedResponseManager role).  Same
results on every run by construction (A.10 determinism contract).

Worker diversity follows the reference's named-config idea (A.5): the
configs differ in branching variable/value rules and seeds rather than a
single strategy running longer.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Tuple

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.engine import Engine
from ortools_tpu_torch.utils.domain import Domain, INT_MIN

# (name, var_rule, value_rule, seed) — diversity catalogue
WORKER_CONFIGS = [
    ("default", "min_domain", "min", 0),
    ("split", "min_domain", "split", 0),
    ("max_value", "min_domain", "max", 0),
    ("random_1", "random", "random", 1),
    ("random_2", "random", "random", 2),
    ("first_min", "first", "min", 0),
    ("random_3", "random", "min", 3),
    ("split_random", "random", "split", 4),
]

SLICE_BRANCHES = 512
LNS_BRANCHES = 2000  # per LNS subproblem solve
LNS_RELAX_FRACTION = 0.3  # fraction of variables freed each round


def _vars_of_constraint(work: "ir.CpModelIR", ct: ir.ConstraintIR
                        ) -> List[int]:
    out: List[int] = []
    seen = set()

    def add(v: int) -> None:
        if 0 <= v < len(work.variables) and v not in seen:
            seen.add(v)
            out.append(v)

    def add_int(v: int, is_literal: bool) -> None:
        add((-v - 1) if (is_literal and v < 0) else v)

    def walk(obj, name: str = "") -> None:
        if isinstance(obj, ir.LinearExprIR):
            for v in obj.vars:
                add(v)
        elif isinstance(obj, int):
            # int fields are variable indices or literals only when the
            # field name says so; coefficients/values/domains are skipped
            if "literal" in name:
                add_int(obj, True)
            elif name in ("vars", "variables", "index", "target",
                          "f_direct", "f_inverse", "tails", "heads"):
                add_int(obj, False)
        elif isinstance(obj, (list, tuple)):
            for e in obj:
                walk(e, name)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name), f.name)

    walk(ct.args)
    for lit in ct.enforcement_literals:
        add(lit if lit >= 0 else -lit - 1)
    return out


def _lns_random_variables(work, rng, frac: float) -> set:
    """cp_model_lns.h RelaxRandomVariablesGenerator."""
    nvars = len(work.variables)
    k = max(1, int(nvars * frac))
    return set(rng.sample(range(nvars), min(k, nvars)))


def _lns_random_constraints(work, rng, frac: float) -> set:
    """cp_model_lns.h RelaxRandomConstraintsGenerator: free every variable
    of randomly chosen constraints until the target fraction is reached."""
    nvars = max(1, len(work.variables))
    target = max(1, int(nvars * frac))
    cts = list(range(len(work.constraints)))
    rng.shuffle(cts)
    relax: set = set()
    for ci in cts:
        relax.update(_vars_of_constraint(work, work.constraints[ci]))
        if len(relax) >= target:
            break
    return relax or _lns_random_variables(work, rng, frac)


def _lns_variable_graph(work, rng, frac: float) -> set:
    """cp_model_lns.h VariableGraphNeighborhoodGenerator: BFS over the
    variable/constraint incidence graph from a random seed variable."""
    nvars = len(work.variables)
    if nvars == 0:
        return set()
    var_to_cts: dict = {}
    for ci, ct in enumerate(work.constraints):
        for v in _vars_of_constraint(work, ct):
            var_to_cts.setdefault(v, []).append(ci)
    target = max(1, int(nvars * frac))
    relax = {rng.randrange(nvars)}
    frontier = list(relax)
    while frontier and len(relax) < target:
        v = frontier.pop(0)
        for ci in var_to_cts.get(v, []):
            for w in _vars_of_constraint(work, work.constraints[ci]):
                if w not in relax:
                    relax.add(w)
                    frontier.append(w)
                    if len(relax) >= target:
                        return relax
    return relax


def _lns_time_window(work, rng, frac: float, best: List[int]) -> set:
    """cp_model_lns.h SchedulingTimeWindowNeighborhoodGenerator: free the
    variables of intervals whose incumbent start falls in a random window;
    falls back to random variables for non-scheduling models."""
    intervals = [ct for ct in work.constraints if ct.kind == "interval"]
    if not intervals:
        return _lns_random_variables(work, rng, frac)

    def start_val(ct) -> int:
        e = ct.args.start
        return e.offset + sum(
            c * best[v] for v, c in zip(e.vars, e.coeffs)
            if v < len(best))

    starts = sorted(start_val(ct) for ct in intervals)
    lo = starts[rng.randrange(len(starts))]
    span = max(1, (starts[-1] - starts[0]))
    hi = lo + max(1, int(span * frac))
    relax: set = set()
    for ct in intervals:
        if lo <= start_val(ct) <= hi:
            relax.update(_vars_of_constraint(work, ct))
    return relax or _lns_random_variables(work, rng, frac)


def _lns_decomposition(work, rng, frac: float) -> set:
    """cp_model_lns.h DecompositionGraphNeighborhoodGenerator: free one
    connected component of the variable/constraint graph (or a BFS slice
    of it when the component is too large)."""
    nvars = len(work.variables)
    if nvars == 0:
        return set()
    parent = list(range(nvars))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for ct in work.constraints:
        vs = _vars_of_constraint(work, ct)
        for w in vs[1:]:
            ra, rb = find(vs[0]), find(w)
            if ra != rb:
                parent[rb] = ra
    comps: dict = {}
    for v in range(nvars):
        comps.setdefault(find(v), []).append(v)
    comp = list(comps.values())[rng.randrange(len(comps))]
    target = max(1, int(nvars * frac))
    if len(comp) <= target:
        return set(comp)
    # slice the component: BFS from a random member, restricted to it
    comp_set = set(comp)
    var_to_cts: dict = {}
    for ci, ct in enumerate(work.constraints):
        for v in _vars_of_constraint(work, ct):
            var_to_cts.setdefault(v, []).append(ci)
    relax = {comp[rng.randrange(len(comp))]}
    frontier = list(relax)
    while frontier and len(relax) < target:
        v = frontier.pop(0)
        for ci in var_to_cts.get(v, []):
            for w in _vars_of_constraint(work, work.constraints[ci]):
                if w in comp_set and w not in relax:
                    relax.add(w)
                    frontier.append(w)
                    if len(relax) >= target:
                        return relax
    return relax


def _interval_indices(work) -> List[int]:
    return [ci for ci, ct in enumerate(work.constraints)
            if ct.kind == "interval"]


def _lns_random_intervals(work, rng, frac: float) -> set:
    """cp_model_lns.h SchedulingNeighborhoodGenerator (RandomIntervals):
    free the variables of a random subset of interval constraints plus
    the objective-linked makespan variables stay fixed."""
    ivs = _interval_indices(work)
    if not ivs:
        return _lns_random_variables(work, rng, frac)
    k = max(1, int(len(ivs) * frac))
    chosen = rng.sample(ivs, min(k, len(ivs)))
    relax: set = set()
    for ci in chosen:
        relax.update(_vars_of_constraint(work, work.constraints[ci]))
    return relax


def _lns_resource(work, rng, frac: float) -> set:
    """cp_model_lns.h SchedulingResourceWindowsNeighborhoodGenerator: free
    every interval of one random no_overlap / cumulative resource."""
    resources = [ct for ct in work.constraints
                 if ct.kind in ("no_overlap", "cumulative")]
    if not resources:
        return _lns_random_intervals(work, rng, frac)
    res = resources[rng.randrange(len(resources))]
    relax: set = set()
    for ci in res.args.intervals:
        relax.update(_vars_of_constraint(work, work.constraints[ci]))
    return relax


def _lns_routing_path(work, rng, frac: float, best: List[int]) -> set:
    """cp_model_lns.h RoutingPathNeighborhoodGenerator: walk the incumbent
    circuit from a random node and free the arc literals (and their
    endpoints' other arcs) along a contiguous path segment."""
    circuits = [ct for ct in work.constraints
                if ct.kind in ("circuit", "routes")]
    if not circuits:
        return _lns_random_variables(work, rng, frac)
    ct = circuits[rng.randrange(len(circuits))]
    a = ct.args

    def lit_val(lit: int) -> int:
        v = lit if lit >= 0 else -lit - 1
        if v >= len(best):
            return 0
        val = best[v]
        return val if lit >= 0 else 1 - val

    succ: dict = {}
    arcs_from: dict = {}
    for t, h, lit in zip(a.tails, a.heads, a.literals):
        arcs_from.setdefault(t, []).append(lit)
        if lit_val(lit):
            succ[t] = h
    if not succ:
        return _lns_random_variables(work, rng, frac)
    nodes = list(succ.keys())
    cur = nodes[rng.randrange(len(nodes))]
    path_len = max(2, int(len(nodes) * frac))
    relax: set = set()
    for _ in range(path_len):
        for lit in arcs_from.get(cur, []):
            relax.add(lit if lit >= 0 else -lit - 1)
        if cur not in succ:
            break
        cur = succ[cur]
    return relax or _lns_random_variables(work, rng, frac)


def _lns_constraint_graph(work, rng, frac: float) -> set:
    """cp_model_lns.h ConstraintGraphNeighborhoodGenerator: BFS over
    constraint adjacency (constraints sharing a variable) from a random
    seed constraint; relaxes every variable of the visited constraints."""
    ncts = len(work.constraints)
    nvars = len(work.variables)
    if ncts == 0 or nvars == 0:
        return _lns_random_variables(work, rng, frac)
    var_to_cts: dict = {}
    for ci, ct in enumerate(work.constraints):
        for v in _vars_of_constraint(work, ct):
            var_to_cts.setdefault(v, []).append(ci)
    target = max(1, int(nvars * frac))
    seed_ci = rng.randrange(ncts)
    seen_cts = {seed_ci}
    frontier = [seed_ci]
    relax: set = set()
    while frontier and len(relax) < target:
        ci = frontier.pop(0)
        for v in _vars_of_constraint(work, work.constraints[ci]):
            relax.add(v)
            for cj in var_to_cts.get(v, []):
                if cj not in seen_cts:
                    seen_cts.add(cj)
                    frontier.append(cj)
        if len(relax) >= target:
            break
    return relax or _lns_random_variables(work, rng, frac)


def _lns_rectangles(work, rng, frac: float, best: List[int]) -> set:
    """cp_model_lns.h RandomRectanglesPackingNeighborhoodGenerator: for
    no_overlap_2d models, free the rectangles nearest (in the incumbent
    placement) to a random seed rectangle."""
    boxes = []  # (x interval ct, y interval ct)
    for ct in work.constraints:
        if ct.kind == "no_overlap_2d":
            for kx, ky in zip(ct.args.x_intervals, ct.args.y_intervals):
                boxes.append((work.constraints[kx], work.constraints[ky]))
    if not boxes:
        return _lns_random_variables(work, rng, frac)

    def start_val(ct) -> float:
        e = ct.args.start
        return e.offset + sum(c * best[v] for v, c in
                              zip(e.vars, e.coeffs) if v < len(best))

    pos = [(start_val(cx), start_val(cy)) for cx, cy in boxes]
    seed = rng.randrange(len(boxes))
    sx, sy = pos[seed]
    order = sorted(range(len(boxes)),
                   key=lambda i: (pos[i][0] - sx) ** 2 + (pos[i][1] - sy) ** 2)
    take = max(2, int(len(boxes) * frac))
    relax: set = set()
    for i in order[:take]:
        cx, cy = boxes[i]
        relax.update(_vars_of_constraint(work, cx))
        relax.update(_vars_of_constraint(work, cy))
    return relax or _lns_random_variables(work, rng, frac)


def _lns_interior(work, rng, frac: float, best: List[int]) -> set:
    """RENS/RelaxationInduced analogue without an LP in the loop: relax
    the variables whose incumbent value sits strictly INSIDE the domain
    (not pinned at a bound) — the ones the incumbent has not committed
    to an extreme, where improvement headroom lives."""
    nvars = len(work.variables)
    interior = []
    for v in range(nvars):
        d = work.variables[v].domain
        val = best[v] if v < len(best) else d.min()
        if d.min() < val < d.max():
            interior.append(v)
    if not interior:
        return _lns_random_variables(work, rng, frac)
    target = max(1, int(nvars * frac))
    rng.shuffle(interior)
    return set(interior[:target]) or _lns_random_variables(work, rng, frac)


def _lns_precedences(work, rng, frac: float) -> set:
    """SchedulingPrecedencesNeighborhoodGenerator analogue: pick a seed
    two-variable linear row (a precedence-like link) and BFS along such
    rows, relaxing the linked variables."""
    links = []  # (u, v) pairs from 2-var linear rows
    for ct in work.constraints:
        if ct.kind == "linear" and not ct.enforcement_literals \
                and len(ct.args.vars) == 2:
            links.append(tuple(ct.args.vars))
    if not links:
        return _lns_random_variables(work, rng, frac)
    adj: dict = {}
    for u, v in links:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    nvars = len(work.variables)
    target = max(2, int(nvars * frac))
    seed_u, seed_v = links[rng.randrange(len(links))]
    relax = {seed_u, seed_v}
    frontier = [seed_u, seed_v]
    while frontier and len(relax) < target:
        u = frontier.pop(0)
        for w in adj.get(u, ()):  # noqa: B007
            if w not in relax:
                relax.add(w)
                frontier.append(w)
                if len(relax) >= target:
                    break
    return relax


def _lns_local_branching(work, rng, frac: float, best: List[int]):
    """LocalBranchingLpBasedNeighborhoodGenerator analogue: relax every
    BOOLEAN variable but add a Hamming-ball constraint around the
    incumbent (sum of flips <= k).  Returns (relax_set, extra_cts)."""
    bools = [v for v, var in enumerate(work.variables)
             if var.domain.min() >= 0 and var.domain.max() <= 1
             and not var.domain.is_fixed()]
    if not bools:
        return _lns_random_variables(work, rng, frac), []
    k = max(1, int(len(bools) * frac))
    vs, cs, off = [], [], 0
    for v in bools:
        val = best[v] if v < len(best) else 0
        if val >= 1:  # flip term: 1 - x
            vs.append(v)
            cs.append(-1)
            off += 1
        else:  # flip term: x
            vs.append(v)
            cs.append(1)
    # off + sum cs*x <= k  ->  sum cs*x in (-inf, k - off]
    ball = ir.ConstraintIR("linear", ir.LinearArgs(
        vs, cs, Domain(-(2 ** 50), k - off)))
    return set(bools), [ball]


# generator rotation for the LNS fleet (reference cp_model_lns.h:93-766):
# random variables / random constraints / variable graph / constraint
# graph / scheduling time window / decomposition / random intervals /
# resource windows / routing path / packing rectangles / local branching
# — one worker advances the rotation each slice.
LNS_GENERATORS = ("random_vars", "random_constraints", "variable_graph",
                  "time_window", "decomposition", "random_intervals",
                  "resource", "routing_path", "constraint_graph",
                  "rectangles", "local_branching", "interior",
                  "precedences", "objective_focus", "arc_graph")


def _lns_objective_focus(work, rng, frac: float, best: List[int]) -> set:
    """Relax the variables carrying the largest incumbent objective
    contribution (the 'improve where the cost is' neighborhood — the
    spirit of cp_model_lns.h's objective-lb focusing generators)."""
    obj = work.objective
    if obj is None or not obj.vars:
        return _lns_random_variables(work, rng, frac)
    contrib = sorted(
        ((abs(c * best[v]) if v < len(best) else abs(c), v)
         for v, c in zip(obj.vars, obj.coeffs)),
        reverse=True)
    take = max(2, int(len(contrib) * frac))
    # randomize the tail so repeated slices differ
    head = [v for _, v in contrib[:take]]
    extra = [v for _, v in contrib[take:]]
    rng.shuffle(extra)
    return set(head + extra[: take // 2])


def _lns_arc_graph(work, rng, frac: float, best: List[int]) -> set:
    """cp_model_lns.h ArcGraphNeighborhoodGenerator: for circuit/routes
    models, free the literals of arcs touching a random node bundle plus
    the arcs active in the incumbent around it."""
    arcs = []  # (tail, head, literal)
    for ct in work.constraints:
        if ct.kind == "circuit":
            a = ct.args
            arcs.extend(zip(a.tails, a.heads, a.literals))
    if not arcs:
        return _lns_random_variables(work, rng, frac)
    nodes = {t for t, _, _ in arcs} | {h for _, h, _ in arcs}
    seeds = rng.sample(sorted(nodes), max(1, int(len(nodes) * frac)))
    seeds = set(seeds)
    relax: set = set()
    for t, h, lit in arcs:
        if t in seeds or h in seeds:
            relax.add(ir.literal_index(lit))
    return relax or _lns_random_variables(work, rng, frac)


class LnsWorker:
    """Large-neighborhood-search worker (reference cp_model_lns.h): fix a
    subset of variables to the incumbent, search the free rest under the
    objective bound.  Each worker rotates through the generator catalogue
    (random variables / random constraints / variable graph / scheduling
    time window), mirroring the reference's generator fleet."""

    def __init__(self, work: "ir.CpModelIR", deadline: float,
                 seed: int) -> None:
        import random as _random

        self.work = work
        self.deadline = deadline
        self._rng = _random.Random(seed)
        self._gen_idx = seed % len(LNS_GENERATORS)
        self.num_branches = 0
        self.num_conflicts = 0

    def _relax_set(self, best: List[int]) -> set:
        gen = LNS_GENERATORS[self._gen_idx]
        self.last_generator = gen
        self._gen_idx = (self._gen_idx + 1) % len(LNS_GENERATORS)
        f = LNS_RELAX_FRACTION
        self._extra_cts: List[ir.ConstraintIR] = []
        if gen == "random_constraints":
            return _lns_random_constraints(self.work, self._rng, f)
        if gen == "variable_graph":
            return _lns_variable_graph(self.work, self._rng, f)
        if gen == "time_window":
            return _lns_time_window(self.work, self._rng, f, best)
        if gen == "decomposition":
            return _lns_decomposition(self.work, self._rng, f)
        if gen == "random_intervals":
            return _lns_random_intervals(self.work, self._rng, f)
        if gen == "resource":
            return _lns_resource(self.work, self._rng, f)
        if gen == "routing_path":
            return _lns_routing_path(self.work, self._rng, f, best)
        if gen == "constraint_graph":
            return _lns_constraint_graph(self.work, self._rng, f)
        if gen == "rectangles":
            return _lns_rectangles(self.work, self._rng, f, best)
        if gen == "local_branching":
            relax, extra = _lns_local_branching(self.work, self._rng, f,
                                                best)
            self._extra_cts = extra
            return relax
        if gen == "interior":
            return _lns_interior(self.work, self._rng, f, best)
        if gen == "precedences":
            return _lns_precedences(self.work, self._rng, f)
        if gen == "objective_focus":
            return _lns_objective_focus(self.work, self._rng, f, best)
        if gen == "arc_graph":
            return _lns_arc_graph(self.work, self._rng, f, best)
        return _lns_random_variables(self.work, self._rng, f)

    def slice(self, best: Optional[List[int]],
              bound_ct: Optional[ir.ConstraintIR],
              cb) -> None:
        if best is None:
            return
        nvars = len(self.work.variables)
        relax = self._relax_set(best)
        fixed_idx = [v for v in range(nvars) if v not in relax]
        cts = list(self.work.constraints)
        cts.extend(getattr(self, "_extra_cts", []))
        if bound_ct is not None:
            cts.append(bound_ct)
        for v in fixed_idx:
            val = best[v] if v < len(best) else 0
            if not self.work.variables[v].domain.contains(val):
                continue
            cts.append(ir.ConstraintIR(
                "linear", ir.LinearArgs([v], [1], Domain(val, val))
            ))
        sub = dataclasses.replace(self.work, constraints=cts)
        e = Engine(sub, deadline=self.deadline, max_branches=LNS_BRANCHES,
                   var_rule="random", value_rule="random",
                   seed=self._rng.randrange(1 << 30))
        doms = e.initial_domains()
        try:
            if e.root_propagate(doms):
                e.search(doms, cb)
        except TimeoutError:
            pass  # deadline hit inside the sub-solve: just end the slice
        finally:
            self.num_branches += e.num_branches
            self.num_conflicts += e.num_conflicts


@dataclasses.dataclass
class PortfolioOutcome:
    # "optimal": best_solution proven optimal (or search exhausted)
    # "infeasible": proven no solution (under current bound none existed
    #                and no incumbent)
    # "limit": stopped by time/branch limits
    outcome: str
    num_branches: int
    num_conflicts: int
    # proven lower bound on the INTERNAL (minimization-sense, offset
    # included) objective from the shaving worker, or None
    proven_bound: Optional[float] = None
    # worker attribution: which worker produced each improvement/bound
    wins: Optional[dict] = None
    # clauses exchanged between LCG-core workers (SharedClausesManager
    # parity; binary + unit facts)
    num_shared_clauses: int = 0


class ShavingWorker:
    """Objective shaving on the incremental LCG core (reference
    ObjectiveShavingSolver, cp_model_solver.cc:2711): repeatedly probe
    'objective <= test' with a conflict budget; UNSAT raises the proven
    LOWER bound, SAT yields an incumbent candidate.  Learnt clauses
    persist across probes (one native solver instance)."""

    def __init__(self, work: "ir.CpModelIR", deadline: float):
        self.ok = False
        self.deadline = deadline
        obj = work.objective
        if obj is None or not obj.vars:
            return
        try:
            from ortools_tpu_torch.sat.lcg import compile_model
        except Exception:
            return
        prog = compile_model(work)
        if prog is None:
            return
        self.sense = -1 if obj.maximize else 1
        merged = {}
        for v, c in zip(obj.vars, obj.coeffs):
            merged[v] = merged.get(v, 0) + self.sense * c
        terms = [(v, c) for v, c in merged.items() if c != 0]
        if not terms:
            return
        doms = [v.domain for v in work.variables]
        lo = sum(min(c * doms[v].min(), c * doms[v].max())
                 for v, c in terms)
        hi = sum(max(c * doms[v].min(), c * doms[v].max())
                 for v, c in terms)
        if abs(int(lo)) > 2**50 or abs(int(hi)) > 2**50:
            return
        s = prog.s
        self.obj_x = s.new_int(int(lo), int(hi))
        s.add_linear([], [prog.xs[v] for v, _ in terms] + [self.obj_x],
                     [c for _, c in terms] + [-1], 0, 0)
        self.prog = prog
        self.s = s
        self.offset = self.sense * obj.offset
        self.lb = int(lo)  # proven: obj_sum >= lb
        self.assumptions = [prog.lit(l) for l in work.assumptions]
        self.ok = True

    def slice(self, best_internal: Optional[float],
              conflict_budget: int = 5000):
        """One probe.  Returns ("bound", internal_lb) | ("solution",
        values) | None.  ``best_internal`` is the incumbent's internal
        objective (sense * value, offset included) or None."""
        import time as _time

        from ortools_tpu_torch.sat.lcg import FALSE_EXT, SAT, TRUE_EXT, UNSAT

        if not self.ok or _time.perf_counter() > self.deadline:
            return None
        ub_sum = (int(best_internal - self.offset) - 1
                  if best_internal is not None else None)
        if ub_sum is not None and self.lb > ub_sum:
            return ("bound", float(self.lb + self.offset))
        if ub_sum is None:
            probe = self.lb  # no incumbent: probe the trivial bound
        else:
            probe = self.lb + max(0, (ub_sum - self.lb) // 4)
        a = self.s.le(self.obj_x, probe)
        if a == FALSE_EXT:
            self.lb = probe + 1
            return ("bound", float(self.lb + self.offset))
        extra = [] if a == TRUE_EXT else [a]
        st = self.s.solve(self.assumptions + extra,
                          conflict_budget=conflict_budget,
                          time_budget=max(
                              0.05, self.deadline - _time.perf_counter()))
        if st == SAT:
            return ("solution", self.prog.decode())
        if st == UNSAT:
            self.lb = probe + 1
            return ("bound", float(self.lb + self.offset))
        return None


class LbTreeWorker:
    """Lower-bound tree search on the incremental LCG core (reference
    ``ortools/sat/lb_tree_search.h``): an explicit tree of decisions whose
    open leaves each carry a PROVEN lower bound on the objective inside
    their subtree; the global proven bound is the minimum over open
    leaves.  Each slice takes the weakest leaf and either (a) raises its
    bound by a budgeted UNSAT probe of ``objective <= target`` under the
    leaf's decisions, (b) finds an incumbent (the probe is SAT), or
    (c) branches the leaf when the probe is inconclusive.  Learnt clauses
    persist globally across probes (assumption-based solves)."""

    _MAX_LEAVES = 512

    def __init__(self, work: "ir.CpModelIR", deadline: float):
        self.ok = False
        self.deadline = deadline
        obj = work.objective
        if obj is None or not obj.vars:
            return
        try:
            from ortools_tpu_torch.sat.lcg import compile_model
        except Exception:
            return
        prog = compile_model(work)
        if prog is None:
            return
        self.sense = -1 if obj.maximize else 1
        merged: dict = {}
        for v, c in zip(obj.vars, obj.coeffs):
            merged[v] = merged.get(v, 0) + self.sense * c
        terms = [(v, c) for v, c in merged.items() if c != 0]
        if not terms:
            return
        doms = [v.domain for v in work.variables]
        lo = sum(min(c * doms[v].min(), c * doms[v].max())
                 for v, c in terms)
        hi = sum(max(c * doms[v].min(), c * doms[v].max())
                 for v, c in terms)
        if abs(int(lo)) > 2**50 or abs(int(hi)) > 2**50:
            return
        s = prog.s
        self.obj_x = s.new_int(int(lo), int(hi))
        s.add_linear([], [prog.xs[v] for v, _ in terms] + [self.obj_x],
                     [c for _, c in terms] + [-1], 0, 0)
        self.prog = prog
        self.s = s
        self.offset = self.sense * obj.offset
        self.assumptions = [prog.lit(l) for l in work.assumptions]
        # branching order: objective variables by |coeff| * range, then
        # the remaining variables by range
        rng = {v: int(doms[v].max() - doms[v].min())
               for v in range(len(doms))}
        obj_vars = sorted((v for v, _ in terms),
                          key=lambda v: -abs(merged[v]) * max(1, rng[v]))
        rest = sorted((v for v in range(len(doms))
                       if v not in merged and rng[v] > 0),
                      key=lambda v: -rng[v])
        self.branch_order = [v for v in obj_vars if rng[v] > 0] + rest
        self.base_ranges = {v: (int(doms[v].min()), int(doms[v].max()))
                            for v in self.branch_order}
        # leaves: (bound, depth, lits, ranges, step, budget)
        self.leaves: List[dict] = [dict(
            bound=int(lo), depth=0, lits=[], ranges={}, step=1,
            budget=2000)]
        self.num_branches = 0
        self.num_conflicts = 0
        self._last_reported = -math.inf
        self.ok = True

    def _proven(self) -> float:
        if not self.leaves:
            return math.inf
        return float(min(lf["bound"] for lf in self.leaves) + self.offset)

    def _pick_branch_var(self, leaf: dict):
        for v in self.branch_order:
            lo, hi = leaf["ranges"].get(v, self.base_ranges[v])
            if hi > lo:
                return v, lo, hi
        return None

    def slice(self, best_internal: Optional[float]):
        """One step.  Returns ("bound", internal_lb) | ("solution",
        values) | None, mirroring ShavingWorker.slice."""
        import time as _time

        from ortools_tpu_torch.sat.lcg import FALSE_EXT, SAT, TRUE_EXT, UNSAT

        if not self.ok or _time.perf_counter() > self.deadline:
            return None
        ub_sum = (int(best_internal - self.offset) - 1
                  if best_internal is not None else None)
        if ub_sum is not None:
            self.leaves = [lf for lf in self.leaves
                           if lf["bound"] <= ub_sum]
        if not self.leaves:
            # every subtree proves bound > ub_sum: incumbent is optimal
            return ("bound", float(best_internal)) \
                if best_internal is not None else None
        leaf = min(self.leaves, key=lambda lf: (lf["bound"], -lf["depth"]))
        target = leaf["bound"] + leaf["step"] - 1
        if ub_sum is not None:
            target = min(target, ub_sum)
        a = self.s.le(self.obj_x, target)
        if a == FALSE_EXT:
            leaf["bound"] = target + 1
            return self._report()
        extra = [] if a == TRUE_EXT else [a]
        st = self.s.solve(
            self.assumptions + leaf["lits"] + extra,
            conflict_budget=leaf["budget"],
            time_budget=max(0.05, self.deadline - _time.perf_counter()))
        self.num_conflicts = self.s.num_conflicts
        if st == SAT:
            return ("solution", self.prog.decode())
        if st == UNSAT:
            leaf["bound"] = target + 1
            leaf["step"] = min(leaf["step"] * 2, 1 << 20)
            return self._report()
        # inconclusive: branch the leaf (or deepen its budget at the cap)
        leaf["step"] = 1
        pick = self._pick_branch_var(leaf)
        if pick is None or len(self.leaves) >= self._MAX_LEAVES:
            leaf["budget"] = min(leaf["budget"] * 2, 1 << 18)
            return None
        v, lo, hi = pick
        mid = (lo + hi) // 2
        g = self.s.ge(self.prog.xs[v], mid + 1)
        if g in (TRUE_EXT, FALSE_EXT):
            # degenerate literal: fix the range and retry next slice
            leaf["ranges"] = dict(leaf["ranges"])
            leaf["ranges"][v] = ((mid + 1, hi) if g == TRUE_EXT
                                 else (lo, mid))
            return None
        self.num_branches += 1
        down = dict(bound=leaf["bound"], depth=leaf["depth"] + 1,
                    lits=leaf["lits"] + [-g],
                    ranges={**leaf["ranges"], v: (lo, mid)},
                    step=1, budget=leaf["budget"])
        up = dict(bound=leaf["bound"], depth=leaf["depth"] + 1,
                  lits=leaf["lits"] + [g],
                  ranges={**leaf["ranges"], v: (mid + 1, hi)},
                  step=1, budget=leaf["budget"])
        self.leaves.remove(leaf)
        self.leaves.extend([down, up])
        return None

    def _report(self):
        b = self._proven()
        if b > self._last_reported:
            self._last_reported = b
            return ("bound", b)
        return None


class InterleavedPortfolio:
    def __init__(self, work: ir.CpModelIR, num_workers: int,
                 deadline: float, max_branches: int,
                 num_lns: int = 0, use_shaving: bool = True,
                 share_clauses: bool = True) -> None:
        self.share_clauses = share_clauses
        self.work = work
        n_tree = max(1, num_workers - num_lns)
        self.configs = [
            WORKER_CONFIGS[i % len(WORKER_CONFIGS)]
            for i in range(n_tree)
        ]
        self.lns_workers = [
            LnsWorker(work, deadline, seed=100 + k) for k in range(num_lns)
        ]
        self.deadline = deadline
        self.max_branches = max_branches
        self.num_branches = 0
        self.num_conflicts = 0
        self.proven_bound: Optional[float] = None
        self.wins: dict = {}
        self.shaver: Optional[ShavingWorker] = None
        if use_shaving and work.objective is not None and num_workers >= 2:
            cand = ShavingWorker(work, deadline)
            if cand.ok:
                self.shaver = cand
        self.num_shared_clauses = 0
        self.lb_tree: Optional[LbTreeWorker] = None
        if use_shaving and work.objective is not None and num_workers >= 3:
            cand2 = LbTreeWorker(work, deadline)
            if cand2.ok:
                self.lb_tree = cand2

    def _win(self, who: str) -> None:
        self.wins[who] = self.wins.get(who, 0) + 1

    def _outcome(self, status: str) -> "PortfolioOutcome":
        return PortfolioOutcome(status, self.num_branches,
                                self.num_conflicts,
                                proven_bound=self.proven_bound,
                                wins=dict(self.wins),
                                num_shared_clauses=self.num_shared_clauses)

    def _build_engines(self, bound_ct: Optional[ir.ConstraintIR]
                       ) -> List[Engine]:
        cts = list(self.work.constraints)
        if bound_ct is not None:
            cts = cts + [bound_ct]
        model = dataclasses.replace(self.work, constraints=cts)
        engines = []
        hints = dict(self.work.solution_hint)
        for name, var_rule, value_rule, seed in self.configs:
            e = Engine(model, deadline=self.deadline,
                       max_branches=self.max_branches,
                       var_rule=var_rule, value_rule=value_rule, seed=seed,
                       value_hints=hints)
            engines.append(e)
        return engines

    def run(self, on_candidate: Callable[[List[int]], bool],
            bound_ct_builder: Callable[[], Optional[ir.ConstraintIR]],
            stop_on_first: bool = False,
            best_provider: Optional[Callable[[], Optional[List[int]]]]
            = None,
            best_obj_provider: Optional[Callable[[], Optional[float]]]
            = None) -> PortfolioOutcome:
        """Interleave workers until the search is decided.

        ``on_candidate(values) -> improved`` is called for each solution a
        worker finds; when it returns True (incumbent improved) all workers
        restart against the new bound from ``bound_ct_builder()``.
        """
        engines = self._build_engines(bound_ct_builder())
        for e in engines:
            doms = e.initial_domains()
            if not e.root_propagate(doms):
                # bound/root infeasible: proven (any worker's root proof
                # is a proof for all — same model)
                return self._outcome("infeasible")
            e.start_search(doms)

        active = list(range(len(engines)))
        while True:
            if time.perf_counter() > self.deadline:
                return self._outcome("limit")
            if self.num_branches >= self.max_branches:
                return self._outcome("limit")
            restart = [False]
            found: List[Optional[List[int]]] = [None]

            def cb(values: List[int]) -> bool:
                found[0] = values
                return False  # pause this worker; portfolio decides

            for wi in list(active):
                e = engines[wi]
                outcome = e.search_budget(cb, SLICE_BRANCHES)
                self.num_branches += 0  # engines track their own; sum below
                if found[0] is not None:
                    improved = on_candidate(found[0])
                    found[0] = None
                    if stop_on_first:
                        self._accumulate(engines)
                        return self._outcome("stopped")
                    if improved:
                        self._win(f"tree:{self.configs[wi][0]}")
                        restart[0] = True
                        break
                    # not improving: worker continues next slice (its tree
                    # already excludes nothing; bound unchanged)
                    continue
                if outcome == "done":
                    # this worker exhausted the (bounded) tree: proven
                    self._accumulate(engines)
                    return self._outcome("optimal")
                if outcome == "limit":
                    self._accumulate(engines)
                    return self._outcome("limit")
            # LNS workers: one neighborhood solve per round
            if not restart[0] and self.lns_workers and \
                    best_provider is not None:
                for lw in self.lns_workers:
                    lw.slice(best_provider(), bound_ct_builder(), cb)
                    if found[0] is not None:
                        improved = on_candidate(found[0])
                        found[0] = None
                        if improved:
                            self._win("lns:" + getattr(
                                lw, "last_generator", "?"))
                            restart[0] = True
                            break
            # objective shaving (reference ObjectiveShavingSolver): raise
            # the proven lower bound / find incumbents on the LCG core
            if not restart[0] and self.shaver is not None:
                best_obj = (best_obj_provider()
                            if best_obj_provider is not None else None)
                r = self.shaver.slice(best_obj)
                if r is not None:
                    kind, payload = r
                    if kind == "solution":
                        improved = on_candidate(list(payload))
                        if improved:
                            self._win("objective_shaving")
                            restart[0] = True
                    else:  # proven lower bound (internal sense)
                        if (self.proven_bound is None
                                or payload > self.proven_bound):
                            self.proven_bound = payload
                            self._win("objective_shaving_bound")
                        if best_obj is not None and \
                                self.proven_bound >= best_obj:
                            self._accumulate(engines)
                            return self._outcome("optimal")
            # lower-bound tree search (reference lb_tree_search.h): the
            # min over its open leaves is a global proven lower bound
            if not restart[0] and self.lb_tree is not None:
                best_obj = (best_obj_provider()
                            if best_obj_provider is not None else None)
                r = self.lb_tree.slice(best_obj)
                if r is not None:
                    kind, payload = r
                    if kind == "solution":
                        improved = on_candidate(list(payload))
                        if improved:
                            self._win("lb_tree")
                            restart[0] = True
                    else:
                        if (self.proven_bound is None
                                or payload > self.proven_bound):
                            self.proven_bound = payload
                            self._win("lb_tree_bound")
                        if best_obj is not None and \
                                self.proven_bound >= best_obj:
                            self._accumulate(engines)
                            return self._outcome("optimal")
            # clause sharing (reference SharedClausesManager,
            # synchronization.h:538): at this fixed synchronization
            # point the LCG-core workers swap their short learnt
            # clauses (binary + units, described model-level).  The
            # exchange point is deterministic in interleaved mode —
            # same rounds, same clauses, same order.
            if self.share_clauses and self.shaver is not None \
                    and self.lb_tree is not None \
                    and self.shaver.ok and self.lb_tree.ok:
                from_shaver = self.shaver.s.export_shared()
                from_lbtree = self.lb_tree.s.export_shared()
                if len(from_lbtree):
                    self.shaver.s.import_shared(from_lbtree)
                if len(from_shaver):
                    self.lb_tree.s.import_shared(from_shaver)
                self.num_shared_clauses += (
                    len(from_shaver) + len(from_lbtree))
            if restart[0]:
                self._accumulate(engines)
                engines = self._build_engines(bound_ct_builder())
                dead = False
                for e in engines:
                    doms = e.initial_domains()
                    if not e.root_propagate(doms):
                        dead = True
                        break
                    e.start_search(doms)
                if dead:
                    # nothing better exists: current incumbent optimal
                    return self._outcome("optimal")
                active = list(range(len(engines)))

    def _accumulate(self, engines: List[Engine]) -> None:
        self.num_branches += sum(e.num_branches for e in engines)
        self.num_conflicts += sum(e.num_conflicts for e in engines)
        for lw in self.lns_workers:
            self.num_branches += lw.num_branches
            self.num_conflicts += lw.num_conflicts
            lw.num_branches = 0
        if self.lb_tree is not None:
            self.num_branches += self.lb_tree.num_branches
            self.lb_tree.num_branches = 0
            lw.num_conflicts = 0
