"""CP model validation and solution checking.

Capability parity: ``ortools/sat/cp_model_checker.{h,cc}`` —
``ValidateInputCpModel`` and ``SolutionIsFeasible``.  The reference re-checks
EVERY returned solution against the original proto
(cp_model_solver.cc:4376); this framework keeps the same runtime contract:
sat/solver.py refuses to return a solution this checker rejects.

All arithmetic here is exact Python int arithmetic (no saturation needed on
the host; the reference saturates because it computes in int64).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain, INT_MAX, INT_MIN

_SUPPORTED = {
    "bool_or", "bool_and", "at_most_one", "exactly_one", "bool_xor",
    "linear", "all_diff", "lin_max", "int_prod", "int_div", "int_mod",
    "element", "table", "interval", "no_overlap", "cumulative", "circuit",
    "inverse", "automaton", "reservoir", "no_overlap_2d",
}


def validate_model(model: ir.CpModelIR) -> List[str]:
    errs: List[str] = []
    nvars = len(model.variables)

    def check_lit(lit: int, where: str) -> None:
        v = ir.literal_index(lit)
        if not (0 <= v < nvars):
            errs.append(f"{where}: literal {lit} out of range")
        elif not model.is_boolean_var(v):
            errs.append(f"{where}: literal {lit} refers to non-Boolean "
                        f"variable {v} with domain "
                        f"{model.variables[v].domain}")

    def check_expr(e: ir.LinearExprIR, where: str) -> None:
        if len(e.vars) != len(e.coeffs):
            errs.append(f"{where}: vars/coeffs length mismatch")
        for v in e.vars:
            if not (0 <= v < nvars):
                errs.append(f"{where}: variable {v} out of range")

    for i, v in enumerate(model.variables):
        if v.domain.is_empty():
            errs.append(f"variable {i} ('{v.name}') has an empty domain")

    for ci, ct in enumerate(model.constraints):
        where = f"constraint {ci} ({ct.kind})"
        if ct.kind not in _SUPPORTED:
            errs.append(f"{where}: unsupported constraint kind")
            continue
        for lit in ct.enforcement_literals:
            check_lit(lit, where + " enforcement")
        a = ct.args
        if ct.kind in ("bool_or", "bool_and", "at_most_one", "exactly_one",
                       "bool_xor"):
            for lit in a.literals:
                check_lit(lit, where)
        elif ct.kind == "linear":
            check_expr(ir.LinearExprIR(a.vars, a.coeffs, 0), where)
        elif ct.kind == "all_diff":
            for e in a.exprs:
                check_expr(e, where)
        elif ct.kind == "lin_max":
            check_expr(a.target, where)
            if not a.exprs:
                errs.append(f"{where}: no operands")
            for e in a.exprs:
                check_expr(e, where)
        elif ct.kind == "int_prod":
            check_expr(a.target, where)
            for e in a.exprs:
                check_expr(e, where)
        elif ct.kind in ("int_div", "int_mod"):
            check_expr(a.target, where)
            check_expr(a.num, where)
            den = a.den if ct.kind == "int_div" else a.mod
            check_expr(den, where)
            # zero divisor must be excluded by the domain
            if not den.vars:
                if den.offset == 0:
                    errs.append(f"{where}: constant zero divisor")
        elif ct.kind == "element":
            check_expr(a.index, where)
            check_expr(a.target, where)
            for e in a.exprs:
                check_expr(e, where)
        elif ct.kind == "table":
            for e in a.exprs:
                check_expr(e, where)
        elif ct.kind == "interval":
            check_expr(a.start, where)
            check_expr(a.size, where)
            check_expr(a.end, where)
        elif ct.kind in ("no_overlap", "cumulative"):
            idxs = a.intervals
            for k in idxs:
                if not (0 <= k < len(model.constraints)) or (
                    model.constraints[k].kind != "interval"
                ):
                    errs.append(f"{where}: index {k} is not an interval")
            if ct.kind == "cumulative":
                check_expr(a.capacity, where)
                if len(a.demands) != len(a.intervals):
                    errs.append(f"{where}: demands/intervals mismatch")
                for e in a.demands:
                    check_expr(e, where)
        elif ct.kind == "circuit":
            if not (len(a.tails) == len(a.heads) == len(a.literals)):
                errs.append(f"{where}: arcs arrays length mismatch")
            for lit in a.literals:
                check_lit(lit, where)
        elif ct.kind == "inverse":
            if len(a.f_direct) != len(a.f_inverse):
                errs.append(f"{where}: direct/inverse length mismatch")
        elif ct.kind == "automaton":
            for e in a.exprs:
                check_expr(e, where)
            if not (len(a.transition_tail) == len(a.transition_label)
                    == len(a.transition_head)):
                errs.append(f"{where}: transition arrays length mismatch")
        elif ct.kind == "reservoir":
            if len(a.time_exprs) != len(a.level_changes):
                errs.append(f"{where}: times/changes length mismatch")
            for e in a.time_exprs + a.level_changes:
                check_expr(e, where)
            for e in a.level_changes:
                if e.vars:
                    errs.append(f"{where}: variable level changes are not "
                                "supported")
                    break
            if a.active_literals and len(a.active_literals) != len(
                a.time_exprs
            ):
                errs.append(f"{where}: active_literals length mismatch")
            for lit in a.active_literals:
                check_lit(lit, where)
            if a.min_level > 0 or a.max_level < 0:
                errs.append(
                    f"{where}: level 0 (initial) must lie in "
                    f"[min_level, max_level]"
                )
        elif ct.kind == "no_overlap_2d":
            if len(a.x_intervals) != len(a.y_intervals):
                errs.append(f"{where}: x/y interval count mismatch")
            for k in a.x_intervals + a.y_intervals:
                if not (0 <= k < len(model.constraints)) or (
                    model.constraints[k].kind != "interval"
                ):
                    errs.append(f"{where}: index {k} is not an interval")
    if model.objective is not None:
        check_expr(
            ir.LinearExprIR(model.objective.vars, model.objective.coeffs, 0),
            "objective",
        )
    for v, _ in model.solution_hint:
        if not (0 <= v < nvars):
            errs.append(f"hint: variable {v} out of range")
    for lit in model.assumptions:
        check_lit(lit, "assumptions")
    return errs


def _lit_value(lit: int, values: Sequence[int]) -> bool:
    v = values[ir.literal_index(lit)]
    return bool(v) if lit >= 0 else not bool(v)


def _interval_fields(model: ir.CpModelIR, k: int, values: Sequence[int]):
    a = model.constraints[k].args
    return (ir.eval_expr(a.start, values), ir.eval_expr(a.size, values),
            ir.eval_expr(a.end, values))


def _interval_present(model: ir.CpModelIR, k: int,
                      values: Sequence[int]) -> bool:
    return all(_lit_value(l, values)
               for l in model.constraints[k].enforcement_literals)


def constraint_is_feasible(model: ir.CpModelIR, ct: ir.ConstraintIR,
                           values: Sequence[int]) -> bool:
    if not all(_lit_value(l, values) for l in ct.enforcement_literals):
        return True  # not enforced
    a = ct.args
    k = ct.kind
    if k == "bool_or":
        return any(_lit_value(l, values) for l in a.literals)
    if k == "bool_and":
        return all(_lit_value(l, values) for l in a.literals)
    if k == "at_most_one":
        return sum(_lit_value(l, values) for l in a.literals) <= 1
    if k == "exactly_one":
        return sum(_lit_value(l, values) for l in a.literals) == 1
    if k == "bool_xor":
        return sum(_lit_value(l, values) for l in a.literals) % 2 == 1
    if k == "linear":
        s = sum(c * values[v] for v, c in zip(a.vars, a.coeffs))
        return a.domain.contains(s)
    if k == "all_diff":
        vals = [ir.eval_expr(e, values) for e in a.exprs]
        return len(set(vals)) == len(vals)
    if k == "lin_max":
        return ir.eval_expr(a.target, values) == max(
            ir.eval_expr(e, values) for e in a.exprs
        )
    if k == "int_prod":
        p = 1
        for e in a.exprs:
            p *= ir.eval_expr(e, values)
        return ir.eval_expr(a.target, values) == p
    if k == "int_div":
        den = ir.eval_expr(a.den, values)
        if den == 0:
            return False
        num = ir.eval_expr(a.num, values)
        q = abs(num) // abs(den)
        if (num >= 0) != (den > 0):
            q = -q
        return ir.eval_expr(a.target, values) == q
    if k == "int_mod":
        mod = ir.eval_expr(a.mod, values)
        if mod == 0:
            return False
        num = ir.eval_expr(a.num, values)
        r = abs(num) % abs(mod)
        if num < 0:
            r = -r
        return ir.eval_expr(a.target, values) == r
    if k == "element":
        idx = ir.eval_expr(a.index, values)
        if not (0 <= idx < len(a.exprs)):
            return False
        return ir.eval_expr(a.exprs[idx], values) == ir.eval_expr(
            a.target, values
        )
    if k == "table":
        t = tuple(ir.eval_expr(e, values) for e in a.exprs)
        return (t not in a.values) if a.negated else (t in a.values)
    if k == "interval":
        s, z, e = (ir.eval_expr(a.start, values),
                   ir.eval_expr(a.size, values),
                   ir.eval_expr(a.end, values))
        return z >= 0 and s + z == e
    if k == "no_overlap":
        # Reference semantics (cp_model_checker.cc
        # NoOverlapConstraintIsFeasible): a feasible *ordering* must exist,
        # and size-0 intervals DO matter (cp_model.proto:131-133) — a point
        # interval strictly inside another interval is infeasible.
        spans = []
        for kk in a.intervals:
            if not _interval_present(model, kk, values):
                continue
            s, z, _ = _interval_fields(model, kk, values)
            spans.append((s, z))
        spans.sort()
        prev_end = None
        for s, z in spans:
            if prev_end is not None and s < prev_end:
                return False
            prev_end = s + z
        return True
    if k == "cumulative":
        cap = ir.eval_expr(a.capacity, values)
        events = []
        for kk, dem in zip(a.intervals, a.demands):
            if not _interval_present(model, kk, values):
                continue
            s, z, e = _interval_fields(model, kk, values)
            d = ir.eval_expr(dem, values)
            if d < 0:
                return False
            if z > 0 and d > 0:
                events.append((s, d))
                events.append((e, -d))
        events.sort()
        load = 0
        # sweep; ends at t processed before starts at t (end-exclusive)
        i = 0
        while i < len(events):
            t = events[i][0]
            while i < len(events) and events[i][0] == t and events[i][1] < 0:
                load += events[i][1]
                i += 1
            while i < len(events) and events[i][0] == t:
                load += events[i][1]
                i += 1
            if load > cap:
                return False
        return True
    if k == "circuit":
        nexts = {}
        nodes = set()
        for t, h, lit in zip(a.tails, a.heads, a.literals):
            nodes.add(t)
            nodes.add(h)
            if _lit_value(lit, values):
                if t in nexts:
                    return False
                nexts[t] = h
        # every node with a selected outgoing arc or self-loop rules:
        # nodes with a true self-loop are skipped; the rest form one cycle.
        active = {t: h for t, h in nexts.items() if t != h}
        skipped = {t for t, h in nexts.items() if t == h}
        must_visit = nodes - skipped
        if not must_visit:
            return True
        if set(active.keys()) != must_visit:
            return False
        if set(active.values()) != must_visit:
            return False
        start = next(iter(must_visit))
        seen = set()
        cur = start
        while cur not in seen:
            seen.add(cur)
            cur = active[cur]
        return seen == must_visit and cur == start
    if k == "inverse":
        nn = len(a.f_direct)
        f = [values[v] for v in a.f_direct]
        g = [values[v] for v in a.f_inverse]
        if any(not (0 <= x < nn) for x in f + g):
            return False
        return all(g[f[i]] == i for i in range(nn))
    if k == "automaton":
        state = a.starting_state
        trans = {
            (t, l): h for t, l, h in zip(
                a.transition_tail, a.transition_label, a.transition_head
            )
        }
        for e in a.exprs:
            label = ir.eval_expr(e, values)
            key = (state, label)
            if key not in trans:
                return False
            state = trans[key]
        return state in a.final_states
    if k == "reservoir":
        events = []
        for i, (te, ce) in enumerate(zip(a.time_exprs, a.level_changes)):
            if a.active_literals and not _lit_value(a.active_literals[i],
                                                    values):
                continue
            events.append((ir.eval_expr(te, values),
                           ir.eval_expr(ce, values)))
        events.sort()
        level = 0
        i = 0
        while i < len(events):
            t = events[i][0]
            while i < len(events) and events[i][0] == t:
                level += events[i][1]
                i += 1
            if not (a.min_level <= level <= a.max_level):
                return False
        return True
    if k == "no_overlap_2d":
        # Reference semantics (cp_model_checker.cc
        # NoOverlap2DConstraintIsFeasible): boxes i,j are feasible iff their
        # x-intervals are disjoint (e1<=s2 or e2<=s1) OR their y-intervals
        # are.  Zero-area boxes are NOT skipped: a point box strictly inside
        # a box, or a line box crossing another box, violates
        # (cp_model.proto:142-146).
        boxes = []
        for kx, ky in zip(a.x_intervals, a.y_intervals):
            if not (_interval_present(model, kx, values)
                    and _interval_present(model, ky, values)):
                continue
            xs, _, xe = _interval_fields(model, kx, values)
            ys, _, ye = _interval_fields(model, ky, values)
            boxes.append((xs, xe, ys, ye))
        for i in range(len(boxes)):
            for j in range(i + 1, len(boxes)):
                x1, e1, y1, f1 = boxes[i]
                x2, e2, y2, f2 = boxes[j]
                x_disjoint = e1 <= x2 or e2 <= x1
                y_disjoint = f1 <= y2 or f2 <= y1
                if not x_disjoint and not y_disjoint:
                    return False
        return True
    raise ValueError(f"unknown constraint kind {k}")


def solution_is_feasible(model: ir.CpModelIR,
                         values: Sequence[int]) -> bool:
    if len(values) != len(model.variables):
        return False
    for i, v in enumerate(model.variables):
        if not v.domain.contains(int(values[i])):
            return False
    return all(
        constraint_is_feasible(model, ct, values)
        for ct in model.constraints
        if ct.kind != "interval" or True  # intervals checked directly too
    )
