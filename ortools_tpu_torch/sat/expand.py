"""High-level constraint expansion.

Capability parity: ``ortools/sat/cp_model_expand.{h,cc}`` — rewrites
automaton, reservoir and no_overlap_2d constraints into the primitive
kinds the engine propagates (tables, linear, booleans), adding fresh
variables as needed.  The ORIGINAL model is kept by the solve facade for
solution checking; only the engine sees the expanded model.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain

_EXPANDED_KINDS = {"automaton", "reservoir", "no_overlap_2d"}


def expand_model(model: ir.CpModelIR) -> ir.CpModelIR:
    """Return a model containing only engine-supported constraint kinds.
    If nothing needs expansion the input is returned unchanged."""
    if not any(c.kind in _EXPANDED_KINDS for c in model.constraints):
        return model
    out = ir.CpModelIR(
        name=model.name,
        variables=list(model.variables),
        constraints=[],
        objective=model.objective,
        search_strategies=list(model.search_strategies),
        solution_hint=list(model.solution_hint),
        assumptions=list(model.assumptions),
    )
    # interval constraint indices must be preserved for no_overlap /
    # cumulative references -> expansion appends, never reorders.
    for ct in model.constraints:
        if ct.kind == "automaton":
            _expand_automaton(out, ct)
        elif ct.kind == "reservoir":
            _expand_reservoir(out, ct)
        elif ct.kind == "no_overlap_2d":
            _expand_no_overlap_2d(out, ct, model)
        else:
            out.constraints.append(ct)
    return out


def _new_var(out: ir.CpModelIR, domain: Domain, name: str) -> int:
    out.variables.append(ir.IntegerVariableIR(name, domain))
    return len(out.variables) - 1


def _var_expr(v: int) -> ir.LinearExprIR:
    return ir.LinearExprIR([v], [1], 0)


def _expand_automaton(out: ir.CpModelIR, ct: ir.ConstraintIR) -> None:
    """Unroll as a layered transition table: state_0 = start;
    (state_t, label_t, state_{t+1}) in transitions; state_n final.
    (reference cp_model_expand.cc ExpandAutomaton)"""
    a: ir.AutomatonArgs = ct.args
    states = sorted(
        {a.starting_state}
        | set(a.final_states)
        | set(a.transition_tail)
        | set(a.transition_head)
    )
    n = len(a.exprs)
    prev = _new_var(out, Domain(a.starting_state, a.starting_state),
                    f"aut_s0_{len(out.constraints)}")
    triples = list(zip(a.transition_tail, a.transition_label,
                       a.transition_head))
    for t in range(n):
        nxt = _new_var(out, Domain.from_values(states),
                       f"aut_s{t + 1}_{len(out.constraints)}")
        out.constraints.append(ir.ConstraintIR(
            "table",
            ir.TableArgs(
                exprs=[_var_expr(prev), a.exprs[t], _var_expr(nxt)],
                values=[tuple(tr) for tr in triples],
            ),
            enforcement_literals=list(ct.enforcement_literals),
        ))
        prev = nxt
    out.constraints.append(ir.ConstraintIR(
        "linear",
        ir.LinearArgs([prev], [1], Domain.from_values(a.final_states)),
        enforcement_literals=list(ct.enforcement_literals),
    ))


def _expand_reservoir(out: ir.CpModelIR, ct: ir.ConstraintIR) -> None:
    """Pairwise encoding (reference ExpandReservoir): for each event j, the
    level after all events at time <= time_j must stay within bounds:
        sum_i change_i * active_i * [time_i <= time_j]  in [min, max].
    [time_i <= time_j] is reified with two half-implications; the product
    with active_i is linearized through an and-literal."""
    a: ir.ReservoirArgs = ct.args
    n = len(a.time_exprs)

    def active_lit(i: int):
        return a.active_literals[i] if a.active_literals else None

    # order literals b[i][j] <=> time_i <= time_j (i != j)
    order: dict = {}
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            b = _new_var(out, Domain(0, 1),
                         f"res_le_{i}_{j}_{len(out.constraints)}")
            order[i, j] = b
            # b -> t_i <= t_j ; !b -> t_i >= t_j + 1
            diff = ir.LinearExprIR(
                list(a.time_exprs[i].vars) + list(a.time_exprs[j].vars),
                list(a.time_exprs[i].coeffs)
                + [-c for c in a.time_exprs[j].coeffs],
                a.time_exprs[i].offset - a.time_exprs[j].offset,
            )
            out.constraints.append(ir.ConstraintIR(
                "linear",
                ir.LinearArgs(diff.vars, diff.coeffs,
                              Domain(None, -diff.offset)),
                enforcement_literals=[b],
            ))
            out.constraints.append(ir.ConstraintIR(
                "linear",
                ir.LinearArgs(diff.vars, diff.coeffs,
                              Domain(1 - diff.offset, None)),
                enforcement_literals=[ir.negated_literal(b)],
            ))
    # consistency: exactly one of b[i][j], b[j][i] unless times equal; both
    # may be 1 when equal — bool_or(b_ij, b_ji) ensures a total preorder.
    for i in range(n):
        for j in range(i + 1, n):
            out.constraints.append(ir.ConstraintIR(
                "bool_or", ir.BoolArgs([order[i, j], order[j, i]])
            ))
    for j in range(n):
        # z_i = active_i AND b[i][j]  (z_j includes event j itself)
        terms_vars: List[int] = []
        terms_coeffs: List[int] = []
        const = 0
        for i in range(n):
            ch = a.level_changes[i]
            if ch.vars:
                # validate_model reports this as MODEL_INVALID up front;
                # this is only a backstop for direct expand_model callers.
                raise ValueError(
                    "reservoir with variable level changes is not supported"
                )
            change = ch.offset
            if change == 0:
                continue
            if i == j:
                lit = active_lit(j)
                if lit is None:
                    const += change
                else:
                    v = ir.literal_index(lit)
                    if lit >= 0:
                        terms_vars.append(v)
                        terms_coeffs.append(change)
                    else:
                        terms_vars.append(v)
                        terms_coeffs.append(-change)
                        const += change
                continue
            b = order[i, j]
            lit = active_lit(i)
            if lit is None:
                z = b
            else:
                z = _new_var(out, Domain(0, 1),
                             f"res_and_{i}_{j}_{len(out.constraints)}")
                # z <=> lit AND b
                out.constraints.append(ir.ConstraintIR(
                    "bool_and", ir.BoolArgs([lit, b]),
                    enforcement_literals=[z],
                ))
                out.constraints.append(ir.ConstraintIR(
                    "bool_or",
                    ir.BoolArgs([ir.negated_literal(lit),
                                 ir.negated_literal(b), z]),
                ))
            terms_vars.append(z)
            terms_coeffs.append(change)
        dom = Domain(a.min_level - const, a.max_level - const)
        # the level constraint is conditional on the reservoir's own
        # enforcement literals (the order/and literal *definitions* above
        # stay unconditional — they are always satisfiable)
        enforce = list(ct.enforcement_literals)
        lit_j = active_lit(j)
        if lit_j is not None:
            enforce.append(lit_j)
        out.constraints.append(ir.ConstraintIR(
            "linear", ir.LinearArgs(terms_vars, terms_coeffs, dom),
            enforcement_literals=list(dict.fromkeys(enforce)),
        ))


def _expand_no_overlap_2d(out: ir.CpModelIR, ct: ir.ConstraintIR,
                          src: ir.CpModelIR) -> None:
    """Pairwise 4-way disjunction: boxes i, j must separate on x or y
    (reference ExpandNoOverlap2D-ish; CP-SAT keeps a dedicated
    propagator, diffn.cc — planned upgrade)."""
    a: ir.NoOverlap2DArgs = ct.args
    n = len(a.x_intervals)

    def precedence_lit(int_a: int, int_b: int, tag: str):
        # lit -> end(int_a) <= start(int_b)
        ia = src.constraints[int_a].args
        ib = src.constraints[int_b].args
        lit = _new_var(out, Domain(0, 1),
                       f"no2d_{tag}_{len(out.constraints)}")
        diff = ir.LinearExprIR(
            list(ia.end.vars) + list(ib.start.vars),
            list(ia.end.coeffs) + [-c for c in ib.start.coeffs],
            ia.end.offset - ib.start.offset,
        )
        out.constraints.append(ir.ConstraintIR(
            "linear",
            ir.LinearArgs(diff.vars, diff.coeffs, Domain(None, -diff.offset)),
            enforcement_literals=[lit],
        ))
        return lit

    for i in range(n):
        for j in range(i + 1, n):
            lits = [
                precedence_lit(a.x_intervals[i], a.x_intervals[j], "xb"),
                precedence_lit(a.x_intervals[j], a.x_intervals[i], "xa"),
                precedence_lit(a.y_intervals[i], a.y_intervals[j], "yb"),
                precedence_lit(a.y_intervals[j], a.y_intervals[i], "ya"),
            ]
            # presence conditions: if any involved interval is optional and
            # absent, the disjunction is vacuous
            enforce = []
            for k in (a.x_intervals[i], a.x_intervals[j],
                      a.y_intervals[i], a.y_intervals[j]):
                enforce.extend(src.constraints[k].enforcement_literals)
            out.constraints.append(ir.ConstraintIR(
                "bool_or", ir.BoolArgs(lits),
                enforcement_literals=list(dict.fromkeys(enforce)),
            ))
