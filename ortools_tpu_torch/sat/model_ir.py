"""CP model intermediate representation.

Capability parity: ``ortools/sat/cp_model.proto`` — the reference's model IR
(SURVEY §2.4.1, constraint kinds at cp_model.proto:291-445).  Same
structure (integer variables with interval-list domains, constraints with
enforcement literals, linear expressions as var/coeff/offset triples) as
plain dataclasses instead of protobuf.

Literal convention matches the proto: literal ``i >= 0`` means "variable i
is true"; a negated literal is ``-i - 1`` (bitwise NOT of the index).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ortools_tpu_torch.utils.domain import Domain


def negated_literal(lit: int) -> int:
    return -lit - 1


def literal_index(lit: int) -> int:
    return lit if lit >= 0 else -lit - 1


def literal_is_positive(lit: int) -> bool:
    return lit >= 0


@dataclasses.dataclass
class IntegerVariableIR:
    name: str
    domain: Domain


@dataclasses.dataclass
class LinearExprIR:
    """sum(coeffs[i] * vars[i]) + offset."""

    vars: List[int] = dataclasses.field(default_factory=list)
    coeffs: List[int] = dataclasses.field(default_factory=list)
    offset: int = 0


# -- constraint payloads (cp_model.proto oneof equivalents) ----------------


@dataclasses.dataclass
class BoolArgs:  # bool_or / bool_and / at_most_one / exactly_one / bool_xor
    literals: List[int]


@dataclasses.dataclass
class LinearArgs:  # cp_model.proto:381 LinearConstraintProto
    vars: List[int]
    coeffs: List[int]
    domain: Domain


@dataclasses.dataclass
class AllDiffArgs:  # cp_model.proto AllDifferentConstraintProto
    exprs: List[LinearExprIR]


@dataclasses.dataclass
class LinMaxArgs:  # lin_max: target == max(exprs); min via negation
    target: LinearExprIR
    exprs: List[LinearExprIR]


@dataclasses.dataclass
class IntProdArgs:  # target == prod(exprs)
    target: LinearExprIR
    exprs: List[LinearExprIR]


@dataclasses.dataclass
class IntDivArgs:  # target == num / den (rounded toward zero)
    target: LinearExprIR
    num: LinearExprIR
    den: LinearExprIR


@dataclasses.dataclass
class IntModArgs:  # target == num % mod
    target: LinearExprIR
    num: LinearExprIR
    mod: LinearExprIR


@dataclasses.dataclass
class ElementArgs:  # exprs[index] == target (expr-based, proto's element)
    index: LinearExprIR
    target: LinearExprIR
    exprs: List[LinearExprIR]


@dataclasses.dataclass
class TableArgs:  # allowed (or forbidden) assignment tuples
    exprs: List[LinearExprIR]
    values: List[Tuple[int, ...]]
    negated: bool = False


@dataclasses.dataclass
class IntervalArgs:  # cp_model.proto:425 IntervalConstraintProto
    start: LinearExprIR
    size: LinearExprIR
    end: LinearExprIR


@dataclasses.dataclass
class NoOverlapArgs:
    intervals: List[int]  # constraint indices of interval constraints


@dataclasses.dataclass
class CumulativeArgs:
    capacity: LinearExprIR
    intervals: List[int]
    demands: List[LinearExprIR]


@dataclasses.dataclass
class CircuitArgs:  # arcs (tail, head, literal); true literals form a circuit
    tails: List[int]
    heads: List[int]
    literals: List[int]


@dataclasses.dataclass
class InverseArgs:
    f_direct: List[int]
    f_inverse: List[int]


@dataclasses.dataclass
class AutomatonArgs:  # cp_model.proto AutomatonConstraintProto
    exprs: List[LinearExprIR]  # the word, one expr per position
    starting_state: int
    final_states: List[int]
    # transitions as parallel lists: tail state, label, head state
    transition_tail: List[int] = dataclasses.field(default_factory=list)
    transition_label: List[int] = dataclasses.field(default_factory=list)
    transition_head: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ReservoirArgs:  # cp_model.proto ReservoirConstraintProto
    time_exprs: List[LinearExprIR]
    level_changes: List[LinearExprIR]
    active_literals: List[int]  # empty = all always active
    min_level: int = 0
    max_level: int = 0


@dataclasses.dataclass
class NoOverlap2DArgs:  # cp_model.proto NoOverlap2DConstraintProto
    x_intervals: List[int]  # constraint indices of interval constraints
    y_intervals: List[int]


@dataclasses.dataclass
class ConstraintIR:
    kind: str  # "bool_or", "bool_and", "at_most_one", "exactly_one",
    # "bool_xor", "linear", "all_diff", "lin_max", "int_prod", "int_div",
    # "int_mod", "element", "table", "interval", "no_overlap", "cumulative",
    # "circuit", "inverse"
    args: object
    enforcement_literals: List[int] = dataclasses.field(default_factory=list)
    name: str = ""


@dataclasses.dataclass
class ObjectiveIR:  # CpObjectiveProto (cp_model.proto:447)
    vars: List[int] = dataclasses.field(default_factory=list)
    coeffs: List[int] = dataclasses.field(default_factory=list)
    offset: int = 0
    maximize: bool = False


@dataclasses.dataclass
class DecisionStrategyIR:  # DecisionStrategyProto (cp_model.proto:506)
    variables: List[int] = dataclasses.field(default_factory=list)
    variable_selection: str = "choose_first"
    domain_reduction: str = "select_min_value"


@dataclasses.dataclass
class CpModelIR:  # CpModelProto (cp_model.proto:606)
    name: str = ""
    variables: List[IntegerVariableIR] = dataclasses.field(default_factory=list)
    constraints: List[ConstraintIR] = dataclasses.field(default_factory=list)
    objective: Optional[ObjectiveIR] = None
    search_strategies: List[DecisionStrategyIR] = dataclasses.field(
        default_factory=list
    )
    solution_hint: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list
    )
    assumptions: List[int] = dataclasses.field(default_factory=list)

    def is_boolean_var(self, idx: int) -> bool:
        d = self.variables[idx].domain
        return d.is_included_in(Domain(0, 1))


def eval_expr(expr: LinearExprIR, values: Sequence[int]) -> int:
    return expr.offset + sum(
        c * values[v] for v, c in zip(expr.vars, expr.coeffs)
    )


def expr_domain(expr: LinearExprIR, domains: Sequence[Domain]) -> Domain:
    """Interval hull of an expression under current domains."""
    lo = hi = expr.offset
    for v, c in zip(expr.vars, expr.coeffs):
        d = domains[v]
        if d.is_empty():
            return Domain.empty()
        a, b = c * d.min(), c * d.max()
        lo += min(a, b)
        hi += max(a, b)
    return Domain(lo, hi)
