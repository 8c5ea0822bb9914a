"""CP-SAT Python modeling API.

Capability parity: ``ortools/sat/python/cp_model.py`` (SURVEY §2.4.1 —
CpModel at :1089, CpSolver at :2545, LinearExpr tree at :175).  The method
surface mirrors the reference in snake_case with the legacy CamelCase
aliases the reference also exports (NewIntVar/AddLinearConstraint/...).

Expressions are integer-linear: IntVar, +, -, * by constants; comparisons
produce bounded expressions accepted by ``CpModel.add``.  Boolean literals
are IntVars with 0/1 domain or their negations (``~x`` / ``x.negated()``).
"""

from __future__ import annotations

import numbers
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain, INT_MAX, INT_MIN
from ortools_tpu_torch.utils.status import SolveStatus

IntegralT = Union[int]
_LinearT = Union["LinearExpr", "IntVar", int]


class LinearExpr:
    """Integer linear expression: sum coeff*var + offset."""

    __slots__ = ("_coeffs", "_offset")

    def __init__(self, coeffs: Optional[Dict[int, int]] = None,
                 offset: int = 0) -> None:
        self._coeffs = coeffs or {}
        self._offset = int(offset)

    # -- builders (reference LinearExpr static helpers) ------------------
    @staticmethod
    def of(e: _LinearT) -> "LinearExpr":
        if isinstance(e, LinearExpr):
            return e
        if isinstance(e, numbers.Integral):
            return LinearExpr({}, int(e))
        raise TypeError(f"not an integer linear expression: {e!r}")

    @staticmethod
    def sum(exprs: Iterable[_LinearT]) -> "LinearExpr":
        out = LinearExpr()
        for e in exprs:
            out = out + e
        return out

    @staticmethod
    def weighted_sum(exprs: Iterable[_LinearT],
                     coeffs: Iterable[int]) -> "LinearExpr":
        out = LinearExpr()
        for e, c in zip(exprs, coeffs):
            out = out + LinearExpr.of(e) * c
        return out

    @staticmethod
    def term(expr: _LinearT, coeff: int) -> "LinearExpr":
        return LinearExpr.of(expr) * coeff

    Sum = sum
    WeightedSum = weighted_sum
    Term = term

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other: _LinearT) -> "LinearExpr":
        o = LinearExpr.of(other)
        coeffs = dict(self._coeffs)
        for k, v in o._coeffs.items():
            coeffs[k] = coeffs.get(k, 0) + v
        return LinearExpr(coeffs, self._offset + o._offset)

    __radd__ = __add__

    def __sub__(self, other: _LinearT) -> "LinearExpr":
        return self + (LinearExpr.of(other) * -1)

    def __rsub__(self, other: _LinearT) -> "LinearExpr":
        return LinearExpr.of(other) + (self * -1)

    def __mul__(self, k) -> "LinearExpr":
        if not isinstance(k, numbers.Integral):
            raise TypeError("CP expressions use integer coefficients")
        k = int(k)
        return LinearExpr({i: c * k for i, c in self._coeffs.items()},
                          self._offset * k)

    __rmul__ = __mul__

    def __neg__(self) -> "LinearExpr":
        return self * -1

    # -- comparisons -----------------------------------------------------
    def __le__(self, other: _LinearT) -> "BoundedLinearExpression":
        d = self - LinearExpr.of(other)
        return BoundedLinearExpression(d, Domain(INT_MIN, 0))

    def __ge__(self, other: _LinearT) -> "BoundedLinearExpression":
        d = self - LinearExpr.of(other)
        return BoundedLinearExpression(d, Domain(0, INT_MAX))

    def __lt__(self, other: _LinearT) -> "BoundedLinearExpression":
        return self.__le__(LinearExpr.of(other) - 1)

    def __gt__(self, other: _LinearT) -> "BoundedLinearExpression":
        return self.__ge__(LinearExpr.of(other) + 1)

    def __eq__(self, other) -> "BoundedLinearExpression":  # type: ignore
        d = self - LinearExpr.of(other)
        return BoundedLinearExpression(d, Domain(0, 0))

    def __ne__(self, other) -> "BoundedLinearExpression":  # type: ignore
        d = self - LinearExpr.of(other)
        return BoundedLinearExpression(d, Domain(0, 0).complement())

    def __hash__(self):
        return id(self)

    def to_ir(self) -> ir.LinearExprIR:
        items = sorted((i, c) for i, c in self._coeffs.items() if c != 0)
        return ir.LinearExprIR(
            vars=[i for i, _ in items],
            coeffs=[c for _, c in items],
            offset=self._offset,
        )

    def __repr__(self):
        parts = [f"{c}*x{i}" for i, c in sorted(self._coeffs.items())]
        if self._offset or not parts:
            parts.append(str(self._offset))
        return " + ".join(parts)


class BoundedLinearExpression:
    """expr's value restricted to a Domain (expr includes its offset; the
    domain is on the expression's full value)."""

    def __init__(self, expr: LinearExpr, domain: Domain) -> None:
        # Domain applies to (expr - offset)?  No: to the full expr value.
        self.expr = expr
        self.domain = domain

    def __bool__(self):
        # Allow `x == y` identity checks in sets/dicts to fail loudly.
        raise NotImplementedError(
            "A BoundedLinearExpression is not a boolean; add it to the "
            "model with CpModel.add(...)"
        )


class IntVar(LinearExpr):
    __slots__ = ("model", "index")

    def __init__(self, model: "CpModel", index: int) -> None:
        self.model = model
        self.index = index

    @property
    def _coeffs(self):  # type: ignore[override]
        return {self.index: 1}

    @property
    def _offset(self):  # type: ignore[override]
        return 0

    @property
    def name(self) -> str:
        return self.model.ir.variables[self.index].name

    @property
    def domain(self) -> Domain:
        return self.model.ir.variables[self.index].domain

    def negated(self) -> "_NotBoolVar":
        assert self.model.ir.is_boolean_var(self.index), (
            "negated() requires a Boolean variable"
        )
        return _NotBoolVar(self)

    Not = negated

    def __invert__(self) -> "_NotBoolVar":
        return self.negated()

    def __hash__(self):
        return hash((id(self.model), self.index))

    def __eq__(self, other):  # keep constraint semantics
        return LinearExpr.__eq__(self, other)

    def __ne__(self, other):
        return LinearExpr.__ne__(self, other)

    def __repr__(self):
        return f"{self.name}({self.domain})"


class _NotBoolVar(LinearExpr):
    """Negation of a Boolean variable: literal ~b; as an expression, 1-b."""

    __slots__ = ("var",)

    def __init__(self, var: IntVar) -> None:
        self.var = var

    @property
    def index(self) -> int:
        return ir.negated_literal(self.var.index)

    @property
    def _coeffs(self):  # type: ignore[override]
        return {self.var.index: -1}

    @property
    def _offset(self):  # type: ignore[override]
        return 1

    def negated(self) -> IntVar:
        return self.var

    Not = negated

    def __invert__(self) -> IntVar:
        return self.var

    def __hash__(self):
        return hash(("not", id(self.var.model), self.var.index))

    def __repr__(self):
        return f"not({self.var.name})"


LiteralT = Union[IntVar, _NotBoolVar, bool]


class Constraint:
    def __init__(self, model: "CpModel", index: int) -> None:
        self.model = model
        self.index = index

    def only_enforce_if(self, *literals: LiteralT) -> "Constraint":
        lits = []
        for lit in _flatten(literals):
            lits.append(self.model._literal_index(lit))
        self.model.ir.constraints[self.index].enforcement_literals.extend(lits)
        return self

    OnlyEnforceIf = only_enforce_if

    def with_name(self, name: str) -> "Constraint":
        self.model.ir.constraints[self.index].name = name
        return self

    WithName = with_name


class IntervalVar:
    def __init__(self, model: "CpModel", index: int,
                 start: LinearExpr, size: LinearExpr, end: LinearExpr) -> None:
        self.model = model
        self.index = index  # constraint index of the interval constraint
        self.start_expr = start
        self.size_expr = size
        self.end_expr = end

    StartExpr = property(lambda self: self.start_expr)
    SizeExpr = property(lambda self: self.size_expr)
    EndExpr = property(lambda self: self.end_expr)


def _flatten(items):
    for it in items:
        # expand any iterable container (list, tuple, generator, dict view)
        # but not expressions/variables themselves
        if isinstance(it, (LinearExpr, str, bytes)):
            yield it
        elif hasattr(it, "__iter__"):
            yield from _flatten(it)
        else:
            yield it


class CpModel:
    """Fluent CP model builder (parity: cp_model.CpModel)."""

    def __init__(self) -> None:
        self.ir = ir.CpModelIR()
        self._constants: Dict[int, int] = {}

    # ---- naming --------------------------------------------------------
    @property
    def name(self) -> str:
        return self.ir.name

    @name.setter
    def name(self, value: str) -> None:
        self.ir.name = value

    # ---- variables -----------------------------------------------------
    def new_int_var(self, lb: int, ub: int, name: str = "") -> IntVar:
        return self.new_int_var_from_domain(Domain(lb, ub), name)

    def new_int_var_from_domain(self, domain: Domain, name: str = "") -> IntVar:
        idx = len(self.ir.variables)
        self.ir.variables.append(
            ir.IntegerVariableIR(name or f"x{idx}", domain)
        )
        return IntVar(self, idx)

    def new_bool_var(self, name: str = "") -> IntVar:
        return self.new_int_var(0, 1, name or f"b{len(self.ir.variables)}")

    def new_constant(self, value: int) -> IntVar:
        value = int(value)
        if value in self._constants:
            return IntVar(self, self._constants[value])
        v = self.new_int_var(value, value, f"const_{value}")
        self._constants[value] = v.index
        return v

    # ---- generic add ---------------------------------------------------
    def add(self, ct: Union[BoundedLinearExpression, bool]) -> Constraint:
        if isinstance(ct, bool):
            # trivially-true/false constraints (e.g. `model.add(3 <= 4)`)
            return self._add_const(ct)
        if not isinstance(ct, BoundedLinearExpression):
            raise TypeError(f"cannot add {ct!r} to the model")
        e = ct.expr.to_ir()
        dom = ct.domain.offset(-e.offset)
        e.offset = 0
        return self._append(
            ir.ConstraintIR("linear", ir.LinearArgs(e.vars, e.coeffs, dom))
        )

    def _add_const(self, value: bool) -> Constraint:
        # a constraint that is trivially true or false
        dom = Domain(0, 0) if value else Domain.empty()
        return self._append(
            ir.ConstraintIR("linear", ir.LinearArgs([], [], dom))
        )

    def add_linear_constraint(self, expr: _LinearT, lb: int, ub: int
                              ) -> Constraint:
        return self.add_linear_expression_in_domain(expr, Domain(lb, ub))

    def add_linear_expression_in_domain(self, expr: _LinearT,
                                        domain: Domain) -> Constraint:
        e = LinearExpr.of(expr).to_ir()
        dom = domain.offset(-e.offset)
        e.offset = 0
        return self._append(
            ir.ConstraintIR("linear", ir.LinearArgs(e.vars, e.coeffs, dom))
        )

    def _append(self, c: ir.ConstraintIR) -> Constraint:
        self.ir.constraints.append(c)
        return Constraint(self, len(self.ir.constraints) - 1)

    def _literal_index(self, lit: LiteralT) -> int:
        if isinstance(lit, bool):
            return self.new_constant(1 if lit else 0).index
        if isinstance(lit, _NotBoolVar):
            return lit.index
        if isinstance(lit, IntVar):
            assert self.ir.is_boolean_var(lit.index), (
                f"{lit!r} is not Boolean"
            )
            return lit.index
        raise TypeError(f"not a literal: {lit!r}")

    def _expr_ir(self, e: _LinearT) -> ir.LinearExprIR:
        return LinearExpr.of(e).to_ir()

    # ---- boolean constraints ------------------------------------------
    def add_bool_or(self, *literals) -> Constraint:
        lits = [self._literal_index(l) for l in _flatten(literals)]
        return self._append(ir.ConstraintIR("bool_or", ir.BoolArgs(lits)))

    def add_bool_and(self, *literals) -> Constraint:
        lits = [self._literal_index(l) for l in _flatten(literals)]
        return self._append(ir.ConstraintIR("bool_and", ir.BoolArgs(lits)))

    def add_at_most_one(self, *literals) -> Constraint:
        lits = [self._literal_index(l) for l in _flatten(literals)]
        return self._append(ir.ConstraintIR("at_most_one", ir.BoolArgs(lits)))

    def add_exactly_one(self, *literals) -> Constraint:
        lits = [self._literal_index(l) for l in _flatten(literals)]
        return self._append(ir.ConstraintIR("exactly_one", ir.BoolArgs(lits)))

    def add_bool_xor(self, *literals) -> Constraint:
        lits = [self._literal_index(l) for l in _flatten(literals)]
        return self._append(ir.ConstraintIR("bool_xor", ir.BoolArgs(lits)))

    def add_implication(self, a: LiteralT, b: LiteralT) -> Constraint:
        return self.add_bool_or(
            [_negate_literal_obj(a), b]
        )

    # ---- integer constraints ------------------------------------------
    def add_all_different(self, *exprs) -> Constraint:
        es = [self._expr_ir(e) for e in _flatten(exprs)]
        return self._append(ir.ConstraintIR("all_diff", ir.AllDiffArgs(es)))

    def add_max_equality(self, target: _LinearT, exprs) -> Constraint:
        return self._append(ir.ConstraintIR(
            "lin_max",
            ir.LinMaxArgs(self._expr_ir(target),
                          [self._expr_ir(e) for e in exprs]),
        ))

    def add_min_equality(self, target: _LinearT, exprs) -> Constraint:
        # min(e) = -max(-e)
        return self._append(ir.ConstraintIR(
            "lin_max",
            ir.LinMaxArgs(
                (LinearExpr.of(target) * -1).to_ir(),
                [(LinearExpr.of(e) * -1).to_ir() for e in exprs],
            ),
        ))

    def add_abs_equality(self, target: _LinearT, expr: _LinearT) -> Constraint:
        e = LinearExpr.of(expr)
        return self.add_max_equality(target, [e, e * -1])

    def add_multiplication_equality(self, target: _LinearT, *exprs
                                    ) -> Constraint:
        es = [self._expr_ir(e) for e in _flatten(exprs)]
        return self._append(ir.ConstraintIR(
            "int_prod", ir.IntProdArgs(self._expr_ir(target), es)
        ))

    def add_division_equality(self, target: _LinearT, num: _LinearT,
                              den: _LinearT) -> Constraint:
        return self._append(ir.ConstraintIR(
            "int_div",
            ir.IntDivArgs(self._expr_ir(target), self._expr_ir(num),
                          self._expr_ir(den)),
        ))

    def add_modulo_equality(self, target: _LinearT, num: _LinearT,
                            mod: _LinearT) -> Constraint:
        return self._append(ir.ConstraintIR(
            "int_mod",
            ir.IntModArgs(self._expr_ir(target), self._expr_ir(num),
                          self._expr_ir(mod)),
        ))

    def add_element(self, index: _LinearT, expressions,
                    target: _LinearT) -> Constraint:
        es = [self._expr_ir(e) for e in expressions]
        return self._append(ir.ConstraintIR(
            "element",
            ir.ElementArgs(self._expr_ir(index), self._expr_ir(target), es),
        ))

    def add_allowed_assignments(self, expressions, tuples_list) -> Constraint:
        es = [self._expr_ir(e) for e in expressions]
        vals = [tuple(int(v) for v in t) for t in tuples_list]
        for t in vals:
            assert len(t) == len(es), "tuple arity mismatch"
        return self._append(ir.ConstraintIR(
            "table", ir.TableArgs(es, vals, negated=False)
        ))

    def add_forbidden_assignments(self, expressions, tuples_list) -> Constraint:
        es = [self._expr_ir(e) for e in expressions]
        vals = [tuple(int(v) for v in t) for t in tuples_list]
        return self._append(ir.ConstraintIR(
            "table", ir.TableArgs(es, vals, negated=True)
        ))

    def add_automaton(self, transition_expressions, starting_state: int,
                      final_states, transition_triples) -> Constraint:
        """transition_triples: iterable of (tail_state, label, head_state)."""
        tails, labels, heads = [], [], []
        for t, l, h in transition_triples:
            tails.append(int(t))
            labels.append(int(l))
            heads.append(int(h))
        return self._append(ir.ConstraintIR(
            "automaton",
            ir.AutomatonArgs(
                exprs=[self._expr_ir(e) for e in transition_expressions],
                starting_state=int(starting_state),
                final_states=[int(s) for s in final_states],
                transition_tail=tails,
                transition_label=labels,
                transition_head=heads,
            ),
        ))

    def add_reservoir_constraint(self, times, level_changes,
                                 min_level: int, max_level: int
                                 ) -> Constraint:
        return self._append(ir.ConstraintIR(
            "reservoir",
            ir.ReservoirArgs(
                time_exprs=[self._expr_ir(t) for t in times],
                level_changes=[self._expr_ir(c) for c in level_changes],
                active_literals=[],
                min_level=int(min_level),
                max_level=int(max_level),
            ),
        ))

    def add_reservoir_constraint_with_active(self, times, level_changes,
                                             actives, min_level: int,
                                             max_level: int) -> Constraint:
        return self._append(ir.ConstraintIR(
            "reservoir",
            ir.ReservoirArgs(
                time_exprs=[self._expr_ir(t) for t in times],
                level_changes=[self._expr_ir(c) for c in level_changes],
                active_literals=[self._literal_index(a) for a in actives],
                min_level=int(min_level),
                max_level=int(max_level),
            ),
        ))

    def add_no_overlap_2d(self, x_intervals: Sequence[IntervalVar],
                          y_intervals: Sequence[IntervalVar]) -> Constraint:
        assert len(x_intervals) == len(y_intervals)
        return self._append(ir.ConstraintIR(
            "no_overlap_2d",
            ir.NoOverlap2DArgs(
                [iv.index for iv in x_intervals],
                [iv.index for iv in y_intervals],
            ),
        ))

    def add_inverse(self, variables, inverse_variables) -> Constraint:
        f = [self._only_var(v) for v in variables]
        g = [self._only_var(v) for v in inverse_variables]
        return self._append(ir.ConstraintIR("inverse", ir.InverseArgs(f, g)))

    def add_circuit(self, arcs) -> Constraint:
        tails, heads, lits = [], [], []
        for t, h, lit in arcs:
            tails.append(int(t))
            heads.append(int(h))
            lits.append(self._literal_index(lit))
        return self._append(ir.ConstraintIR(
            "circuit", ir.CircuitArgs(tails, heads, lits)
        ))

    def _only_var(self, v) -> int:
        assert isinstance(v, IntVar), f"expected a variable, got {v!r}"
        return v.index

    # ---- scheduling ----------------------------------------------------
    def new_interval_var(self, start: _LinearT, size: _LinearT,
                         end: _LinearT, name: str = "") -> IntervalVar:
        s, z, e = (LinearExpr.of(start), LinearExpr.of(size),
                   LinearExpr.of(end))
        ct = self._append(ir.ConstraintIR(
            "interval", ir.IntervalArgs(s.to_ir(), z.to_ir(), e.to_ir()),
            name=name,
        ))
        return IntervalVar(self, ct.index, s, z, e)

    def new_fixed_size_interval_var(self, start: _LinearT, size: int,
                                    name: str = "") -> IntervalVar:
        s = LinearExpr.of(start)
        return self.new_interval_var(s, size, s + size, name)

    def new_optional_interval_var(self, start, size, end,
                                  is_present: LiteralT,
                                  name: str = "") -> IntervalVar:
        iv = self.new_interval_var(start, size, end, name)
        self.ir.constraints[iv.index].enforcement_literals.append(
            self._literal_index(is_present)
        )
        return iv

    def new_optional_fixed_size_interval_var(self, start, size,
                                             is_present, name: str = ""):
        s = LinearExpr.of(start)
        return self.new_optional_interval_var(s, size, s + size, is_present,
                                              name)

    def add_no_overlap(self, intervals: Sequence[IntervalVar]) -> Constraint:
        return self._append(ir.ConstraintIR(
            "no_overlap", ir.NoOverlapArgs([iv.index for iv in intervals])
        ))

    def add_cumulative(self, intervals, demands, capacity) -> Constraint:
        return self._append(ir.ConstraintIR(
            "cumulative",
            ir.CumulativeArgs(
                self._expr_ir(capacity),
                [iv.index for iv in intervals],
                [self._expr_ir(d) for d in demands],
            ),
        ))

    # ---- objective / hints / strategies --------------------------------
    def minimize(self, expr: _LinearT) -> None:
        e = LinearExpr.of(expr).to_ir()
        self.ir.objective = ir.ObjectiveIR(e.vars, e.coeffs, e.offset, False)

    def maximize(self, expr: _LinearT) -> None:
        e = LinearExpr.of(expr).to_ir()
        self.ir.objective = ir.ObjectiveIR(e.vars, e.coeffs, e.offset, True)

    @property
    def has_objective(self) -> bool:
        return self.ir.objective is not None

    def add_hint(self, var: IntVar, value: int) -> None:
        self.ir.solution_hint.append((var.index, int(value)))

    def clear_hints(self) -> None:
        self.ir.solution_hint.clear()

    def add_assumption(self, lit: LiteralT) -> None:
        self.ir.assumptions.append(self._literal_index(lit))

    def add_assumptions(self, literals) -> None:
        for lit in literals:
            self.add_assumption(lit)

    def add_decision_strategy(self, variables, var_strategy,
                              domain_strategy) -> None:
        self.ir.search_strategies.append(ir.DecisionStrategyIR(
            [v.index for v in variables], str(var_strategy),
            str(domain_strategy),
        ))

    # ---- validation / stats -------------------------------------------
    def validate(self) -> str:
        from ortools_tpu_torch.sat.checker import validate_model

        errs = validate_model(self.ir)
        return "; ".join(errs)

    def __str__(self):
        return (f"CpModel '{self.ir.name}': {len(self.ir.variables)} vars, "
                f"{len(self.ir.constraints)} constraints")

    # ---- legacy CamelCase aliases (reference exports both) -------------
    NewIntVar = new_int_var
    NewIntVarFromDomain = new_int_var_from_domain
    NewBoolVar = new_bool_var
    NewConstant = new_constant
    Add = add
    AddLinearConstraint = add_linear_constraint
    AddLinearExpressionInDomain = add_linear_expression_in_domain
    AddBoolOr = add_bool_or
    AddBoolAnd = add_bool_and
    AddAtMostOne = add_at_most_one
    AddExactlyOne = add_exactly_one
    AddBoolXOr = add_bool_xor
    AddImplication = add_implication
    AddAllDifferent = add_all_different
    AddMaxEquality = add_max_equality
    AddMinEquality = add_min_equality
    AddAbsEquality = add_abs_equality
    AddMultiplicationEquality = add_multiplication_equality
    AddDivisionEquality = add_division_equality
    AddModuloEquality = add_modulo_equality
    AddElement = add_element
    AddAllowedAssignments = add_allowed_assignments
    AddForbiddenAssignments = add_forbidden_assignments
    AddInverse = add_inverse
    AddCircuit = add_circuit
    AddAutomaton = add_automaton
    AddReservoirConstraint = add_reservoir_constraint
    AddReservoirConstraintWithActive = add_reservoir_constraint_with_active
    AddNoOverlap2D = add_no_overlap_2d
    NewIntervalVar = new_interval_var
    NewFixedSizeIntervalVar = new_fixed_size_interval_var
    NewOptionalIntervalVar = new_optional_interval_var
    NewOptionalFixedSizeIntervalVar = new_optional_fixed_size_interval_var
    AddNoOverlap = add_no_overlap
    AddCumulative = add_cumulative
    Minimize = minimize
    Maximize = maximize
    AddHint = add_hint
    ClearHints = clear_hints
    AddAssumption = add_assumption
    AddAssumptions = add_assumptions
    AddDecisionStrategy = add_decision_strategy
    Validate = validate


def _negate_literal_obj(lit: LiteralT):
    if isinstance(lit, bool):
        return not lit
    return lit.negated()


class CpSolverSolutionCallback:
    """Base class for solution callbacks (parity: cp_model.py:2764)."""

    def __init__(self) -> None:
        self._values: Optional[List[int]] = None
        self._objective: Optional[int] = None
        self._stopped = False

    def _on_solution(self, values: List[int], objective) -> None:
        self._values = values
        self._objective = objective
        self.on_solution_callback()

    def on_solution_callback(self) -> None:  # override me
        pass

    def value(self, expr: _LinearT) -> int:
        assert self._values is not None
        e = LinearExpr.of(expr)
        return e._offset + sum(
            c * self._values[i] for i, c in e._coeffs.items()
        )

    Value = value

    def boolean_value(self, lit: LiteralT) -> bool:
        if isinstance(lit, bool):
            return lit
        return self.value(lit) != 0

    BooleanValue = boolean_value

    @property
    def objective_value(self):
        return self._objective

    def stop_search(self) -> None:
        self._stopped = True

    StopSearch = stop_search


class CpSolver:
    """Solve CpModels (parity: cp_model.CpSolver)."""

    def __init__(self, *, device="cuda") -> None:
        from ortools_tpu_torch.sat.params import SatParameters

        self.device = device  # where solve_model runs MaxHS's MIPs
        self.parameters = SatParameters()
        self._response = None

    def solve(self, model: CpModel,
              callback: Optional[CpSolverSolutionCallback] = None
              ) -> SolveStatus:
        from ortools_tpu_torch.sat.solver import solve_model

        self._response = solve_model(model.ir, self.parameters, callback, device=self.device)
        return self._response.status

    Solve = solve

    def solve_with_solution_callback(self, model: CpModel,
                                     callback: CpSolverSolutionCallback
                                     ) -> SolveStatus:
        return self.solve(model, callback)

    SolveWithSolutionCallback = solve_with_solution_callback

    @property
    def response(self):
        assert self._response is not None, "solve() first"
        return self._response

    def value(self, expr: _LinearT) -> int:
        e = LinearExpr.of(expr)
        vals = self.response.solution
        assert vals is not None, "no solution available"
        return e._offset + sum(c * vals[i] for i, c in e._coeffs.items())

    Value = value

    def values(self, variables) -> List[int]:
        return [self.value(v) for v in variables]

    def boolean_value(self, lit: LiteralT) -> bool:
        if isinstance(lit, bool):
            return lit
        return self.value(lit) != 0

    BooleanValue = boolean_value

    @property
    def objective_value(self) -> float:
        return self.response.objective_value

    ObjectiveValue = lambda self: self.objective_value  # noqa: E731

    @property
    def best_objective_bound(self) -> float:
        return self.response.best_objective_bound

    BestObjectiveBound = lambda self: self.best_objective_bound  # noqa: E731

    @property
    def wall_time(self) -> float:
        return self.response.wall_time

    WallTime = lambda self: self.wall_time  # noqa: E731

    @property
    def num_branches(self) -> int:
        return self.response.num_branches

    @property
    def num_conflicts(self) -> int:
        return self.response.num_conflicts

    def status_name(self, status: Optional[SolveStatus] = None) -> str:
        return (status or self.response.status).name

    StatusName = status_name

    def sufficient_assumptions_for_infeasibility(self) -> List[int]:
        return list(self.response.sufficient_assumptions_for_infeasibility)
