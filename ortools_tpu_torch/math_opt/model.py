"""MathOpt-style modeling session, the PyTorch port of
``ortools_tpu/math_opt/model.py``.

Capability parity: ``ortools/math_opt`` (core/solver.h session + cpp/python
fluent model API) — the next-generation solver-independent front-end.  The
surface follows the reference's python bindings:

    model = math_opt.Model(name="m")
    x = model.add_variable(lb=0, ub=1, name="x")
    model.add_linear_constraint(x + y <= 1)
    model.maximize(2*x + y)
    result = math_opt.solve(model, math_opt.SolverType.GLOP)
    result.objective_value(), result.variable_values()[x]

Internally delegates to ortools_tpu_torch.linear_solver (which dispatches
to the pdlp / glop / mip backends), mirroring how the reference's MathOpt
wraps the same underlying engines as MPSolver.  ``solve`` and
``IncrementalSolver`` take the ``device`` of that ``Solver`` (the card by
default); the GLOP session and ``compute_infeasible_subsystem`` are host
code.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional, Union

from ortools_tpu_torch.linear_solver.model_builder import (
    LinearExpr,
    Model as _MbModel,
    Solver as _MbSolver,
    Variable,
    _BoundedExpr,
)
from ortools_tpu_torch.utils.status import MPSolverStatus


class SolverType(enum.Enum):
    GLOP = 2
    CP_SAT = 3
    PDLP = 4
    GSCIP = 1  # alias -> mip (the reference wraps SCIP; we use our B&B)
    HIGHS = 8  # alias -> glop


class TerminationReason(enum.Enum):
    OPTIMAL = 1
    INFEASIBLE = 2
    UNBOUNDED = 3
    FEASIBLE = 9
    NO_SOLUTION_FOUND = 10
    NUMERICAL_ERROR = 11
    OTHER_ERROR = 12


class Model:
    def __init__(self, name: str = "") -> None:
        self._mb = _MbModel(name)

    @property
    def name(self) -> str:
        return self._mb.name

    def add_variable(self, lb: float = -math.inf, ub: float = math.inf,
                     is_integer: bool = False, name: str = "") -> Variable:
        return self._mb.new_var(lb, ub, is_integer, name)

    def add_integer_variable(self, lb: float = -math.inf,
                             ub: float = math.inf,
                             name: str = "") -> Variable:
        return self._mb.new_var(lb, ub, True, name)

    def add_binary_variable(self, name: str = "") -> Variable:
        return self._mb.new_var(0.0, 1.0, True, name)

    def add_linear_constraint(self, expr_or_bounded=None, *,
                              lb: float = -math.inf, ub: float = math.inf,
                              name: str = ""):
        if isinstance(expr_or_bounded, _BoundedExpr):
            return self._mb.add(expr_or_bounded, name)
        return self._mb.add_linear_constraint(expr_or_bounded, lb, ub, name)

    def minimize(self, expr) -> None:
        self._mb.minimize(expr)

    def maximize(self, expr) -> None:
        self._mb.maximize(expr)

    @property
    def storage(self) -> _MbModel:
        return self._mb


@dataclasses.dataclass
class _Termination:
    reason: TerminationReason


class SolveResult:
    def __init__(self, termination: _Termination, solver: _MbSolver,
                 model: Model) -> None:
        self.termination = termination
        self._solver = solver
        self._model = model

    def objective_value(self) -> float:
        return self._solver.objective_value

    def best_objective_bound(self) -> float:
        return self._solver.best_objective_bound

    def variable_values(self) -> Dict[Variable, float]:
        mb = self._model.storage
        return {
            Variable(mb, i): float(self._solver._values[i])
            for i in range(mb.num_variables)
        }

    def value(self, expr) -> float:
        return self._solver.value(expr)

    def has_primal_feasible_solution(self) -> bool:
        return self.termination.reason in (
            TerminationReason.OPTIMAL, TerminationReason.FEASIBLE
        )


def solve(model: Model, solver_type: SolverType = SolverType.GLOP,
          message_callback=None, solution_callback=None, *,
          device="cuda", **params) -> SolveResult:
    """Solve; optional callbacks (reference math_opt callback.proto):

    - ``message_callback(lines: list[str])`` — solve log messages;
    - ``solution_callback(values: dict[Variable, float], objective)`` —
      every NEW MIP incumbent (MIP_SOLUTION event; MIP/CP paths only).
    """
    backend = {
        SolverType.GLOP: "glop",
        SolverType.PDLP: "pdlp",
        SolverType.CP_SAT: "sat",
        SolverType.GSCIP: "mip",
        SolverType.HIGHS: "glop",
    }[solver_type]
    s = _MbSolver(backend, device=device)
    if message_callback is not None:
        message_callback([
            f"math_opt: solving '{model.name}' with {backend}",
            f"  variables={model.storage.num_variables} "
            f"constraints={model.storage.num_constraints}",
        ])
    if solution_callback is not None and backend in ("sat", "mip"):
        def _on_incumbent(x, obj):
            solution_callback({i: float(xi) for i, xi in enumerate(x)},
                              float(obj))

        params = dict(params)
        params["new_incumbent_callback"] = _on_incumbent
    status = s.solve(model.storage, **params)
    if message_callback is not None:
        message_callback([f"math_opt: done — {status.name}"])
    reason = {
        MPSolverStatus.OPTIMAL: TerminationReason.OPTIMAL,
        MPSolverStatus.FEASIBLE: TerminationReason.FEASIBLE,
        MPSolverStatus.INFEASIBLE: TerminationReason.INFEASIBLE,
        MPSolverStatus.UNBOUNDED: TerminationReason.UNBOUNDED,
        MPSolverStatus.NOT_SOLVED: TerminationReason.NO_SOLUTION_FOUND,
        MPSolverStatus.ABNORMAL: TerminationReason.NUMERICAL_ERROR,
        MPSolverStatus.MODEL_INVALID: TerminationReason.OTHER_ERROR,
    }[status]
    return SolveResult(_Termination(reason), s, model)


# ---------------------------------------------------------------------------
# Incremental updates (reference math_opt model_update.proto + the
# IncrementalSolver session, core/solver.h:68)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelUpdate:
    """A batch of model mutations (reference model_update.proto): variable
    and constraint bound changes, objective coefficient changes, new
    variables/constraints, and variable/constraint deletions.

    Deletions keep every existing index stable (the reference keeps ids
    stable too): a deleted constraint becomes a vacuous row (no terms,
    free bounds) and a deleted variable is removed from every row and the
    objective and fixed to 0 — semantically identical to removal for any
    model that no longer references it."""

    variable_lower: Dict[int, float] = dataclasses.field(default_factory=dict)
    variable_upper: Dict[int, float] = dataclasses.field(default_factory=dict)
    objective_coeffs: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    constraint_lower: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    constraint_upper: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    # (constraint index, variable index) -> new coefficient
    matrix_coeffs: Dict[tuple, float] = dataclasses.field(
        default_factory=dict)
    new_variables: list = dataclasses.field(default_factory=list)
    new_constraints: list = dataclasses.field(default_factory=list)
    deleted_variable_ids: set = dataclasses.field(default_factory=set)
    deleted_constraint_ids: set = dataclasses.field(default_factory=set)

    def set_variable_lb(self, var: Variable, lb: float) -> "ModelUpdate":
        self.variable_lower[var.index] = float(lb)
        return self

    def set_variable_ub(self, var: Variable, ub: float) -> "ModelUpdate":
        self.variable_upper[var.index] = float(ub)
        return self

    def set_objective_coefficient(self, var: Variable, coeff: float
                                  ) -> "ModelUpdate":
        self.objective_coeffs[var.index] = float(coeff)
        return self

    def set_constraint_lb(self, ct, lb: float) -> "ModelUpdate":
        self.constraint_lower[_ct_index(ct)] = float(lb)
        return self

    def set_constraint_ub(self, ct, ub: float) -> "ModelUpdate":
        self.constraint_upper[_ct_index(ct)] = float(ub)
        return self

    def set_coefficient(self, ct, var: Variable, coeff: float
                        ) -> "ModelUpdate":
        self.matrix_coeffs[(_ct_index(ct), var.index)] = float(coeff)
        return self

    def add_variable(self, lb: float = -math.inf, ub: float = math.inf,
                     is_integer: bool = False, name: str = "") -> "ModelUpdate":
        self.new_variables.append((float(lb), float(ub), bool(is_integer),
                                   name))
        return self

    def add_linear_constraint(self, bounded) -> "ModelUpdate":
        if not isinstance(bounded, _BoundedExpr):
            raise TypeError("add_linear_constraint takes expr <=/==/>= rhs")
        self.new_constraints.append(bounded)
        return self

    def delete_variable(self, var: Variable) -> "ModelUpdate":
        self.deleted_variable_ids.add(var.index)
        return self

    def delete_linear_constraint(self, ct) -> "ModelUpdate":
        self.deleted_constraint_ids.add(_ct_index(ct))
        return self

    @property
    def bounds_only(self) -> bool:
        return not (self.objective_coeffs or self.constraint_lower
                    or self.constraint_upper or self.matrix_coeffs
                    or self.new_variables or self.new_constraints
                    or self.deleted_variable_ids
                    or self.deleted_constraint_ids)


def _ct_index(ct) -> int:
    return ct if isinstance(ct, int) else ct.index


class IncrementalSolver:
    """Session keeping solver state across updates (core/solver.h:68).

    For GLOP with bounds-only updates, re-solves warm-start through the
    dual simplex (glop/simplex.RevisedSimplex.resolve — the reference's
    incrementalism pattern); otherwise re-solves from scratch on the
    updated model.
    """

    def __init__(self, model: Model,
                 solver_type: SolverType = SolverType.GLOP,
                 device="cuda") -> None:
        self.model = model
        self.solver_type = solver_type
        self.device = device
        self._sx = None  # live RevisedSimplex session

    def solve(self, **params) -> SolveResult:
        if self.solver_type == SolverType.GLOP:
            from ortools_tpu_torch.glop.simplex import RevisedSimplex

            qp = self.model.storage.to_qp()
            self._sx = RevisedSimplex(qp)
            status = self._sx.primal_solve()
            return self._wrap(self._sx.result(status))
        self._sx = None
        return solve(self.model, self.solver_type, device=self.device,
                     **params)

    def update(self, upd: ModelUpdate) -> None:
        mb = self.model.storage
        for i, lo in upd.variable_lower.items():
            mb.var_lb[i] = lo
        for i, hi in upd.variable_upper.items():
            mb.var_ub[i] = hi
        for i, cv in upd.objective_coeffs.items():
            mb.objective.coeffs[i] = cv
        for i, lo in upd.constraint_lower.items():
            mb.ct_lb[i] = lo
        for i, hi in upd.constraint_upper.items():
            mb.ct_ub[i] = hi
        for (ci, vi), cv in upd.matrix_coeffs.items():
            if cv == 0.0:
                mb.ct_coeffs[ci].pop(vi, None)
            else:
                mb.ct_coeffs[ci][vi] = cv
        for lb, ub, is_int, name in upd.new_variables:
            mb.new_var(lb, ub, is_int, name)
        for bounded in upd.new_constraints:
            mb.add(bounded)
        for ci in upd.deleted_constraint_ids:
            mb.ct_coeffs[ci] = {}
            mb.ct_lb[ci] = -math.inf
            mb.ct_ub[ci] = math.inf
        for vi in upd.deleted_variable_ids:
            for coeffs in mb.ct_coeffs:
                coeffs.pop(vi, None)
            mb.objective.coeffs.pop(vi, None)
            mb.var_lb[vi] = 0.0
            mb.var_ub[vi] = 0.0
        if self._sx is not None and upd.bounds_only:
            import numpy as np

            st = self._sx.resolve(
                np.asarray(mb.var_lb, dtype=np.float64),
                np.asarray(mb.var_ub, dtype=np.float64),
            )
            self._last = self._wrap(self._sx.result(st))
        else:
            self._sx = None
            self._last = None

    def solve_after_update(self, upd: Optional[ModelUpdate] = None,
                           **params) -> SolveResult:
        if upd is not None:
            self.update(upd)
        if self._sx is not None and getattr(self, "_last", None) is not None:
            return self._last
        return self.solve(**params)

    def _wrap(self, res) -> SolveResult:
        reason = {
            MPSolverStatus.OPTIMAL: TerminationReason.OPTIMAL,
            MPSolverStatus.INFEASIBLE: TerminationReason.INFEASIBLE,
            MPSolverStatus.UNBOUNDED: TerminationReason.UNBOUNDED,
            MPSolverStatus.ABNORMAL: TerminationReason.NUMERICAL_ERROR,
        }.get(res.status, TerminationReason.OTHER_ERROR)
        shim = _SimplexShim(res)
        return SolveResult(_Termination(reason), shim, self.model)


class _SimplexShim:
    """Adapts a glop SimplexResult to the SolveResult accessor surface."""

    def __init__(self, res) -> None:
        self._values = res.primal_solution
        self.objective_value = res.objective_value
        self.best_objective_bound = res.objective_value

    def value(self, expr) -> float:
        return float(expr.offset + sum(
            c * self._values[i] for i, c in expr.coeffs.items()))


# ---------------------------------------------------------------------------
# Infeasible subsystem computation (reference
# math_opt/infeasible_subsystem.proto + compute_infeasible_subsystem)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelSubset:
    """Which parts of the model form the (irreducible) infeasible core
    (reference ModelSubsetProto): row indices and variable indices whose
    BOUNDS participate."""

    linear_constraints: list
    variable_bounds: list


@dataclasses.dataclass
class ComputeInfeasibleSubsystemResult:
    feasibility: TerminationReason  # INFEASIBLE / OPTIMAL(=feasible)
    infeasible_subsystem: ModelSubset
    is_minimal: bool


def compute_infeasible_subsystem(
        model: Model, max_rows: int = 2000
) -> ComputeInfeasibleSubsystemResult:
    """Irreducible infeasible subsystem via the deletion filter
    (reference math_opt compute_infeasible_subsystem; LP bounds/rows
    scope).  Integer requirements are relaxed first — an IIS of the LP
    relaxation is an infeasibility certificate for the MIP too (the
    converse gap, integer-only infeasibility, reports non-minimal
    feasible=INFEASIBLE with every row, matching the reference's
    'undetermined' escape hatch).
    """
    import dataclasses as _dc

    import numpy as np

    from ortools_tpu_torch.glop.simplex import solve as _glop_solve

    qp = model.storage.to_qp()
    qp = _dc.replace(qp, objective_vector=np.zeros(qp.num_variables),
                     integrality=None, maximize=False)

    def feasible(q) -> bool:
        r = _glop_solve(q)
        return r.status not in (MPSolverStatus.INFEASIBLE,)

    if feasible(qp):
        return ComputeInfeasibleSubsystemResult(
            TerminationReason.OPTIMAL, ModelSubset([], []), True)
    m, n = qp.num_constraints, qp.num_variables
    if m + n > max_rows:
        return ComputeInfeasibleSubsystemResult(
            TerminationReason.INFEASIBLE,
            ModelSubset(list(range(m)), list(range(n))), False)

    cl = np.array(qp.constraint_lower, dtype=float)
    cu = np.array(qp.constraint_upper, dtype=float)
    vl = np.array(qp.variable_lower, dtype=float)
    vu = np.array(qp.variable_upper, dtype=float)

    def build(rows_on, vars_on):
        q = _dc.replace(
            qp,
            constraint_lower=np.where(rows_on, cl, -np.inf),
            constraint_upper=np.where(rows_on, cu, np.inf),
            variable_lower=np.where(vars_on, vl, -np.inf),
            variable_upper=np.where(vars_on, vu, np.inf),
        )
        return q

    rows_on = np.ones(m, dtype=bool)
    vars_on = np.ones(n, dtype=bool)
    # deletion filter: drop each row/bound; if still infeasible without
    # it, it is not needed in the core
    for i in range(m):
        rows_on[i] = False
        if feasible(build(rows_on, vars_on)):
            rows_on[i] = True
    for j in range(n):
        if not (np.isfinite(vl[j]) or np.isfinite(vu[j])):
            continue
        vars_on[j] = False
        if feasible(build(rows_on, vars_on)):
            vars_on[j] = True
    subset = ModelSubset(
        [int(i) for i in np.nonzero(rows_on)[0]],
        [int(j) for j in np.nonzero(vars_on)[0]
         if np.isfinite(vl[j]) or np.isfinite(vu[j])],
    )
    return ComputeInfeasibleSubsystemResult(
        TerminationReason.INFEASIBLE, subset, True)
