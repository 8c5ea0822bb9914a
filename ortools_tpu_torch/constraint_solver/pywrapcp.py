"""Classic CP solver API (pywrapcp style).

Capability parity: ``ortools/constraint_solver/constraint_solver.h:250``
(the original Solver with IntVar/DecisionBuilder/SearchMonitor, exposed to
Python as pywrapcp) scoped to the commonly used surface:

    solver = Solver("name")
    x = solver.IntVar(0, 9, "x")
    solver.Add(x + y == 10)
    db = solver.Phase([x, y], Solver.INT_VAR_DEFAULT, Solver.INT_VALUE_DEFAULT)
    solver.NewSearch(db); while solver.NextSolution(): ... ; solver.EndSearch()
    # or: solver.Solve(db, [solver.Minimize(obj, 1), collector])

Internally each Solver wraps a CpModel and runs the sat engine; the
NewSearch/NextSolution protocol drives the engine's resumable DFS, so
enumeration is lazy like the reference's.  (The reversible trail /
demon machinery of the reference is an implementation detail the engine
replaces; see SURVEY §2.5.)
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence, Union

from ortools_tpu_torch.sat import cp_model as _cm
from ortools_tpu_torch.sat.checker import solution_is_feasible
from ortools_tpu_torch.sat.engine import Engine
from ortools_tpu_torch.sat import model_ir as _ir
from ortools_tpu_torch.utils.domain import Domain, INT_MIN

IntVar = _cm.IntVar  # classic IntVar is the same expression-capable var


class _DecisionBuilder:
    def __init__(self, variables: List[IntVar], var_strategy: int,
                 value_strategy: int) -> None:
        self.variables = variables
        self.var_strategy = var_strategy
        self.value_strategy = value_strategy


class _OptimizeVar:
    def __init__(self, maximize: bool, expr, step: int) -> None:
        self.maximize = maximize
        self.expr = expr
        self.step = step


class _SolutionCollector:
    def __init__(self, solver: "Solver", keep_all: bool) -> None:
        self._solver = solver
        self._keep_all = keep_all
        self._vars: List[IntVar] = []
        self._solutions: List[dict] = []
        self._objectives: List[Optional[int]] = []

    def Add(self, variables) -> None:
        if isinstance(variables, IntVar):
            variables = [variables]
        self._vars.extend(variables)

    add = Add

    def _record(self, values: List[int], objective: Optional[int]) -> None:
        sol = {v.index: values[v.index] for v in self._vars}
        if self._keep_all:
            self._solutions.append(sol)
            self._objectives.append(objective)
        else:
            self._solutions = [sol]
            self._objectives = [objective]

    def SolutionCount(self) -> int:
        return len(self._solutions)

    solution_count = SolutionCount

    def Value(self, sol_index: int, var: IntVar) -> int:
        return self._solutions[sol_index][var.index]

    value = Value

    def ObjectiveValue(self, sol_index: int) -> int:
        return self._objectives[sol_index]

    objective_value = ObjectiveValue


class Solver:
    # strategy constants (classic enums; engine maps them coarsely)
    INT_VAR_DEFAULT = 0
    INT_VAR_SIMPLE = 1
    CHOOSE_FIRST_UNBOUND = 2
    CHOOSE_MIN_SIZE_LOWEST_MIN = 3
    CHOOSE_RANDOM = 4
    INT_VALUE_DEFAULT = 0
    INT_VALUE_SIMPLE = 1
    ASSIGN_MIN_VALUE = 2
    ASSIGN_MAX_VALUE = 3
    ASSIGN_RANDOM_VALUE = 4

    def __init__(self, name: str = "", *, device="cuda") -> None:
        self.name = name
        self.device = device  # the device of Solve's CP-SAT solve
        self._model = _cm.CpModel()
        self._model.name = name
        self._optimize: Optional[_OptimizeVar] = None
        self._collectors: List[_SolutionCollector] = []
        # search session state
        self._engine: Optional[Engine] = None
        self._values: Optional[List[int]] = None
        self._wall = 0.0
        self._branches = 0

    # ---- model building ------------------------------------------------
    def IntVar(self, lb: int, ub: int, name: str = "") -> IntVar:
        return self._model.new_int_var(int(lb), int(ub), name)

    def BoolVar(self, name: str = "") -> IntVar:
        return self._model.new_bool_var(name)

    def IntConst(self, value: int, name: str = "") -> IntVar:
        return self._model.new_constant(int(value))

    def Add(self, ct) -> None:
        self._model.add(ct)

    def AllDifferent(self, variables) -> None:
        self._model.add_all_different(variables)

    def Sum(self, exprs):
        return _cm.LinearExpr.sum(exprs)

    def ScalProd(self, exprs, coeffs):
        return _cm.LinearExpr.weighted_sum(exprs, coeffs)

    def Max(self, *exprs):
        exprs = list(_flatten(exprs))
        hull = self._hull(exprs)
        target = self._model.new_int_var(hull[0], hull[1], "max_aux")
        self._model.add_max_equality(target, exprs)
        return target

    def Min(self, *exprs):
        exprs = list(_flatten(exprs))
        hull = self._hull(exprs)
        target = self._model.new_int_var(hull[0], hull[1], "min_aux")
        self._model.add_min_equality(target, exprs)
        return target

    def Abs(self, expr):
        hull = self._hull([expr])
        hi = max(abs(hull[0]), abs(hull[1]))
        target = self._model.new_int_var(0, hi, "abs_aux")
        self._model.add_abs_equality(target, expr)
        return target

    def AllowedAssignments(self, variables, tuples_list) -> None:
        self._model.add_allowed_assignments(variables, tuples_list)

    def _hull(self, exprs) -> tuple:
        doms = [v.domain for v in self._model.ir.variables]
        lo = min(_ir.expr_domain(_cm.LinearExpr.of(e).to_ir(), doms).min()
                 for e in exprs)
        hi = max(_ir.expr_domain(_cm.LinearExpr.of(e).to_ir(), doms).max()
                 for e in exprs)
        return int(lo), int(hi)

    # ---- monitors ------------------------------------------------------
    def Minimize(self, expr, step: int = 1) -> _OptimizeVar:
        self._optimize = _OptimizeVar(False, expr, step)
        return self._optimize

    def Maximize(self, expr, step: int = 1) -> _OptimizeVar:
        self._optimize = _OptimizeVar(True, expr, step)
        return self._optimize

    def AllSolutionCollector(self) -> _SolutionCollector:
        c = _SolutionCollector(self, keep_all=True)
        self._collectors.append(c)
        return c

    def LastSolutionCollector(self) -> _SolutionCollector:
        c = _SolutionCollector(self, keep_all=False)
        self._collectors.append(c)
        return c

    # ---- search --------------------------------------------------------
    def Phase(self, variables, var_strategy: int = 0,
              value_strategy: int = 0) -> _DecisionBuilder:
        return _DecisionBuilder(list(variables), var_strategy,
                                value_strategy)

    def _make_engine(self, db: Optional[_DecisionBuilder]) -> Engine:
        ir_model = self._model.ir
        if db is not None and db.variables:
            ir_model.search_strategies = [
                _ir.DecisionStrategyIR(
                    [v.index for v in db.variables],
                    "choose_first", "select_min_value",
                )
            ]
        var_rule = "min_domain"
        value_rule = "min"
        if db is not None:
            if db.var_strategy == self.CHOOSE_RANDOM:
                var_rule = "random"
            elif db.var_strategy == self.CHOOSE_FIRST_UNBOUND:
                var_rule = "first"
            if db.value_strategy == self.ASSIGN_MAX_VALUE:
                value_rule = "max"
            elif db.value_strategy == self.ASSIGN_RANDOM_VALUE:
                value_rule = "random"
        from ortools_tpu_torch.sat.expand import expand_model

        return Engine(expand_model(ir_model), var_rule=var_rule,
                      value_rule=value_rule)

    # -- NewSearch / NextSolution / EndSearch protocol -------------------
    def NewSearch(self, db: Optional[_DecisionBuilder] = None) -> None:
        self._engine = self._make_engine(db)
        doms = self._engine.initial_domains()
        if not self._engine.root_propagate(doms):
            self._engine = None  # infeasible at root
            return
        self._engine.start_search(doms)
        self._values = None
        self._at_solution = False

    def NextSolution(self) -> bool:
        if self._engine is None:
            return False
        e = self._engine
        if self._at_solution:
            # leave the previous solution leaf before resuming
            nxt = e._backtrack(e._stack)
            if nxt is None:
                self._engine = None
                return False
            e._current = nxt
            self._at_solution = False
        found: List[Optional[List[int]]] = [None]

        def cb(values: List[int]) -> bool:
            found[0] = values
            return False

        outcome = e.search_budget(cb, max_branches=e.max_branches)
        if found[0] is not None:
            n = len(self._model.ir.variables)
            self._values = found[0][:n]
            self._at_solution = True
            self._branches = e.num_branches
            return True
        self._engine = None
        return False

    def EndSearch(self) -> None:
        self._engine = None

    # -- one-shot Solve --------------------------------------------------
    def Solve(self, db: Optional[_DecisionBuilder] = None,
              monitors: Sequence = ()) -> bool:
        from ortools_tpu_torch.utils.device import resolve_device
        device = resolve_device(self.device)
        t0 = time.perf_counter()
        monitors = list(monitors) if not isinstance(
            monitors, _OptimizeVar
        ) else [monitors]
        opt = self._optimize
        for mon in monitors:
            if isinstance(mon, _OptimizeVar):
                opt = mon
        from ortools_tpu_torch.sat.params import SatParameters
        from ortools_tpu_torch.sat.solver import solve_model
        from ortools_tpu_torch.utils.status import SolveStatus

        if opt is not None:
            if opt.maximize:
                self._model.maximize(opt.expr)
            else:
                self._model.minimize(opt.expr)
        params = SatParameters()
        if db is not None and db.variables:
            self._model.ir.search_strategies = [
                _ir.DecisionStrategyIR(
                    [v.index for v in db.variables],
                    "choose_first", "select_min_value",
                )
            ]
        if opt is None and self._collectors and any(
            c._keep_all for c in self._collectors
        ):
            params.enumerate_all_solutions = True

            class _Cb(_cm.CpSolverSolutionCallback):
                def __init__(cb_self):
                    super().__init__()

                def on_solution_callback(cb_self):
                    vals = cb_self._values
                    for c in self._collectors:
                        c._record(vals, None)

            resp = solve_model(self._model.ir, params, _Cb(), device=device)
        else:
            resp = solve_model(self._model.ir, params, device=device)
            if resp.solution is not None:
                obj = (int(resp.objective_value)
                       if opt is not None else None)
                for c in self._collectors:
                    c._record(resp.solution, obj)
        self._wall = time.perf_counter() - t0
        self._branches = resp.num_branches
        if resp.solution is not None:
            self._values = resp.solution
        return resp.status in (SolveStatus.OPTIMAL, SolveStatus.FEASIBLE)

    # -- reading ---------------------------------------------------------
    def Value(self, var_or_expr) -> int:
        assert self._values is not None, "no current solution"
        e = _cm.LinearExpr.of(var_or_expr)
        return e._offset + sum(
            c * self._values[i] for i, c in e._coeffs.items()
        )

    def WallTime(self) -> int:
        return int(self._wall * 1000)  # classic API returns ms

    def Branches(self) -> int:
        return self._branches


def _flatten(items):
    for it in items:
        if isinstance(it, (list, tuple)):
            yield from _flatten(it)
        else:
            yield it


# ---------------------------------------------------------------------------
# Classic scheduling surface: IntervalVar / SequenceVar / Cumulative
# (reference constraint_solver.h:4643 IntervalVar, :4797 SequenceVar,
# sched_*.cc) — layered on the CP model's interval + no_overlap/cumulative
# ---------------------------------------------------------------------------


class IntervalVar:
    """Classic fixed/variable-duration interval on top of CpModel."""

    def __init__(self, solver: "Solver", start, duration_expr, end,
                 performed=None, name: str = "") -> None:
        self._solver = solver
        self._start = start
        self._duration = duration_expr
        self._end = end
        self._performed = performed  # BoolVar or None (always performed)
        self.name = name
        m = solver._model
        if performed is None:
            self._iv = m.new_interval_var(start, duration_expr, end, name)
        else:
            self._iv = m.new_optional_interval_var(
                start, duration_expr, end, performed, name)

    # expressions
    def StartExpr(self):
        return _cm.LinearExpr.of(self._start)

    def EndExpr(self):
        return _cm.LinearExpr.of(self._end)

    def DurationExpr(self):
        return _cm.LinearExpr.of(self._duration)

    def PerformedExpr(self):
        return (_cm.LinearExpr.of(self._performed)
                if self._performed is not None else _cm.LinearExpr.of(1))

    # domain accessors (pre/post solve)
    def StartMin(self) -> int:
        return self._start.domain.min()

    def StartMax(self) -> int:
        return self._start.domain.max()

    def EndMin(self) -> int:
        return self._end.domain.min()

    def EndMax(self) -> int:
        return self._end.domain.max()

    def MustBePerformed(self) -> bool:
        return self._performed is None


class SequenceVar:
    """Classic sequence variable over a disjunctive resource: exposes the
    intervals and, after solving, their chronological ranking."""

    def __init__(self, solver: "Solver", intervals: List[IntervalVar],
                 name: str = "") -> None:
        self._solver = solver
        self._intervals = list(intervals)
        self.name = name

    def Size(self) -> int:
        return len(self._intervals)

    def Interval(self, i: int) -> IntervalVar:
        return self._intervals[i]

    def RankedSequence(self) -> List[int]:
        """Indices of performed intervals in start order (post-solve)."""
        sv = self._solver
        order = [
            (sv.Value(iv._start), k)
            for k, iv in enumerate(self._intervals)
            if iv._performed is None or sv.Value(iv._performed)
        ]
        return [k for _, k in sorted(order)]


class _Disjunctive:
    def __init__(self, solver: "Solver", intervals: List[IntervalVar],
                 name: str) -> None:
        self._seq = SequenceVar(solver, intervals, name)
        solver._model.add_no_overlap([iv._iv for iv in intervals])

    def SequenceVar(self) -> SequenceVar:
        return self._seq


def _interval_methods(cls):
    def FixedDurationIntervalVar(self, start_min: int, start_max: int,
                                 duration: int, optional: bool = False,
                                 name: str = "") -> IntervalVar:
        m = self._model
        s = m.new_int_var(int(start_min), int(start_max), f"{name}_s")
        e = m.new_int_var(int(start_min) + int(duration),
                          int(start_max) + int(duration), f"{name}_e")
        perf = m.new_bool_var(f"{name}_p") if optional else None
        return IntervalVar(self, s, int(duration), e, perf, name)

    def IntervalVarBounds(self, start_min, start_max, dur_min, dur_max,
                          end_min, end_max, optional=False, name=""):
        m = self._model
        s = m.new_int_var(int(start_min), int(start_max), f"{name}_s")
        d = m.new_int_var(int(dur_min), int(dur_max), f"{name}_d")
        e = m.new_int_var(int(end_min), int(end_max), f"{name}_e")
        perf = m.new_bool_var(f"{name}_p") if optional else None
        return IntervalVar(self, s, d, e, perf, name)

    def DisjunctiveConstraint(self, intervals, name="") -> _Disjunctive:
        return _Disjunctive(self, list(intervals), name)

    def Cumulative(self, intervals, demands, capacity, name="") -> None:
        self._model.add_cumulative(
            [iv._iv for iv in intervals], list(demands), capacity)

    cls.FixedDurationIntervalVar = FixedDurationIntervalVar
    cls.IntervalVar = IntervalVarBounds
    cls.DisjunctiveConstraint = DisjunctiveConstraint
    cls.Cumulative = Cumulative
    return cls


_interval_methods(Solver)
