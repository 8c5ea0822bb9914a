"""CP-SAT solve facade.

Capability parity: ``ortools/sat/cp_model_solver.cc`` SolveCpModel
(SURVEY §3.1) scoped to round 1:

  validate -> (hint check) -> search -> re-verify every solution against
  the ORIGINAL model (the reference's CHECK(SolutionIsFeasible(...))
  contract, cp_model_solver.cc:4376) -> response.

Optimization uses solve / tighten-objective / re-search to a proven
optimum (objective bound constraint added between solutions — the
destructive-improvement equivalent of the reference's objective
sharing).  Assumptions are fixed at the root; on infeasibility the full
assumption set is reported (a coarse unsat core).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import List, Optional

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.checker import solution_is_feasible, validate_model
from ortools_tpu_torch.sat.engine import Engine
from ortools_tpu_torch.sat.params import SatParameters
from ortools_tpu_torch.utils.device import resolve_device
from ortools_tpu_torch.utils.domain import Domain, INT_MAX, INT_MIN
from ortools_tpu_torch.utils.status import SolveStatus


@dataclasses.dataclass
class CpSolverResponse:
    status: SolveStatus
    solution: Optional[List[int]]
    objective_value: float
    best_objective_bound: float
    wall_time: float
    num_branches: int
    num_conflicts: int
    sufficient_assumptions_for_infeasibility: List[int] = dataclasses.field(
        default_factory=list
    )
    # time integral of log(1+gap) over the solve (reference
    # SharedResponseManager::UpdateGapIntegral); smaller is better
    gap_integral: float = 0.0


def _objective_value(obj: ir.ObjectiveIR, values: List[int]) -> int:
    return obj.offset + sum(
        c * values[v] for v, c in zip(obj.vars, obj.coeffs)
    )


class _ProvedOptimal(Exception):
    """Raised inside a portfolio candidate callback when the incumbent
    meets the root LP relaxation bound — the search can stop."""


def _solve_portfolio(model, work, obj, params, callback, deadline,
                     hint_solution, n_orig, resp, lp_bound=None):
    """Portfolio (num_workers > 1): deterministic interleaved by default,
    forked worker processes when interleave_search=False.  ``lp_bound``
    is the root LP relaxation's proven lower bound on sense*objective
    (sat/lp_propagator.py)."""
    from ortools_tpu_torch.sat.portfolio import InterleavedPortfolio
    from ortools_tpu_torch.utils.domain import Domain, INT_MIN

    # Half the workers become LNS workers on optimization models
    # (reference portfolio composition has a large LNS fleet, §2.4.6)
    num_lns = params.num_workers // 2 if obj is not None else 0
    if params.interleave_search:
        pf = InterleavedPortfolio(
            work, params.num_workers, deadline, params.max_branches,
            num_lns=num_lns, share_clauses=params.share_binary_clauses,
        )
    else:
        from ortools_tpu_torch.sat.parallel_portfolio import ParallelPortfolio

        pf = ParallelPortfolio(
            work, params.num_workers, deadline, params.max_branches,
            num_lns=num_lns, shared_tree=params.use_shared_tree_search,
        )
    state = {
        "best": hint_solution,
        "best_obj": None,
    }
    sense = 1
    if obj is not None:
        sense = -1 if obj.maximize else 1
        if hint_solution is not None:
            state["best_obj"] = sense * _objective_value(obj, hint_solution)
            if callback is not None:
                callback._on_solution(
                    hint_solution,
                    float(_objective_value(obj, hint_solution)),
                )

    def bound_ct():
        if obj is None or state["best_obj"] is None:
            return None
        coeffs = [sense * c for c in obj.coeffs]
        return ir.ConstraintIR(
            "linear",
            ir.LinearArgs(
                list(obj.vars), coeffs,
                Domain(INT_MIN,
                       state["best_obj"] - sense * obj.offset - 1),
            ),
        )

    def on_candidate(values):
        values = values[:n_orig]
        if not solution_is_feasible(model, values):
            raise AssertionError(
                "internal error: solution failed verification"
            )
        if obj is None:
            state["best"] = values
            if callback is not None:
                callback._on_solution(values, None)
            return True
        v = sense * _objective_value(obj, values)
        if state["best_obj"] is None or v < state["best_obj"]:
            state["best"] = values
            state["best_obj"] = v
            if callback is not None:
                callback._on_solution(
                    values, float(_objective_value(obj, values))
                )
            if lp_bound is not None and v <= lp_bound:
                raise _ProvedOptimal  # incumbent meets the LP bound
            return True
        return False

    from ortools_tpu_torch.sat.portfolio import PortfolioOutcome

    if (lp_bound is not None and state["best_obj"] is not None
            and state["best_obj"] <= lp_bound):
        # the hint already meets the LP bound: nothing to search
        out = PortfolioOutcome("optimal", 0, 0)
    else:
        try:
            out = pf.run(on_candidate, bound_ct, stop_on_first=obj is None,
                         best_provider=lambda: state["best"],
                         best_obj_provider=lambda: state["best_obj"])
        except _ProvedOptimal:
            out = PortfolioOutcome("optimal", pf.num_branches,
                                   pf.num_conflicts)
    best = state["best"]
    if obj is None:
        if best is not None:
            return resp(SolveStatus.OPTIMAL, best,
                        branches=pf.num_branches, conflicts=pf.num_conflicts)
        if out.outcome in ("optimal", "infeasible"):
            return resp(SolveStatus.INFEASIBLE, core=model.assumptions,
                        branches=pf.num_branches, conflicts=pf.num_conflicts)
        return resp(SolveStatus.UNKNOWN, branches=pf.num_branches,
                    conflicts=pf.num_conflicts)
    if best is None:
        if out.outcome in ("optimal", "infeasible"):
            return resp(SolveStatus.INFEASIBLE,
                        bound=-float("inf") if obj.maximize else float("inf"),
                        branches=pf.num_branches, conflicts=pf.num_conflicts,
                        core=model.assumptions)
        return resp(SolveStatus.UNKNOWN, branches=pf.num_branches,
                    conflicts=pf.num_conflicts,
                    bound=(float(sense * lp_bound) if lp_bound is not None
                           else math.nan))
    true_obj = float(_objective_value(obj, best))
    if out.outcome in ("optimal", "infeasible"):
        return resp(SolveStatus.OPTIMAL, best, true_obj, true_obj,
                    pf.num_branches, pf.num_conflicts)
    # best proven internal-sense lower bound: LP relaxation vs shaving
    bounds_int = [b for b in (lp_bound, out.proven_bound) if b is not None]
    return resp(SolveStatus.FEASIBLE, best, true_obj,
                float(sense * max(bounds_int)) if bounds_int
                else (-float("inf") if obj.maximize else float("inf")),
                pf.num_branches, pf.num_conflicts)


def solve_model(model: ir.CpModelIR, params: Optional[SatParameters] = None,
                callback=None, interrupt=None, *, device="cuda") -> CpSolverResponse:
    """``interrupt``: object with an ``interrupted`` property (e.g.
    utils.interrupt.SigintHandler); polled cooperatively by the engines
    (reference sigint wiring, cp_model_solver.cc:4080)."""
    # device: where MaxHS's hitting-set MIPs run, the card by default;
    # resolve_device raises before any work where the device is missing
    device = resolve_device(device)
    params = params or SatParameters()
    start = time.perf_counter()
    should_stop = ((lambda: interrupt.interrupted)
                   if interrupt is not None else None)

    from ortools_tpu_torch.utils.logging_util import GapIntegral

    gap = GapIntegral(time.perf_counter)

    def resp(status, solution=None, obj=math.nan, bound=math.nan,
             branches=0, conflicts=0, core=()):
        return CpSolverResponse(
            status=status,
            solution=solution,
            objective_value=obj,
            best_objective_bound=bound,
            wall_time=time.perf_counter() - start,
            num_branches=branches,
            num_conflicts=conflicts,
            sufficient_assumptions_for_infeasibility=list(core),
            gap_integral=gap.finalize(),
        )

    errs = validate_model(model)
    if errs:
        if params.log_search_progress:
            print("model invalid:", "; ".join(errs))
        return resp(SolveStatus.MODEL_INVALID)

    deadline = start + params.max_time_in_seconds
    work = model
    obj = model.objective
    n_orig = len(model.variables)

    # Assumptions: fixed at the root via unit bool_or constraints.
    if model.assumptions:
        work = dataclasses.replace(
            work,
            constraints=list(work.constraints) + [
                ir.ConstraintIR("bool_or", ir.BoolArgs([lit]))
                for lit in model.assumptions
            ],
        )

    # Expand high-level constraints (automaton/reservoir/no_overlap_2d)
    # into engine primitives; the original model keeps doing the checking.
    from ortools_tpu_torch.sat.expand import expand_model

    work = expand_model(work)

    # Presolve: domain reduction + constraint simplification
    # (reference PresolveCpModel, cp_model_solver.cc:4342).
    if params.cp_model_presolve:
        from ortools_tpu_torch.sat.presolve import presolve_model

        presolved = presolve_model(
            work,
            preserve_all_solutions=params.enumerate_all_solutions)
        if presolved is None:
            return resp(
                SolveStatus.INFEASIBLE,
                bound=math.inf if obj and not obj.maximize else -math.inf,
                core=model.assumptions,
            )
        work = presolved

    value_hints = dict(model.solution_hint)
    engine = Engine(work, deadline=deadline, should_stop=should_stop,
                    profile=params.profile_propagators,
                    max_branches=params.max_branches,
                    value_hints=value_hints)
    doms = engine.initial_domains()
    if not engine.root_propagate(doms):
        return resp(
            SolveStatus.INFEASIBLE,
            bound=math.inf if obj and not obj.maximize else -math.inf,
            core=model.assumptions,
        )

    # Hint: if it completes to a feasible solution, it seeds the search /
    # objective bound (reference QuickSolveWithHint, cp_model_solver.cc:1968).
    hint_solution = None
    if model.solution_hint:
        hint = {v: val for v, val in model.solution_hint}
        if len(hint) < len(model.variables):
            # partial hint: complete with domain minima (fixed variables
            # — e.g. model constants — complete exactly; the feasibility
            # check below filters bad guesses).  Reference behavior:
            # QuickSolveWithHint completes partial hints,
            # cp_model_solver.cc:1968.
            for i, v in enumerate(model.variables):
                if i not in hint:
                    hint[i] = v.domain.min()
        values = [int(hint[i]) for i in range(len(model.variables))]
        if solution_is_feasible(model, values):
            hint_solution = values

    # Pure-PB special case (reference pb_constraint.h:526
    # ResolvePBConflict): all-boolean models with at least one true
    # linear row route to the cutting-planes PB-resolution core
    # (sat/pb_bridge.py -> _native/pbsat.cc).  Clause-only models stay
    # on the CDCL path below, where watched-literal propagation wins.
    # DECISION problems only: optimization needs the LP-bounded descent
    # of the LCG/portfolio paths (a pure cutting-planes cutoff ladder has
    # no bound and can burn the whole budget on e.g. knapsack objectives);
    # the PB core's win is refutation, which is exactly the decision case.
    if (params.use_pb_resolution and obj is None
            and not params.enumerate_all_solutions
            and params.num_workers <= 1 and callback is None
            and not model.solution_hint
            and any(ct.kind == "linear" for ct in work.constraints)):
        from ortools_tpu_torch.sat.pb_bridge import try_pure_pb

        pb = try_pure_pb(work, params, deadline, should_stop)
        if pb is not None:
            st, values, obj_val, bound, ncf = pb
            if st in ("OPTIMAL", "FEASIBLE") and values is not None:
                values = values[:n_orig]
                if solution_is_feasible(model, values):
                    true_obj = (_objective_value(obj, values)
                                if obj is not None else math.nan)
                    return resp(SolveStatus[st], values, obj=true_obj,
                                bound=bound, conflicts=ncf)
                # verification surprise: distrust the PB core, fall
                # through to the general engines
            elif st == "INFEASIBLE":
                return resp(
                    SolveStatus.INFEASIBLE,
                    bound=math.inf if obj and not obj.maximize
                    else -math.inf,
                    conflicts=ncf, core=model.assumptions)
            # UNKNOWN: deadline expired inside the PB core — report it
            # rather than starting another engine with no budget left
            elif st == "UNKNOWN" and time.perf_counter() > deadline:
                return resp(SolveStatus.UNKNOWN, conflicts=ncf)

    # Feasibility jump: violation-guided local search on linear-representable
    # models (reference feasibility_jump.h portfolio worker) — used as a
    # fast first-solution engine; every output re-checked before use.
    if hint_solution is None and params.use_feasibility_jump and (
        len(model.variables) >= 12
    ):
        from ortools_tpu_torch.sat.feasibility_jump import (
            extract_linear_system,
            feasibility_jump,
        )

        system = extract_linear_system(work)
        if system is not None:
            fj = feasibility_jump(
                system, max_moves=params.feasibility_jump_max_moves,
                seed=params.random_seed,
            )
            if fj is not None:
                values = [int(v) for v in fj]
                if solution_is_feasible(model, values):
                    hint_solution = values

    best_solution: Optional[List[int]] = None
    best_obj: Optional[int] = None
    num_branches = 0
    num_conflicts = 0

    # Pure-SAT special case (reference SolvePureSatModel,
    # cp_model_solver.cc:4137): clause-like boolean models route to the
    # native CDCL core.
    if (obj is None and not params.enumerate_all_solutions
            and params.num_workers <= 1 and callback is None):
        from ortools_tpu_torch.sat.pure_sat import solve_pure_sat

        pure = solve_pure_sat(work)
        if pure is not None:
            st, values, core, ncf = pure
            if st == 1:
                values = values[:n_orig]
                if solution_is_feasible(model, values):
                    # decision problems report OPTIMAL on success (the
                    # reference's convention for satisfied models)
                    return resp(SolveStatus.OPTIMAL, values,
                                conflicts=ncf)
            elif st == 0:
                return resp(SolveStatus.INFEASIBLE, conflicts=ncf,
                            core=core or model.assumptions)
            # UNKNOWN (or verification surprise): fall through to the
            # propagation engine
        elif ((params.use_lcg or params.use_integer_cdcl)
                and not model.solution_hint):
            # General integer models inside the learning core: first lazy
            # clause generation (reference integer.h:453,722 — lazily
            # created bound literals, any domain size), then the eager
            # order encoding as fallback for fragments LCG doesn't cover
            # (element/table/products, done eagerly, domain-gated).
            # Hinted decision problems stay on the DFS engine, whose
            # value_hints follow the hint exactly; the CDCL core's phase
            # seeding (SetAssignmentPreference) only steers heuristically
            # and is used on the optimization path below.
            ienc = None
            if params.use_lcg:
                from ortools_tpu_torch.sat.lcg import solve_lcg

                ienc = solve_lcg(work, deadline=deadline,
                                 should_stop=should_stop)
            if ienc is None and params.use_integer_cdcl:
                from ortools_tpu_torch.sat.integer_encoding import (
                    solve_integer_cdcl,
                )

                ienc = solve_integer_cdcl(
                    work, deadline=deadline, should_stop=should_stop,
                    budget_literals=params.integer_cdcl_budget)
            if ienc is not None:
                st, values, _, ncf = ienc
                if st == 1 and values is not None:
                    values = values[:n_orig]
                    if solution_is_feasible(model, values):
                        return resp(SolveStatus.OPTIMAL, values,
                                    conflicts=ncf)
                elif st == 0:
                    return resp(SolveStatus.INFEASIBLE, conflicts=ncf,
                                core=model.assumptions)
                # UNKNOWN: fall through to the propagation engine

    # Root LP relaxation propagation (reference
    # linear_programming_constraint.h:138 run at level zero +
    # linear_relaxation.cc): exact glop duals give an objective bound,
    # an infeasibility proof, and reduced-cost strengthening; cut rounds
    # tighten the bound (sat/lp_propagator.py).
    lp_info = None
    lp_bound: Optional[int] = None  # lower bound on sense*objective (ceil'd)
    if obj is not None and params.use_lp_relaxation:
        from ortools_tpu_torch.sat.lp_propagator import root_lp_relaxation

        lp_info = root_lp_relaxation(work, obj,
                                     -1 if obj.maximize else 1,
                                     deadline=deadline)
        if lp_info is not None:
            if lp_info.infeasible:
                return resp(
                    SolveStatus.INFEASIBLE,
                    bound=-math.inf if obj.maximize else math.inf,
                    core=model.assumptions,
                )
            lp_bound = lp_info.int_bound

    if params.num_workers > 1 and not params.enumerate_all_solutions:
        return _solve_portfolio(model, work, obj, params, callback,
                                deadline, hint_solution, n_orig, resp,
                                lp_bound=lp_bound)

    if obj is None:
        solutions_found = 0

        def on_solution(values: List[int]) -> bool:
            nonlocal best_solution, solutions_found
            values = values[:n_orig]  # drop expansion auxiliaries
            if not solution_is_feasible(model, values):
                # never return an unverified solution; treat as search bug
                raise AssertionError(
                    "internal error: solution failed verification"
                )
            best_solution = values
            solutions_found += 1
            if callback is not None:
                callback._on_solution(values, None)
                if callback._stopped:
                    return False
            if params.enumerate_all_solutions:
                return True
            return False  # first solution suffices

        if hint_solution is not None and not params.enumerate_all_solutions:
            best_solution = hint_solution
            outcome = "stopped"
            if callback is not None:
                callback._on_solution(hint_solution, None)
        else:
            try:
                outcome = engine.search(doms, on_solution)
            except TimeoutError:
                outcome = "limit"
        num_branches, num_conflicts = engine.num_branches, engine.num_conflicts
        if best_solution is not None:
            # feasibility problems: every found solution is "OPTIMAL" in
            # reference terms when the search completed, FEASIBLE otherwise
            st = SolveStatus.OPTIMAL if outcome in ("done", "stopped") \
                else SolveStatus.FEASIBLE
            if params.enumerate_all_solutions and outcome == "limit":
                st = SolveStatus.FEASIBLE
            return resp(st, best_solution, branches=num_branches,
                        conflicts=num_conflicts)
        if outcome == "done":
            return resp(SolveStatus.INFEASIBLE, core=model.assumptions,
                        branches=num_branches, conflicts=num_conflicts)
        return resp(SolveStatus.UNKNOWN, branches=num_branches,
                    conflicts=num_conflicts)

    # ---- optimization ---------------------------------------------------
    sense = -1 if obj.maximize else 1  # internal: minimize sense*obj

    def internal_obj(values: List[int]) -> int:
        return sense * _objective_value(obj, values)

    if params.use_lp_relaxation:
        from ortools_tpu_torch.sat.lp_propagator import reduced_cost_tightenings

    def orig_bound(internal_b: float) -> float:
        """internal-sense lower bound -> original-sense objective bound."""
        return float(sense * internal_b)

    # Core-guided descent on the CDCL core for clause-like boolean models
    # (reference optimization.cc, the "core" portfolio configuration):
    # proves the optimum bottom-up from UNSAT cores, no tree search.
    if (params.num_workers <= 1 and not params.enumerate_all_solutions
            and not params.stop_after_first_solution
            and params.use_core_guided):
        if params.core_algorithm == "max_hs":
            from ortools_tpu_torch.sat.max_hs import minimize_max_hs as _core_min
            _core_min = functools.partial(_core_min, device=device)
        else:
            from ortools_tpu_torch.sat.core_guided import (
                minimize_core_guided as _core_min,
            )

        cg = _core_min(work, deadline=deadline, should_stop=should_stop)
        if cg is not None:
            st, values, bound, ncf = cg
            if st == 1:
                values = values[:n_orig]
                if solution_is_feasible(model, values):
                    true_obj = float(_objective_value(obj, values))
                    if callback is not None:
                        callback._on_solution(values, true_obj)
                    return resp(SolveStatus.OPTIMAL, values, true_obj,
                                true_obj, conflicts=ncf)
            elif st == 0:
                return resp(
                    SolveStatus.INFEASIBLE,
                    bound=-math.inf if obj.maximize else math.inf,
                    conflicts=ncf, core=model.assumptions,
                )
            elif st == -1 and hint_solution is None:
                b = max(float(bound),
                        float(lp_bound) if lp_bound is not None
                        else -math.inf)
                return resp(SolveStatus.UNKNOWN, conflicts=ncf,
                            bound=orig_bound(b))
            # deadline with a hint in hand, or verification surprise:
            # fall through to the engine

    # General integer optimization on the CDCL core: order-encode, then
    # assumption-driven binary descent on the objective ladder (the ft10
    # prover pattern generalized; reference objective probing).
    if (params.num_workers <= 1 and not params.enumerate_all_solutions
            and not params.stop_after_first_solution
            and (params.use_lcg or params.use_integer_cdcl)):
        # the CDCL objective ladder works on sense*sum (no offset); seed
        # it with the LP bound so the binary descent starts tighter
        lp_sum_lb = (lp_bound - sense * obj.offset
                     if lp_bound is not None else None)
        ienc = None
        if params.use_lcg:
            from ortools_tpu_torch.sat.lcg import solve_lcg

            ienc = solve_lcg(work, deadline=deadline,
                             should_stop=should_stop,
                             known_sum_lower_bound=lp_sum_lb,
                             warm_values=hint_solution)
        if ienc is None and params.use_integer_cdcl:
            from ortools_tpu_torch.sat.integer_encoding import solve_integer_cdcl

            ienc = solve_integer_cdcl(
                work, deadline=deadline, should_stop=should_stop,
                budget_literals=params.integer_cdcl_budget,
                known_sum_lower_bound=lp_sum_lb)
        if ienc is not None:
            st, values, bound, ncf = ienc

            def full_bound(ladder_b: float) -> float:
                """ladder-units bound -> internal-sense bound (w/ offset),
                combined with the LP bound."""
                b = ladder_b + sense * obj.offset
                if lp_bound is not None:
                    b = max(b, float(lp_bound))
                return b

            if st == 1 and values is not None:
                values = values[:n_orig]
                if solution_is_feasible(model, values):
                    true_obj = float(_objective_value(obj, values))
                    if callback is not None:
                        callback._on_solution(values, true_obj)
                    return resp(SolveStatus.OPTIMAL, values, true_obj,
                                true_obj, conflicts=ncf)
            elif st == 0:
                return resp(
                    SolveStatus.INFEASIBLE,
                    bound=-math.inf if obj.maximize else math.inf,
                    conflicts=ncf, core=model.assumptions,
                )
            elif st == -1 and values is not None:
                values = values[:n_orig]
                if solution_is_feasible(model, values):
                    true_obj = float(_objective_value(obj, values))
                    if callback is not None:
                        callback._on_solution(values, true_obj)
                    if (lp_bound is not None
                            and internal_obj(values) <= lp_bound):
                        # incumbent meets the LP bound: proven optimal
                        return resp(SolveStatus.OPTIMAL, values, true_obj,
                                    true_obj, conflicts=ncf)
                    return resp(SolveStatus.FEASIBLE, values, true_obj,
                                orig_bound(full_bound(bound)),
                                conflicts=ncf)
            elif st == -1 and hint_solution is None:
                return resp(SolveStatus.UNKNOWN, conflicts=ncf,
                            bound=orig_bound(full_bound(bound)))
            # verification surprise / deadline with hint: engine fallback

    if hint_solution is not None:
        best_solution = hint_solution
        best_obj = internal_obj(hint_solution)
        if callback is not None:
            callback._on_solution(hint_solution,
                                  float(_objective_value(obj, hint_solution)))

    # Node-level LP re-propagation inside the CP tree (reference
    # linear_programming_constraint.h Propagate at every level): one
    # persistent warm dual simplex shared by every descent rung.
    node_lp = None
    if params.use_lp_relaxation and lp_info is not None:
        from ortools_tpu_torch.sat.lp_propagator import NodeLpPropagator

        cand = NodeLpPropagator(work, obj, sense)
        if cand.ok:
            node_lp = cand

    limit_hit = False
    while True:
        if (best_obj is not None and lp_bound is not None
                and best_obj <= lp_bound):
            break  # incumbent meets the LP relaxation bound: optimal
        bound_cts = []
        if best_obj is not None:
            # objective < best  (internal minimization)
            coeffs = [sense * c for c in obj.coeffs]
            bound_cts.append(ir.ConstraintIR(
                "linear",
                ir.LinearArgs(list(obj.vars), coeffs,
                              Domain(INT_MIN,
                                     best_obj - sense * obj.offset - 1)),
            ))
            if lp_info is not None:
                # reduced-cost strengthening under the incumbent cutoff
                # (linear_programming_constraint.cc); sound because the
                # sub-search only looks for strictly better solutions
                for v, nlo, nhi in reduced_cost_tightenings(
                        lp_info, best_obj - 1):
                    bound_cts.append(ir.ConstraintIR(
                        "linear",
                        ir.LinearArgs(
                            [v], [1],
                            Domain(nlo if nlo is not None else INT_MIN,
                                   nhi if nhi is not None else INT_MAX)),
                    ))
        work_iter = dataclasses.replace(
            work, constraints=list(work.constraints) + bound_cts
        )
        engine = Engine(work_iter, deadline=deadline,
                        should_stop=should_stop,
                        max_branches=params.max_branches - num_branches,
                        value_hints=value_hints,
                        lp_propagator=node_lp,
                        lp_cutoff=(best_obj - 1 if best_obj is not None
                                   else None))
        doms = engine.initial_domains()
        if not engine.root_propagate(doms):
            break  # no better solution exists: current best is optimal

        improved: List[Optional[List[int]]] = [None]

        def on_solution(values: List[int]) -> bool:
            values = values[:n_orig]  # drop expansion auxiliaries
            if not solution_is_feasible(model, values):
                raise AssertionError(
                    "internal error: solution failed verification"
                )
            improved[0] = values
            return False  # restart with tightened bound

        try:
            outcome = engine.search(doms, on_solution)
        except TimeoutError:
            outcome = "limit"
        num_branches += engine.num_branches
        num_conflicts += engine.num_conflicts
        if improved[0] is not None:
            best_solution = improved[0]
            best_obj = internal_obj(best_solution)
            gap.update(float(best_obj),
                       float(lp_bound) if lp_bound is not None
                       else -math.inf)
            if callback is not None:
                callback._on_solution(
                    best_solution, float(_objective_value(obj, best_solution))
                )
                if callback._stopped:
                    limit_hit = True
                    break
            continue
        if outcome == "done":
            break  # search space exhausted: best is optimal
        limit_hit = True
        break

    if best_solution is None:
        if limit_hit:
            return resp(SolveStatus.UNKNOWN, branches=num_branches,
                        conflicts=num_conflicts,
                        bound=(orig_bound(lp_bound)
                               if lp_bound is not None else math.nan))
        return resp(
            SolveStatus.INFEASIBLE,
            bound=-math.inf if obj.maximize else math.inf,
            branches=num_branches, conflicts=num_conflicts,
            core=model.assumptions,
        )
    true_obj = float(_objective_value(obj, best_solution))
    if limit_hit:
        return resp(SolveStatus.FEASIBLE, best_solution, true_obj,
                    orig_bound(lp_bound) if lp_bound is not None
                    else (-math.inf if obj.maximize else math.inf),
                    num_branches, num_conflicts)
    return resp(SolveStatus.OPTIMAL, best_solution, true_obj, true_obj,
                num_branches, num_conflicts)
