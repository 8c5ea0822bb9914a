"""Root LP-relaxation propagator for CP optimization models.

Capability parity: ``ortools/sat/linear_programming_constraint.h:138``
(the LP propagator, run here at level zero), ``linear_relaxation.cc``
(building a linear relaxation of a CP model), and ``sat/cuts.cc``
(cut separation — reused from ``ortools_tpu.mip.cuts``).

Design: the extraction RELAXES the model — every constraint kind without
a linear form is simply skipped, and enforced (reified) rows are dropped
— so the LP optimum is always a valid objective bound for the full CP
model.  The LP rides the exact dual-capable glop simplex, whose duals
make reduced-cost domain fixing sound (the reference's
``ReducedCostStrengthening``, linear_programming_constraint.cc).  Cut
rounds (MIR + cover + clique on the all-integer relaxation) tighten the
root bound the way the reference's root-cut loop does.

Uses in the solve path (sat/solver.py):
  * objective lower bound: early-stops the objective descent, reported
    as ``best_objective_bound`` when the search times out;
  * LP infeasibility proves model infeasibility;
  * reduced-cost tightenings become unit linear constraints of the
    incumbent-bounded sub-search.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.sat import model_ir as ir

_HUGE = 1e15
# dense-simplex budget: the glop tableau is m x (n+m) floats
_MAX_TABLEAU = 4_000_000
_MAX_VARS = 20_000


@dataclasses.dataclass
class RootLpInfo:
    """Outcome of the root LP relaxation (internal minimization sense)."""

    infeasible: bool
    # ceil'd integer lower bound on sense*objective (incl. offset);
    # None when the LP did not reach optimality
    int_bound: Optional[int]
    lp_objective: float  # exact LP optimum (incl. offset)
    x_lp: Optional[np.ndarray]  # over model variables
    reduced_costs: Optional[np.ndarray]
    var_lb: Optional[np.ndarray]
    var_ub: Optional[np.ndarray]
    covered_constraints: int
    total_constraints: int
    cut_rounds_applied: int


def _lit_term(lit: int) -> Tuple[int, int, int]:
    """literal -> (var, coeff, offset) with value = coeff*x + offset."""
    v = ir.literal_index(lit)
    return (v, 1, 0) if lit >= 0 else (v, -1, 1)


def extract_relaxation(work: ir.CpModelIR):
    """Linear relaxation rows of every linear-representable constraint.

    Returns ``(a, row_lb, row_ub, var_lb, var_ub, covered)`` or None when
    no row is representable.  Non-representable / enforced constraints
    are skipped — the result is a relaxation, never a restriction
    (reference linear_relaxation.cc:AppendLinearConstraintRelaxation).
    """
    n = len(work.variables)
    if n == 0:
        return None
    var_lb = np.empty(n)
    var_ub = np.empty(n)
    for i, v in enumerate(work.variables):
        lo, hi = v.domain.min(), v.domain.max()
        var_lb[i] = float(lo) if lo > -_HUGE else -np.inf
        var_ub[i] = float(hi) if hi < _HUGE else np.inf

    rows_i: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    lbs: List[float] = []
    ubs: List[float] = []
    covered = 0

    def add_row(coeffs: dict, lo: float, hi: float) -> None:
        k = len(lbs)
        for v, c in coeffs.items():
            if c != 0.0:
                rows_i.append(k)
                cols.append(v)
                vals.append(c)
        lbs.append(lo)
        ubs.append(hi)

    for ct in work.constraints:
        if ct.enforcement_literals:
            continue  # relaxed away (no big-M: keeps the LP well-scaled)
        a = ct.args
        k = ct.kind
        if k in ("bool_or", "at_most_one", "exactly_one", "bool_and"):
            coeffs: dict = {}
            offset = 0
            for lit in a.literals:
                v, c, off = _lit_term(lit)
                coeffs[v] = coeffs.get(v, 0.0) + float(c)
                offset += off
            if k == "bool_or":
                lo, hi = 1.0 - offset, np.inf
            elif k == "at_most_one":
                lo, hi = -np.inf, 1.0 - offset
            elif k == "exactly_one":
                lo, hi = 1.0 - offset, 1.0 - offset
            else:  # bool_and with no enforcement: all literals true
                nl = len(a.literals)
                lo, hi = float(nl - offset), float(nl - offset)
            add_row(coeffs, lo, hi)
            covered += 1
        elif k == "linear":
            dom = a.domain
            if dom.is_empty():
                return "infeasible"
            coeffs = {}
            for v, c in zip(a.vars, a.coeffs):
                coeffs[v] = coeffs.get(v, 0.0) + float(c)
            lo = float(dom.min()) if dom.min() > -_HUGE else -np.inf
            hi = float(dom.max()) if dom.max() < _HUGE else np.inf
            add_row(coeffs, lo, hi)
            covered += 1
        elif k == "lin_max":
            # target >= each expr  (hull relaxation of max)
            tgt = a.target
            for e in a.exprs:
                coeffs = {}
                for v, cc in zip(tgt.vars, tgt.coeffs):
                    coeffs[v] = coeffs.get(v, 0.0) + float(cc)
                for v, cc in zip(e.vars, e.coeffs):
                    coeffs[v] = coeffs.get(v, 0.0) - float(cc)
                add_row(coeffs, float(e.offset) - float(tgt.offset),
                        np.inf)
            covered += 1
        # every other kind: relaxed away below, except the scheduling
        # ENERGY rows added after this loop

    # scheduling completion-time cuts (reference sat/scheduling_cuts.cc
    # CreateCompletionTimeCuts / cumulative variant), via the mean-busy-
    # time bound: a resource of capacity C processes at most C energy per
    # unit time from r = min earliest start, so the energy-weighted mean
    # busy moment satisfies  sum e_i (s_i + d_i/2) >= E (r + E/(2C)),
    # i.e.  sum e_i s_i >= r E + E^2/(2C) - sum e_i d_i / 2,
    # with e_i = d_i (disjunctive, C = 1) or d_i * dem_i (cumulative).
    intervals: dict = {}
    for idx, ct in enumerate(work.constraints):
        if ct.kind == "interval" and not ct.enforcement_literals:
            intervals[idx] = ct.args

    def fixed_size(args) -> Optional[int]:
        e = args.size
        if e.vars:
            return None
        return int(e.offset)

    def start_lb(args) -> float:
        lo = float(args.start.offset)
        for v, c in zip(args.start.vars, args.start.coeffs):
            lo += c * (var_lb[v] if c > 0 else var_ub[v])
        return lo

    def add_energy_row(members, energies, durs, cap: float) -> None:
        coeffs: dict = {}
        const = 0.0
        r = math.inf
        for args, e in zip(members, energies):
            const += e * float(args.start.offset)
            for v, c in zip(args.start.vars, args.start.coeffs):
                coeffs[v] = coeffs.get(v, 0.0) + e * float(c)
            r = min(r, start_lb(args))
        if not coeffs or not math.isfinite(r):
            return
        total = float(sum(energies))
        ed = float(sum(e * d for e, d in zip(energies, durs)))
        rhs = r * total + total * total / (2.0 * cap) - ed / 2.0 - const
        add_row(coeffs, rhs, np.inf)

    for ct in work.constraints:
        if ct.enforcement_literals:
            continue
        if ct.kind == "no_overlap":
            members, durs = [], []
            for k in ct.args.intervals:
                args = intervals.get(k)
                if args is None:
                    continue
                d = fixed_size(args)
                if d is None or d <= 0:
                    continue
                members.append(args)
                durs.append(float(d))
            if len(members) >= 2:
                add_energy_row(members, durs, durs, 1.0)
        elif ct.kind == "cumulative":
            a = ct.args
            if a.capacity.vars:
                continue
            cap = float(a.capacity.offset)
            if cap <= 0:
                continue
            members, energies, durs = [], [], []
            for k, dem in zip(a.intervals, a.demands):
                args = intervals.get(k)
                if args is None or dem.vars:
                    continue
                d = fixed_size(args)
                if d is None or d <= 0 or dem.offset <= 0:
                    continue
                members.append(args)
                durs.append(float(d))
                energies.append(float(d) * float(dem.offset))
            if len(members) >= 2:
                add_energy_row(members, energies, durs, cap)

    if not lbs:
        return None
    a_mat = sp.csr_matrix(
        (vals, (rows_i, cols)), shape=(len(lbs), n))
    return (a_mat, np.asarray(lbs), np.asarray(ubs), var_lb, var_ub,
            covered)


def root_lp_relaxation(work: ir.CpModelIR, obj: ir.ObjectiveIR, sense: int,
                       deadline: float = math.inf, cut_rounds: int = 3,
                       max_cuts_per_round: int = 100,
                       ) -> Optional[RootLpInfo]:
    """Solve the root LP relaxation of ``min sense*objective`` with cut
    rounds; return bound/duals or None when out of scope."""
    from ortools_tpu_torch.glop import simplex as glop
    from ortools_tpu_torch.models.lp import QuadraticProgram

    ext = extract_relaxation(work)
    if ext is None:
        return None
    total = len(work.constraints)
    if ext == "infeasible":
        return RootLpInfo(True, None, math.inf, None, None, None, None,
                          0, total, 0)
    a_mat, row_lb, row_ub, var_lb, var_ub, covered = ext
    n = a_mat.shape[1]
    if n > _MAX_VARS or a_mat.shape[0] * (n + a_mat.shape[0]) > _MAX_TABLEAU:
        return None

    c = np.zeros(n)
    for v, coef in zip(obj.vars, obj.coeffs):
        c[v] += sense * float(coef)
    const = sense * float(obj.offset)

    def mk_qp(mat, rl, ru):
        return QuadraticProgram(
            objective_vector=c, constraint_matrix=mat,
            constraint_lower=rl, constraint_upper=ru,
            variable_lower=var_lb, variable_upper=var_ub,
            objective_constant=const)

    res = glop.solve(mk_qp(a_mat, row_lb, row_ub))
    from ortools_tpu_torch.utils.status import MPSolverStatus
    if res.status == MPSolverStatus.INFEASIBLE:
        return RootLpInfo(True, None, math.inf, None, None, None, None,
                          covered, total, 0)
    if res.status != MPSolverStatus.OPTIMAL:
        return None

    # Root cut loop (reference linear_programming_constraint.cc root
    # cuts; separation from mip/cuts.py — every CP variable is integer).
    from ortools_tpu_torch.mip.cuts import generate_cuts
    applied = 0
    integrality = np.ones(n, dtype=bool)
    cur_a, cur_lb, cur_ub = a_mat, row_lb, row_ub
    for _ in range(cut_rounds):
        if time.perf_counter() > deadline:
            break
        frac = np.abs(res.primal_solution - np.round(res.primal_solution))
        if float(frac.max(initial=0.0)) < 1e-6:
            break  # integral LP optimum: cuts cannot separate
        pool = generate_cuts(cur_a, cur_lb, cur_ub, var_lb, var_ub,
                             integrality, res.primal_solution,
                             max_cuts=max_cuts_per_round)
        if pool is None:
            break
        new_rows = a_mat.shape[0] + pool.rows.shape[0]
        if new_rows * (n + new_rows) > _MAX_TABLEAU:
            break
        cur_a = sp.vstack([cur_a, pool.rows], format="csr")
        cur_lb = np.concatenate(
            [cur_lb, np.full(pool.rows.shape[0], -np.inf)])
        cur_ub = np.concatenate([cur_ub, pool.rhs])
        new_res = glop.solve(mk_qp(cur_a, cur_lb, cur_ub))
        if new_res.status != MPSolverStatus.OPTIMAL:
            break  # keep the last clean optimum
        res = new_res
        applied += 1

    z = float(res.objective_value)
    # all CP variables and objective coefficients are integers, so the
    # objective is integer-valued: round the bound up
    int_bound = int(math.ceil(z - 1e-6))
    return RootLpInfo(
        infeasible=False, int_bound=int_bound, lp_objective=z,
        x_lp=res.primal_solution, reduced_costs=res.reduced_costs,
        var_lb=var_lb, var_ub=var_ub, covered_constraints=covered,
        total_constraints=total, cut_rounds_applied=applied)


def reduced_cost_tightenings(info: RootLpInfo, cutoff: int,
                             ) -> List[Tuple[int, Optional[int],
                                             Optional[int]]]:
    """Domain tightenings valid for every solution with internal
    objective <= ``cutoff`` (reduced-cost strengthening,
    linear_programming_constraint.cc).

    At an optimal basis with value z, a nonbasic variable at its lower
    bound with reduced cost r > 0 satisfies obj >= z + r*(x - lb), so
    x <= lb + (cutoff - z)/r; symmetrically at the upper bound.
    Returns ``(var, new_lb_or_None, new_ub_or_None)`` triples.
    """
    if info.x_lp is None or info.reduced_costs is None:
        return []
    slack = float(cutoff) - info.lp_objective
    if slack < 0:
        return []  # no solution <= cutoff exists at all
    out: List[Tuple[int, Optional[int], Optional[int]]] = []
    x, rc = info.x_lp, info.reduced_costs
    lb, ub = info.var_lb, info.var_ub
    for j in range(len(x)):
        r = float(rc[j])
        if r > 1e-9 and np.isfinite(lb[j]) and x[j] <= lb[j] + 1e-7:
            new_ub = int(math.floor(lb[j] + slack / r + 1e-9))
            if not np.isfinite(ub[j]) or new_ub < int(ub[j]):
                out.append((j, None, new_ub))
        elif r < -1e-9 and np.isfinite(ub[j]) and x[j] >= ub[j] - 1e-7:
            new_lb = int(math.ceil(ub[j] - slack / (-r) - 1e-9))
            if not np.isfinite(lb[j]) or new_lb > int(lb[j]):
                out.append((j, new_lb, None))
    return out


class NodeLpPropagator:
    """Node-level LP re-propagation inside the CP tree (reference
    linear_programming_constraint.h:138 Propagate() — the propagator
    the reference runs at EVERY level, not only the root).

    Holds one persistent ``RevisedSimplex`` over the model's linear
    relaxation; at a node the current domains become variable bounds and
    the DUAL simplex re-solves warm (the basis stays dual-feasible under
    bound changes — glop/revised_simplex.cc:3058 DualMinimize pattern).
    Outcomes per call:

    - LP infeasible           -> the node is infeasible (raise-worthy);
    - ceil(z) > cutoff        -> objective-bound prune;
    - else                    -> reduced-cost domain tightenings valid
                                 under the cutoff.
    """

    def __init__(self, work: ir.CpModelIR, obj: ir.ObjectiveIR,
                 sense: int) -> None:
        from ortools_tpu_torch.glop.simplex import RevisedSimplex
        from ortools_tpu_torch.models.lp import QuadraticProgram

        self.ok = False
        ext = extract_relaxation(work)
        if ext is None or ext == "infeasible":
            return
        a_mat, row_lb, row_ub, var_lb, var_ub, covered = ext
        n = a_mat.shape[1]
        if n > _MAX_VARS or \
                a_mat.shape[0] * (n + a_mat.shape[0]) > _MAX_TABLEAU:
            return
        c = np.zeros(n)
        for v, coef in zip(obj.vars, obj.coeffs):
            c[v] += sense * float(coef)
        self.qp = QuadraticProgram(
            objective_vector=c, constraint_matrix=a_mat,
            constraint_lower=row_lb, constraint_upper=row_ub,
            variable_lower=var_lb, variable_upper=var_ub,
            objective_constant=sense * float(obj.offset))
        self._sx = RevisedSimplex(self.qp)
        self._cold = True
        self.n = n
        self.num_calls = 0
        self.num_prunes = 0
        self.ok = True

    def propagate(self, doms, cutoff: Optional[int], deadline: float
                  ) -> Optional[List[Tuple[int, Optional[int],
                                           Optional[int]]]]:
        """Returns tightenings, "infeasible" on a proven prune, or None
        when the LP did not conclude (timeout/numerical — never prune)."""
        from ortools_tpu_torch.utils.status import MPSolverStatus

        self.num_calls += 1
        lb = np.array([float(doms[v].min()) for v in range(self.n)])
        ub = np.array([float(doms[v].max()) for v in range(self.n)])
        try:
            if self._cold:
                self._sx.set_variable_bounds(lb, ub)
                st = self._sx.primal_solve(deadline=deadline)
                self._cold = False
            else:
                st = self._sx.resolve(lb, ub, deadline=deadline)
        except Exception:
            return None
        if st == MPSolverStatus.INFEASIBLE:
            self.num_prunes += 1
            return "infeasible"
        if st != MPSolverStatus.OPTIMAL:
            return None
        res = self._sx.result(st)
        z = float(res.objective_value)
        int_bound = int(math.ceil(z - 1e-6))
        if cutoff is not None and int_bound > cutoff:
            self.num_prunes += 1
            return "infeasible"
        if cutoff is None:
            return []
        info = RootLpInfo(
            infeasible=False, int_bound=int_bound, lp_objective=z,
            x_lp=res.primal_solution, reduced_costs=res.reduced_costs,
            var_lb=lb, var_ub=ub, covered_constraints=0,
            total_constraints=0, cut_rounds_applied=0)
        return reduced_cost_tightenings(info, cutoff)
