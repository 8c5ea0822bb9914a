"""Route pure pseudo-Boolean CP models to the PB-resolution core.

Capability parity: the reference attaches PB constraints with
cutting-planes conflict analysis to its SAT core
(``ortools/sat/pb_constraint.h:526``); here the equivalent special case
in ``solve_model`` sends all-boolean linear models (the OPB path of
sat_io.py in particular) to ``_native/pbsat.cc`` via sat/pb_solver.py.

Only exact structural matches route: every variable 0/1, every
constraint one of {linear over booleans with an interval domain,
bool_or, at_most_one, exactly_one, bool_and}, no enforcement literals,
integer objective over booleans.  Anything else returns None and the
caller continues to the LCG/eager paths.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

from ortools_tpu_torch.sat import model_ir as ir


def _lit(raw: int) -> Tuple[int, bool]:
    """IR literal -> (var, negated)."""
    return (raw, False) if raw >= 0 else (-raw - 1, True)


def try_pure_pb(work: ir.CpModelIR, params, deadline: float,
                should_stop=None):
    """Returns None when the model does not qualify, else
    (status_str, values, objective_value, bound, conflicts) with
    status_str in {"OPTIMAL", "FEASIBLE", "INFEASIBLE", "UNKNOWN"}."""
    n = len(work.variables)
    if n == 0:
        return None
    for v in work.variables:
        d = v.domain
        if d.min() < 0 or d.max() > 1:
            return None
    rows: List[Tuple[str, list, list, list, int]] = []
    for ct in work.constraints:
        if ct.enforcement_literals:
            return None
        k = ct.kind
        a = ct.args
        if k == "linear":
            dom = a.domain
            if dom.is_empty():
                return None
            # interval domains only (holes would need disjunctions)
            if dom.num_intervals() != 1:
                return None
            lo, hi = dom.min(), dom.max()
            vs = list(a.vars)
            cf = [int(c) for c in a.coeffs]
            neg = [False] * len(vs)
            if lo > -(2**50):
                rows.append(("geq", cf, vs, neg, int(lo)))
            if hi < 2**50:
                rows.append(("leq", cf, vs, neg, int(hi)))
        elif k in ("bool_or", "at_most_one", "exactly_one", "bool_and"):
            vs, neg = [], []
            for raw in a.literals:
                v, ng = _lit(raw)
                vs.append(v)
                neg.append(ng)
            ones = [1] * len(vs)
            if k == "bool_or":
                rows.append(("geq", ones, vs, neg, 1))
            elif k == "at_most_one":
                rows.append(("leq", ones, vs, neg, 1))
            elif k == "exactly_one":
                rows.append(("geq", ones, vs, neg, 1))
                rows.append(("leq", ones, vs, neg, 1))
            else:  # bool_and: every literal true
                rows.append(("geq", ones, vs, neg, len(vs)))
        else:
            return None
    obj = work.objective
    if obj is not None:
        if any(not isinstance(c, int) and int(c) != c for c in obj.coeffs):
            return None

    from ortools_tpu_torch.sat.pb_solver import PbSolver, minimize

    s = PbSolver(n)
    for typ, cf, vs, neg, d in rows:
        if typ == "geq":
            s.add_geq(cf, vs, neg, d)
        else:
            s.add_leq(cf, vs, neg, d)

    # fixed-size chunks so the wall clock / interrupt flag is polled at
    # a bounded interval (one huge native call is uninterruptible)
    budget_chunk = 50_000
    if obj is None:
        while True:
            st, model = s.solve(budget_chunk)
            if st == "SAT":
                return ("OPTIMAL", [int(x) for x in model], math.nan,
                        math.nan, s.num_conflicts)
            if st == "UNSAT":
                return ("INFEASIBLE", None, math.nan, math.nan,
                        s.num_conflicts)
            if time.perf_counter() > deadline or (
                    should_stop is not None and should_stop()):
                return ("UNKNOWN", None, math.nan, math.nan,
                        s.num_conflicts)
    # optimization: minimize internally; flip sign for maximize
    sign = -1 if obj.maximize else 1
    coefs = [sign * int(c) for c in obj.coeffs]
    st, model, val = minimize(
        s, coefs, list(obj.vars), deadline=deadline,
        conflict_budget_per_call=budget_chunk,
        should_stop=should_stop)
    if st == "OPTIMAL" or st == "FEASIBLE":
        values = [int(x) for x in model]
        true_obj = sign * val + obj.offset
        bound = true_obj if st == "OPTIMAL" else (
            -math.inf if not obj.maximize else math.inf)
        return (st, values, float(true_obj), float(bound),
                s.num_conflicts)
    if st == "UNSAT":
        return ("INFEASIBLE", None, math.nan, math.nan, s.num_conflicts)
    return ("UNKNOWN", None, math.nan, math.nan, s.num_conflicts)
