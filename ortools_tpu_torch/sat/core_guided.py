"""Core-guided objective descent (OLL) on the native CDCL core.

Capability parity: the reference's core-guided optimization workers
(``ortools/sat/optimization.cc`` — ``MinimizeWithCoreAndLazyEncoding``-style
descent; the ``core`` portfolio configuration in ``cp_model_search.cc``).
For pure boolean clause-like models with a linear objective over booleans,
we repeatedly solve under the assumption that every remaining cost literal
is false; each UNSAT core raises the proven lower bound by the core's
minimum weight and is relaxed through a totalizer whose counting outputs
become new (deferred) cost literals — the OLL algorithm (Andres et al.;
the reference cites the same family).  Unlike the propagation engine this
proves optimality bottom-up: the first SAT answer *is* the optimum.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.pure_sat import to_cnf


def _totalizer(s, lits: Sequence[int]) -> List[int]:
    """Totalizer counting outputs over DIMACS literals: returns ``outs``
    with ``outs[j-1]`` forced true whenever at least ``j`` of ``lits`` are
    true (single-direction Bailleux–Boutaouy encoding; the other direction
    is unnecessary for soft outputs that only ever carry cost)."""
    if len(lits) == 1:
        return [lits[0]]
    mid = len(lits) // 2
    a = _totalizer(s, lits[:mid])
    b = _totalizer(s, lits[mid:])
    p, q = len(a), len(b)
    r = [s.new_var() + 1 for _ in range(p + q)]
    for i in range(p):
        s.add_clause([-a[i], r[i]])
    for j in range(q):
        s.add_clause([-b[j], r[j]])
    for i in range(1, p + 1):
        for j in range(1, q + 1):
            s.add_clause([-a[i - 1], -b[j - 1], r[i + j - 1]])
    return r


def _boolean_objective(model: ir.CpModelIR
                       ) -> Optional[Tuple[Dict[int, int], int, int]]:
    """Normalize the objective to positive weights on DIMACS literals.

    Returns (weights, offset, sense) where minimizing
    ``sum(w[lit] * [lit true]) + offset`` equals the model objective
    (times ``sense``); None when some objective variable is non-boolean.
    """
    obj = model.objective
    sense = -1 if obj.maximize else 1
    weights: Dict[int, int] = {}
    offset = 0
    for v, c in zip(obj.vars, obj.coeffs):
        var = model.variables[v]
        if var.domain.min() < 0 or var.domain.max() > 1:
            return None
        c = sense * c
        if c == 0:
            continue
        if c > 0:
            weights[v + 1] = weights.get(v + 1, 0) + c
        else:
            # c*x = c + |c|*(1-x)
            weights[-(v + 1)] = weights.get(-(v + 1), 0) - c
            offset += c
    # cancel opposite-literal pairs: one of {l, -l} is always true
    for lit in [l for l in list(weights) if l > 0 and -l in weights]:
        both = min(weights[lit], weights[-lit])
        offset += both
        for l in (lit, -lit):
            weights[l] -= both
            if weights[l] == 0:
                del weights[l]
    return weights, offset, sense


def minimize_core_guided(
    model: ir.CpModelIR,
    deadline: Optional[float] = None,
    should_stop=None,
    conflict_slice: int = 50_000,
) -> Optional[Tuple[int, Optional[List[int]], int, int]]:
    """Core-guided optimization of a clause-like boolean model.

    Returns None when the model is outside the fragment (non-boolean
    variables/constraints, assumptions present), else
    ``(status, values, bound, num_conflicts)`` with status 1=OPTIMAL
    (values is the optimal assignment over the original variables and
    bound its internal-sense objective value), 0=INFEASIBLE,
    -1=UNKNOWN (deadline/stop hit; bound is the proven lower bound).
    """
    if model.objective is None or model.assumptions:
        return None
    norm = _boolean_objective(model)
    if norm is None:
        return None
    weights, offset, sense = norm
    base = dataclasses.replace(model, objective=None)
    clauses = to_cnf(base)
    if clauses is None:
        return None

    from ortools_tpu_torch.sat.cdcl import CdclSolver

    n_orig = len(model.variables)
    s = CdclSolver(num_vars=n_orig)
    for c in clauses:
        if not s.add_clause(c):
            return 0, None, 0, s.num_conflicts
    lb = 0
    while True:
        assumptions = sorted(weights)
        assumptions = [-l for l in assumptions]
        st = s.solve(assumptions=assumptions, conflict_budget=conflict_slice)
        while st == -1:
            if should_stop is not None and should_stop():
                return -1, None, lb + offset, s.num_conflicts
            if deadline is not None and time.monotonic() > deadline:
                return -1, None, lb + offset, s.num_conflicts
            st = s.solve(assumptions=assumptions,
                         conflict_budget=conflict_slice)
        if st == 1:
            m = s.model()
            values = [int(m[i]) for i in range(n_orig)]
            return 1, values, lb + offset, s.num_conflicts
        core = s.core()  # failed assumptions, each is -lit for a cost lit
        if not core:
            return 0, None, lb + offset, s.num_conflicts
        cost_lits = [-c for c in core]
        wmin = min(weights[l] for l in cost_lits)
        lb += wmin
        for l in cost_lits:
            weights[l] -= wmin
            if weights[l] == 0:
                del weights[l]
        if len(cost_lits) > 1:
            outs = _totalizer(s, cost_lits)
            # k true literals in the core cost (k-1)*wmin beyond the wmin
            # already charged: outputs 2..k are then forced true.
            for j in range(2, len(outs) + 1):
                o = outs[j - 1]
                weights[o] = weights.get(o, 0) + wmin
