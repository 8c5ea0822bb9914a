"""Pure-SAT special case: route clause-only CP models to the CDCL core.

Capability parity: the reference's ``SolvePureSatModel``
(``ortools/sat/cp_model_solver.cc:4137-4168``) — when every variable is
boolean and every constraint is clause-like, the model is translated to
CNF and solved by the native CDCL solver (watched literals, 1UIP, VSIDS;
_native/cdcl.cc) instead of the CP propagation engine.  Assumptions map
to CDCL assumptions with failed-assumption cores; UNSAT runs can emit
DRAT proofs (sat/drat.py checks them).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ortools_tpu_torch.sat import model_ir as ir


def _ext(lit: int) -> int:
    """IR literal -> DIMACS literal over 0-based vars."""
    v = ir.literal_index(lit)
    return (v + 1) if lit >= 0 else -(v + 1)


def to_cnf(model: ir.CpModelIR) -> Optional[List[List[int]]]:
    """Translate a pure boolean clause-like model to CNF; None when some
    variable or constraint is out of scope."""
    for v in model.variables:
        if v.domain.min() < 0 or v.domain.max() > 1:
            return None
    clauses: List[List[int]] = []
    # fixed domains become unit clauses
    for i, v in enumerate(model.variables):
        if v.domain.is_fixed():
            val = v.domain.fixed_value()
            clauses.append([(i + 1) if val else -(i + 1)])
    for ct in model.constraints:
        neg_enf = [-_ext(lit) for lit in ct.enforcement_literals]
        k = ct.kind
        if k == "bool_or":
            clauses.append(neg_enf + [_ext(l) for l in ct.args.literals])
        elif k == "bool_and":
            for l in ct.args.literals:
                clauses.append(neg_enf + [_ext(l)])
        elif k in ("at_most_one", "exactly_one"):
            lits = [_ext(l) for l in ct.args.literals]
            for i in range(len(lits)):
                for j in range(i + 1, len(lits)):
                    clauses.append(neg_enf + [-lits[i], -lits[j]])
            if k == "exactly_one":
                clauses.append(neg_enf + lits)
        elif k == "bool_xor":
            lits = [_ext(l) for l in ct.args.literals]
            if ct.enforcement_literals or len(lits) > 8:
                return None
            # enumerate falsifying assignments (even parity of negations)
            n = len(lits)
            for mask in range(1 << n):
                ones = bin(mask).count("1")
                if ones % 2 == 1:
                    continue  # this assignment satisfies the xor
                clauses.append([
                    lits[i] if not (mask >> i) & 1 else -lits[i]
                    for i in range(n)
                ])
        elif k == "linear":
            cl = _linear_to_clause(model, ct, neg_enf)
            if cl is None:
                return None
            clauses.extend(cl)
        else:
            return None
    return clauses


def _linear_to_clause(model, ct, neg_enf) -> Optional[List[List[int]]]:
    """Clause-like linear constraints over booleans: coefficients +-1 and
    a domain that reduces to at-least-1 / at-most-0 style thresholds."""
    a = ct.args
    if any(c not in (-1, 1) for c in a.coeffs):
        return None
    lits = [(v + 1) if c > 0 else -(v + 1) for v, c in zip(a.vars, a.coeffs)]
    nneg = sum(1 for c in a.coeffs if c < 0)
    # sum of literal-values = (linear expr + nneg)
    lo = a.domain.min() + nneg
    hi = a.domain.max() + nneg
    n = len(lits)
    out: List[List[int]] = []
    if lo <= 0 and hi >= n:
        return out  # vacuous
    if lo == 1 and hi >= n:
        out.append(neg_enf + lits)  # at least one
        return out
    if lo <= 0 and hi == n - 1:
        out.append(neg_enf + [-l for l in lits])  # at least one false
        return out
    if lo <= 0 and hi == 1:
        for i in range(n):
            for j in range(i + 1, n):
                out.append(neg_enf + [-lits[i], -lits[j]])
        return out
    if lo == n:
        for l in lits:
            out.append(neg_enf + [l])  # all true
        return out
    if hi == 0:
        for l in lits:
            out.append(neg_enf + [-l])
        return out
    return None


def solve_pure_sat(model: ir.CpModelIR, deadline_conflicts: int = 0,
                   proof: bool = False
                   ) -> Optional[Tuple[int, Optional[List[int]], List[int],
                                       int]]:
    """Solve a clause-like model with the CDCL core.

    Returns None when the model is out of the pure-SAT fragment, else
    (status, values, failed_assumption_core, num_conflicts) with status
    1=SAT, 0=UNSAT, -1=UNKNOWN (budget)."""
    if model.objective is not None:
        return None
    clauses = to_cnf(model)
    if clauses is None:
        return None
    from ortools_tpu_torch.sat.cdcl import CdclSolver

    nv = len(model.variables)
    simp = None
    if not model.assumptions and not proof:
        # SAT presolve (reference simplification.cc SatPresolver): BVE +
        # subsumption; skipped under assumptions (eliminated variables
        # could be assumed) and when emitting DRAT (the proof must be
        # relative to the original formula).
        from ortools_tpu_torch.sat.simplification import presolve_cnf

        simp = presolve_cnf(clauses, nv)
        if simp.unsat:
            return 0, None, [], 0
        clauses = [list(c) for c in simp.clauses]

    s = CdclSolver(num_vars=nv, proof=proof)
    for c in clauses:
        if not s.add_clause(c):
            return 0, None, [], s.num_conflicts
    assumptions = [_ext(l) for l in model.assumptions]
    st = s.solve(assumptions=assumptions,
                 conflict_budget=deadline_conflicts)
    if st == 1:
        m = s.model()
        values = [int(m[i]) for i in range(nv)]
        if simp is not None:
            values = simp.reconstruct(values)
        return 1, values, [], s.num_conflicts
    if st == 0:
        core_ext = s.core()
        # map back to IR literals
        core = []
        for cl in core_ext:
            v = abs(cl) - 1
            core.append(v if cl > 0 else ir.negated_literal(v))
        return 0, None, core, s.num_conflicts
    return -1, None, [], s.num_conflicts
