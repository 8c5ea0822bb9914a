"""CP model presolve.

Capability parity: ``ortools/sat/cp_model_presolve.{h,cc}`` (SURVEY §2.4.2)
scoped to the structural core of its rule set:

- root fix-point domain reduction (every propagator run once to a fixed
  point; variable domains in the IR are tightened accordingly);
- removal of entailed constraints (satisfied for every assignment within
  the reduced domains);
- singleton linear constraints folded into domains;
- duplicate constraint elimination (same kind/args/enforcement);
- empty-enforcement cleanup (constraints with a false enforcement literal
  dropped).

The presolved model is equisatisfiable with identical variable set (no
renumbering), so solutions transfer 1:1 and the original-model checker
contract is unaffected.  Returns None when root propagation proves
infeasibility.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from typing import List, Optional

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.engine import Conflict, Engine
from ortools_tpu_torch.utils.domain import Domain


def presolve_model(model: ir.CpModelIR,
                   preserve_all_solutions: bool = False
                   ) -> Optional[ir.CpModelIR]:
    """Domain-reduce and simplify; None = proven infeasible at the root.

    With ``preserve_all_solutions`` the solution SET is kept identical
    (for enumeration); otherwise solution-pruning-but-satisfiability-
    preserving rules (pure-literal dual fixing) also run."""
    engine = Engine(model)
    doms = engine.initial_domains()
    if not engine.root_propagate(doms):
        return None

    new_vars = [
        ir.IntegerVariableIR(v.name, doms[i])
        for i, v in enumerate(model.variables)
    ]

    kept: List[ir.ConstraintIR] = []
    index_map = {}  # old constraint index -> new index
    seen = set()
    for old_idx, ct in enumerate(model.constraints):
        # Interval constraints are indexed by scheduling constraints and
        # must survive (their enforcement literals are also kept verbatim
        # so optional-interval presence still reads correctly).
        if ct.kind == "interval":
            index_map[old_idx] = len(kept)
            kept.append(ct)
            continue
        # drop constraints never active
        dead = False
        enf: List[int] = []
        for lit in ct.enforcement_literals:
            v = ir.literal_index(lit)
            d = doms[v]
            if d.is_fixed():
                val = bool(d.fixed_value()) == (lit >= 0)
                if not val:
                    dead = True
                    break
                continue  # literal fixed true: remove from the list
            enf.append(lit)
        if dead:
            continue
        if ct.kind == "linear":
            reduced = _diophantine_reduce(ct, enf)
            if reduced is None:  # unsatisfiable body
                if not enf:
                    return None
                # enforcement must fail: emit the negated-enforcement clause
                ct = ir.ConstraintIR("bool_or", ir.BoolArgs(
                    [ir.negated_literal(l) for l in enf]))
                enf = []
            else:
                ct = reduced
        if ct.kind in ("int_prod", "int_div"):
            # PresolveIntProd / PresolveIntDiv (reference
            # cp_model_presolve.cc): with every factor but one fixed the
            # product is affine, and a fixed positive divisor with a
            # sign-definite numerator linearizes exactly — both rewrites
            # move the constraint from the no-learning DFS engine onto
            # the linear/LCG path.
            rewritten = _rewrite_prod_div(ct, doms)
            if rewritten is not None:
                ct = dataclasses.replace(rewritten,
                                         enforcement_literals=enf)
        if ct.kind == "linear" and not enf:
            a = ct.args
            live = [(v, c) for v, c in zip(a.vars, a.coeffs) if c != 0]
            if len(live) == 0:
                if not a.domain.contains(0):
                    # infeasible constant constraint survived propagation
                    # only if enforcement made it vacuous; no enforcement
                    # here -> infeasible model
                    return None
                continue  # trivially true
            if len(live) == 1:
                # singleton: already folded into the domain by propagation
                v, c = live[0]
                if a.domain.num_intervals() == 1 or doms[v].size() <= 4096:
                    continue
        if _entailed(ct, doms):
            continue
        key = _constraint_key(ct, enf)
        if key in seen:
            continue
        seen.add(key)
        index_map[old_idx] = len(kept)
        kept.append(dataclasses.replace(ct, enforcement_literals=enf))

    # remap interval references in scheduling constraints
    for i, ct in enumerate(kept):
        if ct.kind in ("no_overlap",):
            kept[i] = dataclasses.replace(ct, args=ir.NoOverlapArgs(
                [index_map[k] for k in ct.args.intervals]
            ))
        elif ct.kind == "cumulative":
            kept[i] = dataclasses.replace(ct, args=ir.CumulativeArgs(
                ct.args.capacity,
                [index_map[k] for k in ct.args.intervals],
                ct.args.demands,
            ))
        elif ct.kind == "no_overlap_2d":
            kept[i] = dataclasses.replace(ct, args=ir.NoOverlap2DArgs(
                [index_map[k] for k in ct.args.x_intervals],
                [index_map[k] for k in ct.args.y_intervals],
            ))

    out = dataclasses.replace(model, variables=new_vars, constraints=kept)
    # Round-2 depth: clique merging + probing (size-gated; both preserve
    # the 1:1 variable indexing contract).
    out = setppc_dominance(out)
    if not preserve_all_solutions:
        out = pure_literal_fixing(out)
        out = dual_bound_fixing(out)
        out = binary_dominance(out)
    out = merge_cliques(out)
    # DetectAndProcessAtMostOneInLinear: clique-aware activity bounds
    # (uses the cliques merge_cliques just built)
    out = amo_aware_linear_tightening(out)
    if out is None:
        return None
    out = merge_parallel_linear(out)
    if out is None:
        return None
    if len(out.variables) * max(1, len(out.constraints)) <= 2_000_000:
        out = probe_binaries(out)
        if out is None:
            return None
    # Wave 3: symmetry breaking (reference DetectAndAddSymmetryToProto,
    # cp_model_solver.cc:4511).  Lex-leader inequalities prune solutions,
    # so enumeration and hinted models skip it (a hint need not be the
    # lex-least orbit representative).
    if not preserve_all_solutions and not out.solution_hint \
            and len(out.variables) <= 2000:
        from ortools_tpu_torch.sat.symmetry_breaking import add_symmetry_breaking

        out = add_symmetry_breaking(out)
    return out


def _expr_fixed(e: ir.LinearExprIR, doms) -> Optional[int]:
    """Value of the expression when every variable in it is fixed."""
    total = e.offset
    for v, c in zip(e.vars, e.coeffs):
        if not doms[v].is_fixed():
            return None
        total += c * doms[v].fixed_value()
    return total


def _linear_eq(lhs_terms, rhs: int) -> ir.ConstraintIR:
    """Build `sum terms == rhs` with merged duplicate variables."""
    merged: Dict[int, int] = {}
    for v, c in lhs_terms:
        merged[v] = merged.get(v, 0) + c
    vs = [v for v, c in merged.items() if c != 0]
    cs = [merged[v] for v in vs]
    return ir.ConstraintIR("linear", ir.LinearArgs(
        vs, cs, Domain(rhs, rhs)))


def _rewrite_prod_div(ct: ir.ConstraintIR, doms
                      ) -> Optional[ir.ConstraintIR]:
    """Affine rewrites of int_prod / int_div (see call site)."""
    a = ct.args
    if ct.kind == "int_prod":
        k = 1
        free = None
        for e in a.exprs:
            val = _expr_fixed(e, doms)
            if val is None:
                if free is not None:
                    return None  # two+ free factors: truly nonlinear
                free = e
            else:
                k *= val
        t = a.target
        if free is None:
            # fully constant product: target == k
            return _linear_eq(list(zip(t.vars, t.coeffs)), k - t.offset)
        # target == k * free
        terms = [(v, c * k) for v, c in zip(free.vars, free.coeffs)]
        terms += [(v, -c) for v, c in zip(t.vars, t.coeffs)]
        return _linear_eq(terms, t.offset - k * free.offset)
    # int_div: target == num / den, truncated toward zero
    den = _expr_fixed(a.den, doms)
    if den is None or den <= 0:
        return None
    num = a.num
    n_lo = num.offset + sum(
        min(c * doms[v].min(), c * doms[v].max())
        for v, c in zip(num.vars, num.coeffs))
    n_hi = num.offset + sum(
        max(c * doms[v].min(), c * doms[v].max())
        for v, c in zip(num.vars, num.coeffs))
    t = a.target
    # truncation toward zero == floor only on a sign-definite numerator
    if n_lo >= 0:
        lo_r, hi_r = 0, den - 1
    elif n_hi <= 0:
        lo_r, hi_r = -(den - 1), 0
    else:
        return None
    # num - den*target in [lo_r, hi_r]
    merged: Dict[int, int] = {}
    for v, c in zip(num.vars, num.coeffs):
        merged[v] = merged.get(v, 0) + c
    for v, c in zip(t.vars, t.coeffs):
        merged[v] = merged.get(v, 0) - den * c
    vs = [v for v, c in merged.items() if c != 0]
    cs = [merged[v] for v in vs]
    const = num.offset - den * t.offset
    return ir.ConstraintIR("linear", ir.LinearArgs(
        vs, cs, Domain(lo_r - const, hi_r - const)))


def amo_aware_linear_tightening(model: ir.CpModelIR
                                ) -> Optional[ir.CpModelIR]:
    """DetectAndProcessAtMostOneInLinear (reference
    cp_model_presolve.cc): activity bounds of linear rows over binaries
    computed CLIQUE-AWARE — variables covered by one at_most_one
    contribute max-of-positive (at most one fires), not sum-of-positive.
    Rows whose clique-aware activity range fits inside their domain are
    entailed and dropped; rows proving a binary forced fix it (emitted
    as unit bool_or facts).  Returns None on proven infeasibility."""
    n = len(model.variables)
    is_bin = [v.domain.min() >= 0 and v.domain.max() <= 1
              for v in model.variables]
    # var -> clique id over POSITIVE binary literals
    clique_of: Dict[int, int] = {}
    n_cliques = 0
    for ct in model.constraints:
        if ct.kind not in ("at_most_one", "exactly_one") \
                or ct.enforcement_literals:
            continue
        members = [l for l in ct.args.literals if l >= 0]
        members = [v for v in members if v < n and is_bin[v]
                   and v not in clique_of]
        if len(members) >= 2:
            for v in members:
                clique_of[v] = n_cliques
            n_cliques += 1
    if not n_cliques:
        return model
    kept: List[ir.ConstraintIR] = []
    new_units: List[ir.ConstraintIR] = []
    changed = False
    for ct in model.constraints:
        if ct.kind != "linear" or ct.enforcement_literals:
            kept.append(ct)
            continue
        a = ct.args
        if not all(v < n and is_bin[v] for v in a.vars) \
                or len(set(a.vars)) != len(a.vars):
            kept.append(ct)
            continue
        # clique-aware activity bounds
        by_clique: Dict[int, List[int]] = {}
        lone_max = 0
        lone_min = 0
        for v, c in zip(a.vars, a.coeffs):
            q = clique_of.get(v)
            if q is None:
                lone_max += max(c, 0)
                lone_min += min(c, 0)
            else:
                by_clique.setdefault(q, []).append(c)
        act_max = lone_max + sum(max(0, max(cs)) for cs in
                                 by_clique.values())
        act_min = lone_min + sum(min(0, min(cs)) for cs in
                                 by_clique.values())
        lo, hi = a.domain.min(), a.domain.max()
        if act_min > hi or act_max < lo:
            return None  # clique-aware bounds prove infeasibility
        if (a.domain.num_intervals() == 1 and act_min >= lo
                and act_max <= hi):
            changed = True
            continue  # entailed: every clique-consistent point satisfies
        # forcing: x_j = 0 makes act_max' < lo  ->  x_j must be 1
        for v, c in zip(a.vars, a.coeffs):
            if c <= 0:
                continue
            q = clique_of.get(v)
            if q is None:
                without = act_max - c
            else:
                cs = by_clique[q]
                others = [x for x in cs]
                others.remove(c)
                without = (act_max - max(0, max(cs))
                           + (max(0, max(others)) if others else 0))
            if without < lo:
                new_units.append(ir.ConstraintIR(
                    "bool_or", ir.BoolArgs([v])))
                changed = True
        kept.append(ct)
    if not changed:
        return model
    return dataclasses.replace(model, constraints=kept + new_units)


def binary_dominance(model: ir.CpModelIR,
                     max_bins: int = 400) -> ir.CpModelIR:
    """General variable domination over binaries (reference
    var_domination.h:36 beyond the DualBoundStrengthening core): x
    dominates y when swapping a 1 from y to x never hurts — per <=-row
    coef(x) <= coef(y), per >=-row coef(x) >= coef(y) (two-sided rows
    need equality), positive clause membership of y implies x's, and
    the minimization objective prefers x.  Then some optimum satisfies
    (~y or x), added as a clause.  Solution-pruning: callers gate off
    for enumeration.  Ties break by index so symmetric pairs produce a
    lex order, not a contradiction."""
    n = len(model.variables)
    is_bin = np.array([v.domain.min() >= 0 and v.domain.max() <= 1
                       and not v.domain.is_fixed()
                       for v in model.variables])
    bins = np.nonzero(is_bin)[0]
    if len(bins) < 2 or len(bins) > max_bins:
        return model
    # column signatures: var -> {row_id: (lo_coef_rule, hi_coef_rule)}
    # plus the set of positive clauses containing it; any unsupported
    # appearance disqualifies the variable
    ok = {int(v): True for v in bins}
    col: Dict[int, Dict[int, int]] = {int(v): {} for v in bins}
    row_kind: Dict[int, Tuple[bool, bool]] = {}  # row -> (has_lo, has_hi)
    clauses_of: Dict[int, set] = {int(v): set() for v in bins}
    for ci, ct in enumerate(model.constraints):
        if ct.enforcement_literals:
            # enforcement literal vars control whether the row exists at
            # all — flipping them is never a plain coefficient swap
            for l in ct.enforcement_literals:
                v = ir.literal_index(l)
                if v in ok:
                    ok[v] = False
            for v in _ct_vars(model, ct):
                if v in ok:
                    ok[v] = False
            continue
        if ct.kind == "linear":
            a = ct.args
            lo, hi = a.domain.min(), a.domain.max()
            row_kind[ci] = (lo > -(2**50), hi < 2**50)
            for v, c in zip(a.vars, a.coeffs):
                if v in ok:
                    if v in col and ci in col[v]:
                        ok[v] = False  # duplicate terms: bail
                    else:
                        col[v][ci] = int(c)
        elif ct.kind == "bool_or":
            lits = list(ct.args.literals)
            if all(l >= 0 for l in lits):
                for l in lits:
                    if l in ok:
                        clauses_of[l].add(ci)
            else:
                for l in lits:
                    v = ir.literal_index(l)
                    if v in ok:
                        ok[v] = False
        elif ct.kind in ("at_most_one", "exactly_one"):
            # at_most_one behaves like a <=1 row over positive literals
            lits = list(ct.args.literals)
            if all(l >= 0 for l in lits):
                row_kind[-ci - 1] = (ct.kind == "exactly_one", True)
                for l in lits:
                    if l in ok:
                        col[l][-ci - 1] = 1
            else:
                for l in lits:
                    v = ir.literal_index(l)
                    if v in ok:
                        ok[v] = False
        else:
            for v in _ct_vars(model, ct):
                if v in ok:
                    ok[v] = False
    cand = [v for v in bins if ok[int(v)]]
    if len(cand) < 2:
        return model
    obj = model.objective
    oc = np.zeros(n)
    if obj is not None:
        sense = -1 if obj.maximize else 1
        for v, c in zip(obj.vars, obj.coeffs):
            oc[v] += sense * c

    def dominates(x: int, y: int) -> bool:
        if oc[x] > oc[y]:
            return False
        if not clauses_of[y] <= clauses_of[x]:
            return False
        rows = set(col[x]) | set(col[y])
        for r in rows:
            has_lo, has_hi = row_kind[r]
            cx = col[x].get(r, 0)
            cy = col[y].get(r, 0)
            if has_lo and has_hi and cx != cy:
                return False
            if has_hi and not has_lo and cx > cy:
                return False
            if has_lo and not has_hi and cx < cy:
                return False
        return True

    new_cts: List[ir.ConstraintIR] = []
    for i, x in enumerate(cand):
        for y in cand[i + 1:]:
            dx = dominates(int(x), int(y))
            dy = dominates(int(y), int(x))
            if dx and dy:
                # symmetric: lex order (smaller index at least as large)
                new_cts.append(ir.ConstraintIR(
                    "bool_or", ir.BoolArgs(
                        [ir.negated_literal(int(y)), int(x)])))
            elif dx:
                new_cts.append(ir.ConstraintIR(
                    "bool_or", ir.BoolArgs(
                        [ir.negated_literal(int(y)), int(x)])))
            elif dy:
                new_cts.append(ir.ConstraintIR(
                    "bool_or", ir.BoolArgs(
                        [ir.negated_literal(int(x)), int(y)])))
    if not new_cts:
        return model
    return dataclasses.replace(
        model, constraints=list(model.constraints) + new_cts)


def merge_parallel_linear(model: ir.CpModelIR
                          ) -> Optional[ir.CpModelIR]:
    """Dominated/duplicate linear rows (reference
    DetectDominatedLinearConstraints / DetectDuplicateConstraints,
    cp_model_presolve.cc): unenforced linear rows over the same terms —
    up to a sign flip — have their domains intersected into one row.
    Returns None when an intersection is empty (root infeasibility)."""
    has_sched = any(ct.kind in ("no_overlap", "cumulative",
                                "no_overlap_2d")
                    for ct in model.constraints)
    if has_sched:
        return model  # interval positions must stay stable
    groups = {}  # key -> constraint index holding the merged row
    kept: List[ir.ConstraintIR] = []
    changed = False
    for ct in model.constraints:
        if ct.kind != "linear" or ct.enforcement_literals:
            kept.append(ct)
            continue
        a = ct.args
        terms = sorted(zip(a.vars, a.coeffs))
        if not terms:
            kept.append(ct)
            continue
        vs = tuple(v for v, _ in terms)
        cs = tuple(c for _, c in terms)
        dom = a.domain
        if cs[0] < 0:  # canonical sign: leading coefficient positive
            cs = tuple(-c for c in cs)
            dom = dom.negation()
        key = (vs, cs)
        if key in groups:
            k = groups[key]
            merged = kept[k].args.domain.intersection_with(dom)
            if merged.is_empty():
                return None
            kept[k] = dataclasses.replace(
                kept[k],
                args=ir.LinearArgs(list(vs), list(cs), merged))
            changed = True
        else:
            groups[key] = len(kept)
            kept.append(dataclasses.replace(
                ct, args=ir.LinearArgs(list(vs), list(cs), dom)))
    if not changed:
        return model
    return dataclasses.replace(model, constraints=kept)


def _entailed(ct: ir.ConstraintIR, doms) -> bool:
    """Cheap entailment checks: constraint satisfied for ALL assignments
    within current domains."""
    a = ct.args
    k = ct.kind
    if k == "linear" and not ct.enforcement_literals:
        lo = hi = 0
        for v, c in zip(a.vars, a.coeffs):
            d = doms[v]
            t1, t2 = c * d.min(), c * d.max()
            lo += min(t1, t2)
            hi += max(t1, t2)
        hull = Domain(lo, hi)
        # entailed iff the full hull fits into one interval of the rhs
        for ilo, ihi in a.domain.intervals():
            if ilo <= lo and hi <= ihi:
                return True
        return False
    if k == "bool_or":
        return any(
            doms[ir.literal_index(l)].is_fixed()
            and bool(doms[ir.literal_index(l)].fixed_value()) == (l >= 0)
            for l in a.literals
        )
    if k == "at_most_one":
        unfixed_or_true = 0
        for l in a.literals:
            d = doms[ir.literal_index(l)]
            if d.is_fixed():
                if bool(d.fixed_value()) == (l >= 0):
                    unfixed_or_true += 1
            else:
                unfixed_or_true += 1
        return unfixed_or_true <= 1
    return False


def _constraint_key(ct: ir.ConstraintIR, enf: List[int]):
    a = ct.args
    if ct.kind in ("bool_or", "bool_and", "at_most_one", "exactly_one",
                   "bool_xor"):
        body = tuple(sorted(a.literals))
    elif ct.kind == "linear":
        body = (tuple(a.vars), tuple(a.coeffs),
                tuple(a.domain.flattened_intervals()))
    else:
        return id(ct)  # only cheap kinds are deduplicated
    return (ct.kind, body, tuple(sorted(enf)))


def _diophantine_reduce(ct: ir.ConstraintIR,
                        enf: List[int]) -> Optional[ir.ConstraintIR]:
    """GCD reduction of a linear constraint (reference
    ortools/sat/diophantine.{h,cc} scoped to its divisibility core):
    with g = gcd(coeffs) > 1, sum c_i x_i in D  <=>  sum (c_i/g) x_i in
    {t : g*t in D}.  Returns None when the reduced rhs domain is empty
    (the body is unsatisfiable for any assignment); otherwise the
    (possibly rewritten) constraint."""
    import math as _math

    a = ct.args
    live_vars, live_coeffs = [], []
    for v, c in zip(a.vars, a.coeffs):
        if c != 0:
            live_vars.append(v)
            live_coeffs.append(c)
    if not live_coeffs:
        return ct if a.domain.contains(0) else None
    g = 0
    for c in live_coeffs:
        g = _math.gcd(g, abs(c))
        if g == 1:
            return ct if len(live_vars) == len(a.vars) else \
                dataclasses.replace(ct, args=ir.LinearArgs(
                    live_vars, live_coeffs, a.domain),
                    enforcement_literals=enf)
    new_dom = a.domain.inverse_multiplication_by(g)
    if new_dom.is_empty():
        return None
    return dataclasses.replace(ct, args=ir.LinearArgs(
        live_vars, [c // g for c in live_coeffs], new_dom),
        enforcement_literals=enf)


def pure_literal_fixing(model: ir.CpModelIR) -> ir.CpModelIR:
    """Dual fixing for boolean variables (the sound core of the
    reference's var_domination.cc / SAT pure-literal rule): a boolean
    whose every occurrence is a POSITIVE literal in non-enforced
    bool_or constraints — and that appears nowhere else (no other
    constraint kind, no enforcement list, not in the objective) — can be
    fixed TRUE without losing any satisfying assignment's feasibility
    status (flipping it true only helps those clauses).  Mirrored for
    all-negative occurrences."""
    n = len(model.variables)
    pos_only = [True] * n
    neg_only = [True] * n
    boolean = [v.domain.min() >= 0 and v.domain.max() <= 1
               and not v.domain.is_fixed() for v in model.variables]
    seen = [False] * n
    obj = model.objective
    if obj is not None:
        for v in obj.vars:
            pos_only[v] = neg_only[v] = False
    for lit in getattr(model, "assumptions", ()) or ():
        v = ir.literal_index(lit)
        pos_only[v] = neg_only[v] = False
    for item in (getattr(model, "solution_hint", ()) or ()):
        v = item[0] if isinstance(item, (tuple, list)) else item
        if isinstance(v, int) and 0 <= v < n:
            pos_only[v] = neg_only[v] = False
    for ct in model.constraints:
        lits = ct.args.literals if ct.kind == "bool_or" else None
        in_enf = set(ir.literal_index(l) for l in ct.enforcement_literals)
        for v in in_enf:
            pos_only[v] = neg_only[v] = False
        if lits is not None and not ct.enforcement_literals:
            for l in lits:
                v = ir.literal_index(l)
                seen[v] = True
                if l >= 0:
                    neg_only[v] = False
                else:
                    pos_only[v] = False
        else:
            # any appearance in a non-clause constraint disqualifies
            # (conservative: extra indices only lose fixing chances)
            for v in _ct_vars(model, ct):
                if 0 <= v < n:
                    pos_only[v] = neg_only[v] = False
    fixes = {}
    for v in range(n):
        if not boolean[v] or not seen[v]:
            continue
        if pos_only[v]:
            fixes[v] = 1
        elif neg_only[v]:
            fixes[v] = 0
    if not fixes:
        return model
    new_vars = [
        ir.IntegerVariableIR(var.name, Domain(fixes[i], fixes[i]))
        if i in fixes else var
        for i, var in enumerate(model.variables)
    ]
    return dataclasses.replace(model, variables=new_vars)


def _ct_vars(model: ir.CpModelIR, ct: ir.ConstraintIR) -> List[int]:
    """All variable indices referenced by a constraint (conservative)."""
    out: List[int] = []
    a = ct.args
    k = ct.kind
    if k in ("bool_or", "bool_and", "at_most_one", "exactly_one",
             "bool_xor"):
        out += [ir.literal_index(l) for l in a.literals]
    elif k == "linear":
        out += list(a.vars)
    elif k == "interval":
        out += a.start.vars + a.size.vars + a.end.vars
    elif k in ("no_overlap", "no_overlap_2d", "cumulative"):
        kks = (list(a.intervals) if k != "no_overlap_2d"
               else list(a.x_intervals) + list(a.y_intervals))
        for kk in kks:
            out += _ct_vars(model, model.constraints[kk])
        if k == "cumulative":
            out += a.capacity.vars
            for e in a.demands:
                out += e.vars
    else:
        # unknown kinds: collect every LinearExprIR / literal field
        for field in vars(a).values():
            if isinstance(field, ir.LinearExprIR):
                out += field.vars
            elif isinstance(field, (list, tuple)):
                for item in field:
                    if isinstance(item, ir.LinearExprIR):
                        out += item.vars
                    elif isinstance(item, int):
                        out.append(ir.literal_index(item))
    return out


def setppc_dominance(model: ir.CpModelIR) -> ir.CpModelIR:
    """Inclusion dominance between set-packing/covering constraints
    (reference CpModelPresolver::ProcessSetPPC):

    - a bool_or over S2 is implied by any clause-like source over S1 with
      S1 subset of S2 (another bool_or or an exactly_one) -> dropped;
    - an at_most_one over S2 is implied by any packing source over S1
      with S2 subset of S1 (another at_most_one or an exactly_one)
      -> dropped.

    exactly_one constraints act as sources only (they are strictly
    stronger and never dropped here)."""
    clause_sources: List[tuple] = []  # (frozenset, ct index or -1)
    amo_sources: List[tuple] = []
    clause_targets: List[int] = []
    amo_targets: List[int] = []
    for ci, ct in enumerate(model.constraints):
        if ct.enforcement_literals:
            continue
        if ct.kind == "bool_or" and ct.args.literals:
            s = frozenset(ct.args.literals)
            clause_sources.append((s, ci))
            clause_targets.append(ci)
        elif ct.kind == "at_most_one" and ct.args.literals:
            s = frozenset(ct.args.literals)
            amo_sources.append((s, ci))
            amo_targets.append(ci)
        elif ct.kind == "exactly_one" and ct.args.literals:
            s = frozenset(ct.args.literals)
            clause_sources.append((s, ci))
            amo_sources.append((s, ci))
    if (not clause_targets and not amo_targets) or \
            len(model.constraints) > 200_000:
        return model
    drop = set()
    # smallest sources first so the strongest dominator is tried early
    clause_sources.sort(key=lambda t: len(t[0]))
    amo_sources.sort(key=lambda t: -len(t[0]))
    for ci in clause_targets:
        s2 = frozenset(model.constraints[ci].args.literals)
        for s1, src in clause_sources:
            if len(s1) >= len(s2):
                break
            if src != ci and src not in drop and s1 < s2:
                drop.add(ci)
                break
    for ci in amo_targets:
        s2 = frozenset(model.constraints[ci].args.literals)
        for s1, src in amo_sources:
            if len(s1) <= len(s2):
                break
            if src != ci and src not in drop and s2 < s1:
                drop.add(ci)
                break
    if not drop:
        return model
    # keep interval positions stable for scheduling models (same contract
    # as merge_cliques)
    has_sched = any(ct.kind in ("no_overlap", "cumulative", "no_overlap_2d")
                    for ct in model.constraints)
    if has_sched:
        kept = [ct if ci not in drop
                else ir.ConstraintIR("at_most_one", ir.BoolArgs([]))
                for ci, ct in enumerate(model.constraints)]
    else:
        kept = [ct for ci, ct in enumerate(model.constraints)
                if ci not in drop]
    return dataclasses.replace(model, constraints=kept)


# ---------------------------------------------------------------------------
# Probing (reference ortools/sat/probing.h) and clique merging (reference
# CpModelPresolver::TransformIntoMaxCliques, cp_model_presolve.cc)
# ---------------------------------------------------------------------------


def probe_binaries(model: ir.CpModelIR, max_probes: int = 128
                   ) -> Optional[ir.CpModelIR]:
    """Probe boolean variables: propagate both b=0 and b=1 at the root.

    - one branch conflicts  -> fix b to the other value;
    - both branches conflict -> model infeasible (returns None);
    - otherwise intersect the two branch domains (singleton-style shaving)
      and keep any reduction valid in both worlds.

    Reference: ortools/sat/probing.h FailedLiteralProbing; recast as two
    whole-model propagation fixed points per probed binary.
    """
    engine = Engine(model)
    base = engine.initial_domains()
    if not engine.root_propagate(base):
        return None
    booleans = [
        i for i, v in enumerate(model.variables)
        if base[i].min() >= 0 and base[i].max() <= 1
        and not base[i].is_fixed()
    ][:max_probes]
    changed = False
    for b in booleans:
        if base[b].is_fixed():
            continue
        branches = []
        for val in (0, 1):
            doms = list(base)
            doms[b] = Domain(val, val)
            queue = set(engine.watchers[b])
            try:
                engine.propagate(doms, queue)
                branches.append(doms)
            except Conflict:
                branches.append(None)
        d0, d1 = branches
        if d0 is None and d1 is None:
            return None
        if d0 is None or d1 is None:
            base = d1 if d0 is None else d0
            changed = True
            continue
        # both worlds feasible: keep intersected (union of values) hulls
        for i in range(len(base)):
            lo = min(d0[i].min(), d1[i].min())
            hi = max(d0[i].max(), d1[i].max())
            if lo > base[i].min() or hi < base[i].max():
                base[i] = base[i].intersection_with(Domain(lo, hi))
                changed = True
    if not changed:
        return model
    new_vars = [
        ir.IntegerVariableIR(v.name, base[i])
        for i, v in enumerate(model.variables)
    ]
    return dataclasses.replace(model, variables=new_vars)


def _amo_edges(model: ir.CpModelIR):
    """Collect mutual-exclusion edges between literals and the constraint
    indices they come from (at_most_one pairs; bool_or of two literals
    gives at_most_one of their negations)."""
    edges = {}  # (lit_a, lit_b) sorted -> list of ct indices
    covered = set()
    for ci, ct in enumerate(model.constraints):
        if ct.enforcement_literals:
            continue
        if ct.kind == "at_most_one":
            lits = list(ct.args.literals)
            covered.add(ci)
            for i in range(len(lits)):
                for j in range(i + 1, len(lits)):
                    k = tuple(sorted((lits[i], lits[j])))
                    edges.setdefault(k, []).append(ci)
        elif ct.kind == "bool_or" and len(ct.args.literals) == 2:
            a, b = ct.args.literals
            na, nb = ir.negated_literal(a), ir.negated_literal(b)
            k = tuple(sorted((na, nb)))
            edges.setdefault(k, []).append(ci)
            covered.add(ci)
    return edges, covered


def merge_cliques(model: ir.CpModelIR) -> ir.CpModelIR:
    """Greedy max-clique merging of at_most_one structure (reference
    TransformIntoMaxCliques): pairwise exclusions are grown into maximal
    cliques, each emitted as ONE at_most_one; covered binary clauses and
    smaller at_most_ones are dropped."""
    edges, covered = _amo_edges(model)
    if not edges:
        return model
    adj = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    # Greedy clique cover of the edge set, largest-degree seeds first;
    # only cliques of size >= 3 are worth emitting (pairs stay as-is).
    remaining = set(edges.keys())
    cliques = []
    for a in sorted(adj, key=lambda x: -len(adj[x])):
        for b in sorted(adj[a]):
            if tuple(sorted((a, b))) not in remaining:
                continue
            clique = {a, b}
            cand = adj[a] & adj[b]
            for c in sorted(cand, key=lambda x: -len(adj[x])):
                if all(c in adj[m] for m in clique):
                    clique.add(c)
            if len(clique) < 3:
                continue
            for x in clique:
                for y in clique:
                    if x < y:
                        remaining.discard((x, y))
            cliques.append(sorted(clique))
    if not cliques:
        return model
    # a source constraint is dropped only when one emitted clique subsumes
    # its entire exclusion structure
    clique_sets = [set(c) for c in cliques]
    subsumed = set()
    for ci in covered:
        ct = model.constraints[ci]
        if ct.kind == "at_most_one":
            lits = set(ct.args.literals)
        else:  # bool_or pair -> exclusion between the negations
            lits = {ir.negated_literal(l) for l in ct.args.literals}
        if any(lits <= cs for cs in clique_sets):
            subsumed.add(ci)
    covered = subsumed
    # Scheduling constraints reference interval POSITIONS, so when any are
    # present, covered constraints are replaced in place by a trivially
    # true at_most_one([]) instead of being dropped (keeps indices stable).
    has_sched = any(ct.kind in ("no_overlap", "cumulative", "no_overlap_2d")
                    for ct in model.constraints)
    if has_sched:
        kept = [
            ct if ci not in covered
            else ir.ConstraintIR("at_most_one", ir.BoolArgs([]))
            for ci, ct in enumerate(model.constraints)
        ]
    else:
        kept = [ct for ci, ct in enumerate(model.constraints)
                if ci not in covered]
    for clique in cliques:
        kept.append(ir.ConstraintIR("at_most_one", ir.BoolArgs(
            list(clique))))
    return dataclasses.replace(model, constraints=kept)


_BIG_DOM = 2**50


def dual_bound_fixing(model: ir.CpModelIR) -> ir.CpModelIR:
    """Integer dual fixing (the DualBoundStrengthening core of the
    reference's ``sat/var_domination.cc``): a variable whose every linear
    occurrence is direction-safe — raising it can only RELAX each row
    (positive coefficient with no row upper bound, negative with no row
    lower bound) — and whose objective coefficient does not oppose the
    move, can be fixed at its bound without changing the optimal value.
    Mirrored for the downward direction.  Optimality-preserving only, so
    the caller gates it off for solution enumeration (like
    pure_literal_fixing)."""
    n = len(model.variables)
    up_safe = [True] * n
    dn_safe = [True] * n
    seen = [False] * n
    obj = model.objective
    sense = -1 if (obj is not None and obj.maximize) else 1
    ocoef: dict = {}
    if obj is not None:
        for v, c in zip(obj.vars, obj.coeffs):
            ocoef[v] = ocoef.get(v, 0) + sense * c
        for v, c in ocoef.items():
            if c > 0:
                up_safe[v] = False
            if c < 0:
                dn_safe[v] = False
            seen[v] = True
    for lit in getattr(model, "assumptions", ()) or ():
        v = ir.literal_index(lit)
        up_safe[v] = dn_safe[v] = False
    for item in (getattr(model, "solution_hint", ()) or ()):
        v = item[0] if isinstance(item, (tuple, list)) else item
        if isinstance(v, int) and 0 <= v < n:
            up_safe[v] = dn_safe[v] = False
    for ds in getattr(model, "search_strategies", ()) or ():
        for v in getattr(ds, "variables", ()):
            if isinstance(v, int) and 0 <= v < n:
                up_safe[v] = dn_safe[v] = False
    for ct in model.constraints:
        for l in ct.enforcement_literals:
            v = ir.literal_index(l)
            up_safe[v] = dn_safe[v] = False
        if ct.kind == "linear":
            dom = ct.args.domain
            single = dom.num_intervals() == 1
            no_ub = single and dom.max() >= _BIG_DOM
            no_lb = single and dom.min() <= -_BIG_DOM
            for v, c in zip(ct.args.vars, ct.args.coeffs):
                seen[v] = True
                if c > 0:
                    if not no_ub:
                        up_safe[v] = False
                    if not no_lb:
                        dn_safe[v] = False
                elif c < 0:
                    if not no_lb:
                        up_safe[v] = False
                    if not no_ub:
                        dn_safe[v] = False
        else:
            for v in _ct_vars(model, ct):
                if 0 <= v < n:
                    up_safe[v] = dn_safe[v] = False
    fixes = {}
    for v in range(n):
        d = model.variables[v].domain
        if d.is_fixed() or not seen[v]:
            continue
        if abs(d.min()) > _BIG_DOM or abs(d.max()) > _BIG_DOM:
            continue
        if up_safe[v]:
            fixes[v] = int(d.max())
        elif dn_safe[v]:
            fixes[v] = int(d.min())
    if not fixes:
        return model
    new_vars = [
        ir.IntegerVariableIR(var.name, Domain(fixes[i], fixes[i]))
        if i in fixes else var
        for i, var in enumerate(model.variables)
    ]
    return dataclasses.replace(model, variables=new_vars)
