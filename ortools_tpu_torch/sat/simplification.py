"""SAT presolve: unit propagation, subsumption, bounded variable
elimination.

Capability parity: ``ortools/sat/simplification.{h,cc}`` (SatPresolver —
the SatSolver's preprocessing stack) scoped to its three core reductions:

- unit propagation to a fix point (failed literal => UNSAT);
- clause subsumption + self-subsuming resolution (strengthening);
- bounded variable elimination (BVE): eliminate v by resolution when the
  resolvent count does not exceed the removed-clause count, with the
  elimination stack replayed in reverse to reconstruct eliminated
  variables in any model (the reference's postsolve contract).

Used in front of the CDCL core for pure-SAT models (sat/pure_sat.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple


class SimplifiedCnf:
    def __init__(self, clauses: List[Tuple[int, ...]], num_vars: int,
                 fixed: Dict[int, bool],
                 eliminated: List[Tuple[int, List[Tuple[int, ...]]]]):
        self.clauses = clauses
        self.num_vars = num_vars
        self.fixed = fixed  # var -> value forced at the root
        # (literal eliminated, clauses it appeared in) in elimination order
        self.eliminated = eliminated
        self.unsat = False

    def reconstruct(self, model: List[int]) -> List[int]:
        """Extend a model of the simplified CNF to the original variables
        by replaying the elimination stack in reverse."""
        out = list(model)
        for v, val in self.fixed.items():
            out[v] = 1 if val else 0

        def lit_true(lit: int) -> bool:
            v = abs(lit) - 1
            return bool(out[v]) == (lit > 0)

        for lit, clauses in reversed(self.eliminated):
            v = abs(lit) - 1
            p, n = v + 1, -(v + 1)
            # v must be true iff some saved clause containing literal p is
            # not satisfied by its other literals (and symmetrically for
            # n); both cannot trigger at once, or a resolvent would be
            # falsified by the current model.
            need_true = any(
                p in c and not any(lit_true(x) for x in c
                                   if abs(x) - 1 != v)
                for c in clauses)
            need_false = any(
                n in c and not any(lit_true(x) for x in c
                                   if abs(x) - 1 != v)
                for c in clauses)
            if need_true:
                out[v] = 1
            elif need_false:
                out[v] = 0
        return out


def presolve_cnf(clauses: Sequence[Sequence[int]], num_vars: int,
                 max_bve_clauses: int = 16) -> SimplifiedCnf:
    """Simplify; result.unsat is True when the root is contradictory."""
    cls: List[Optional[Set[int]]] = []
    for c in clauses:
        s = set(int(x) for x in c)
        if any(-x in s for x in s):
            continue  # tautology
        cls.append(s)
    fixed: Dict[int, bool] = {}
    eliminated: List[Tuple[int, List[Tuple[int, ...]]]] = []

    def occurs() -> Dict[int, Set[int]]:
        occ: Dict[int, Set[int]] = {}
        for i, c in enumerate(cls):
            if c is None:
                continue
            for lit in c:
                occ.setdefault(lit, set()).add(i)
        return occ

    out = SimplifiedCnf([], num_vars, fixed, eliminated)

    changed = True
    while changed:
        changed = False
        occ = occurs()
        # ---- unit propagation ------------------------------------------
        units = [next(iter(c)) for c in cls if c is not None and len(c) == 1]
        for u in units:
            v = abs(u) - 1
            if v in fixed and fixed[v] != (u > 0):
                out.unsat = True
                return out
            if v in fixed:
                continue
            fixed[v] = u > 0
            changed = True
            for i in list(occ.get(u, ())):
                cls[i] = None  # satisfied
            for i in list(occ.get(-u, ())):
                c = cls[i]
                if c is None:
                    continue
                c.discard(-u)
                if not c:
                    out.unsat = True
                    return out
            occ = occurs()
        # ---- subsumption + self-subsuming resolution --------------------
        sigs = {}
        for i, c in enumerate(cls):
            if c is None:
                continue
            sigs[i] = frozenset(c)
        by_size = sorted(sigs, key=lambda i: len(sigs[i]))
        for i in by_size:
            ci = cls[i]
            if ci is None:
                continue
            # candidates sharing the rarest literal
            rare = min(ci, key=lambda l: len(occ.get(l, ())))
            for j in list(occ.get(rare, ())):
                if j == i or cls[j] is None:
                    continue
                cj = cls[j]
                if ci <= cj:
                    cls[j] = None  # subsumed
                    changed = True
            # self-subsuming resolution: ci \ {l} ∪ {-l} ⊆ cj => drop -l
            for lit in list(ci):
                rest = ci - {lit}
                for j in list(occ.get(-lit, ())):
                    cj = cls[j]
                    if cj is None or j == i:
                        continue
                    if rest <= (cj - {-lit}):
                        cj.discard(-lit)
                        changed = True
                        if not cj:
                            out.unsat = True
                            return out
            if changed:
                occ = occurs()
        # ---- bounded variable elimination -------------------------------
        for v in range(num_vars):
            if v in fixed:
                continue
            p, n = v + 1, -(v + 1)
            pos = [i for i in occ.get(p, ()) if cls[i] is not None]
            neg = [i for i in occ.get(n, ()) if cls[i] is not None]
            if not pos and not neg:
                continue
            if len(pos) + len(neg) > max_bve_clauses:
                continue
            resolvents: List[Set[int]] = []
            ok = True
            for i in pos:
                for j in neg:
                    r = (cls[i] - {p}) | (cls[j] - {n})
                    if any(-x in r for x in r):
                        continue  # tautology
                    resolvents.append(r)
                    if len(resolvents) > len(pos) + len(neg):
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                continue
            saved = [tuple(cls[i]) for i in pos + neg]
            lit_kept = p if pos else n
            eliminated.append((lit_kept, saved))
            for i in pos + neg:
                cls[i] = None
            for r in resolvents:
                cls.append(set(r))
            changed = True
            occ = occurs()

    out.clauses = [tuple(sorted(c)) for c in cls if c is not None]
    return out
