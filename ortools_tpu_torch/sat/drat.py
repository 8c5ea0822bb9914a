"""DRAT proof checking (RUP verification by unit propagation).

Capability parity: ``ortools/sat/drat_checker.{h,cc}`` — verify that every
clause added by a DRAT proof is a reverse-unit-propagation (RUP)
consequence of the original formula plus the not-yet-deleted earlier
additions, and that the proof derives the empty clause for UNSAT claims.
Host-side pure-Python checker (proofs are checked offline, not in the
solve hot path), counter-based unit propagation.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple


class _ClauseDb:
    """Clause set with unit propagation from scratch (checker-grade)."""

    def __init__(self) -> None:
        self.clauses: Dict[int, Tuple[int, ...]] = {}
        self._next = 0

    def add(self, lits: Sequence[int]) -> int:
        cid = self._next
        self._next += 1
        self.clauses[cid] = tuple(lits)
        return cid

    def delete(self, lits: Sequence[int]) -> bool:
        key = tuple(sorted(lits))
        for cid, c in self.clauses.items():
            if tuple(sorted(c)) == key:
                del self.clauses[cid]
                return True
        return False

    def propagates_to_conflict(self, assumed_false: Sequence[int]) -> bool:
        """Assert the negation of each literal in ``assumed_false`` and
        unit-propagate; True iff a conflict is reached (the clause is RUP).
        """
        assign: Dict[int, bool] = {}
        for lit in assumed_false:
            v, val = abs(lit), lit > 0
            if v in assign and assign[v] == val:
                return True  # clause is a tautology under the assumption
            assign[v] = not val
        changed = True
        while changed:
            changed = False
            for c in self.clauses.values():
                unassigned = None
                satisfied = False
                count = 0
                for lit in c:
                    v, pos = abs(lit), lit > 0
                    if v not in assign:
                        unassigned = lit
                        count += 1
                        if count > 1:
                            break
                    elif assign[v] == pos:
                        satisfied = True
                        break
                if satisfied or count > 1:
                    continue
                if count == 0:
                    return True  # conflict
                v, pos = abs(unassigned), unassigned > 0
                assign[v] = pos
                changed = True
        return False


def check_drat(formula: Iterable[Sequence[int]],
               proof: Iterable[Tuple[str, Sequence[int]]],
               require_empty: bool = True) -> bool:
    """Check a DRAT proof against ``formula`` (clauses of signed ints).

    ``proof`` events are ("a", lits) additions / ("d", lits) deletions.
    Returns True iff every addition is RUP at its point in the proof and
    (when ``require_empty``) the empty clause is derived.
    """
    db = _ClauseDb()
    for c in formula:
        db.add(c)
    derived_empty = False
    for kind, lits in proof:
        if kind == "d":
            db.delete(lits)
            continue
        if not db.propagates_to_conflict(lits):
            return False
        if len(lits) == 0:
            derived_empty = True
            break
        db.add(lits)
    return derived_empty or not require_empty


def parse_drat(path: str) -> List[Tuple[str, List[int]]]:
    """Parse a textual DRAT file into proof events."""
    out: List[Tuple[str, List[int]]] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            kind = "a"
            if toks[0] == "d":
                kind = "d"
                toks = toks[1:]
            lits = [int(t) for t in toks]
            assert lits and lits[-1] == 0
            out.append((kind, lits[:-1]))
    return out
