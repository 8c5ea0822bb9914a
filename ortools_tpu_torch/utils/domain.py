"""Integer domains as sorted lists of closed intervals.

Capability parity: ``ortools/util/sorted_interval_list.h:82`` (Domain) — the
universal integer-domain representation used by every CP/SAT layer of the
reference.  Semantics reproduced:

- a domain is a minimal sorted list of disjoint, non-adjacent closed
  intervals ``[lo, hi]`` over int64;
- arithmetic saturates at ``INT_MIN/INT_MAX`` (see ``saturated.py``,
  parity with ``ortools/util/saturated_arithmetic.h``);
- set ops: complement, negation, intersection, union, addition/offset,
  multiplication by a constant, relational helpers.

This is a host-side (pure Python) structure; device code sees domains as
padded ``(lb, ub)`` int32/int64 bound arrays (one interval per variable) —
holes are handled by the propagation layer via encodings, mirroring how the
reference's IntegerTrail keeps only bounds hot and lazily encodes holes
(``ortools/sat/integer.h:453``).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

INT_MIN = -(2**63)
INT_MAX = 2**63 - 1


def _cap(v: int) -> int:
    return max(INT_MIN, min(INT_MAX, v))


def _cap_add(a: int, b: int) -> int:
    return _cap(a + b)


def _cap_mul(a: int, b: int) -> int:
    return _cap(a * b)


class Domain:
    """A set of int64 values stored as sorted disjoint closed intervals."""

    __slots__ = ("_intervals",)

    def __init__(self, lo: int | None = None, hi: int | None = None) -> None:
        if lo is None and hi is None:
            self._intervals: List[Tuple[int, int]] = []
        else:
            lo = INT_MIN if lo is None else int(lo)
            hi = INT_MAX if hi is None else int(hi)
            lo, hi = _cap(lo), _cap(hi)
            self._intervals = [(lo, hi)] if lo <= hi else []

    # ---- constructors -------------------------------------------------
    @staticmethod
    def all_values() -> "Domain":
        return Domain(INT_MIN, INT_MAX)

    @staticmethod
    def empty() -> "Domain":
        return Domain()

    @staticmethod
    def from_values(values: Iterable[int]) -> "Domain":
        vals = sorted(set(int(v) for v in values))
        intervals: List[Tuple[int, int]] = []
        for v in vals:
            if intervals and v == intervals[-1][1] + 1:
                intervals[-1] = (intervals[-1][0], v)
            else:
                intervals.append((v, v))
        return Domain._from_sorted(intervals)

    @staticmethod
    def from_intervals(intervals: Sequence[Sequence[int]]) -> "Domain":
        """Build from possibly-overlapping, unsorted [lo, hi] pairs."""
        d = Domain()
        parts = [Domain(lo, hi) for lo, hi in intervals]
        for p in parts:
            d = d.union_with(p)
        return d

    @staticmethod
    def from_flat_intervals(flat: Sequence[int]) -> "Domain":
        """Pairs flattened as [lo0, hi0, lo1, hi1, ...] (proto wire format
        used by the reference's cp_model.proto IntegerVariableProto)."""
        assert len(flat) % 2 == 0
        return Domain.from_intervals(
            [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
        )

    @staticmethod
    def _from_sorted(intervals: List[Tuple[int, int]]) -> "Domain":
        d = Domain()
        d._intervals = intervals
        return d

    # ---- queries ------------------------------------------------------
    def is_empty(self) -> bool:
        return not self._intervals

    def size(self) -> int:
        return sum(hi - lo + 1 for lo, hi in self._intervals)

    def min(self) -> int:
        if self.is_empty():
            raise ValueError("min() of empty Domain")
        return self._intervals[0][0]

    def max(self) -> int:
        if self.is_empty():
            raise ValueError("max() of empty Domain")
        return self._intervals[-1][1]

    def is_fixed(self) -> bool:
        return len(self._intervals) == 1 and (
            self._intervals[0][0] == self._intervals[0][1]
        )

    def fixed_value(self) -> int:
        assert self.is_fixed()
        return self._intervals[0][0]

    def contains(self, value: int) -> bool:
        import bisect

        i = bisect.bisect_right([lo for lo, _ in self._intervals], value)
        if i == 0:
            return False
        lo, hi = self._intervals[i - 1]
        return lo <= value <= hi

    def num_intervals(self) -> int:
        return len(self._intervals)

    def intervals(self) -> List[Tuple[int, int]]:
        return list(self._intervals)

    def flattened_intervals(self) -> List[int]:
        out: List[int] = []
        for lo, hi in self._intervals:
            out.extend((lo, hi))
        return out

    def __iter__(self):
        for lo, hi in self._intervals:
            yield from range(lo, hi + 1)

    # ---- set operations ----------------------------------------------
    def complement(self) -> "Domain":
        out: List[Tuple[int, int]] = []
        prev = INT_MIN
        for lo, hi in self._intervals:
            if lo > prev:
                out.append((prev, lo - 1))
            prev = hi + 1 if hi < INT_MAX else INT_MAX
            if hi == INT_MAX:
                return Domain._from_sorted(out)
        out.append((prev, INT_MAX))
        # The complement of the full domain is empty:
        if self._intervals and self._intervals[0] == (INT_MIN, INT_MAX):
            return Domain()
        return Domain._from_sorted(out)

    def negation(self) -> "Domain":
        out = [(_cap(-hi), _cap(-lo)) for lo, hi in reversed(self._intervals)]
        return Domain._from_sorted(out)

    def intersection_with(self, other: "Domain") -> "Domain":
        out: List[Tuple[int, int]] = []
        i = j = 0
        a, b = self._intervals, other._intervals
        while i < len(a) and j < len(b):
            lo = max(a[i][0], b[j][0])
            hi = min(a[i][1], b[j][1])
            if lo <= hi:
                out.append((lo, hi))
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
        return Domain._from_sorted(out)

    def union_with(self, other: "Domain") -> "Domain":
        merged = sorted(self._intervals + other._intervals)
        out: List[Tuple[int, int]] = []
        for lo, hi in merged:
            if out and lo <= _cap_add(out[-1][1], 1):
                out[-1] = (out[-1][0], max(out[-1][1], hi))
            else:
                out.append((lo, hi))
        return Domain._from_sorted(out)

    def addition_with(self, other: "Domain") -> "Domain":
        """Minkowski sum (exact; both operands must be small or intervals)."""
        out = Domain()
        for alo, ahi in self._intervals:
            for blo, bhi in other._intervals:
                out = out.union_with(Domain(_cap_add(alo, blo), _cap_add(ahi, bhi)))
        return out

    def offset(self, delta: int) -> "Domain":
        return Domain._from_sorted(
            [(_cap_add(lo, delta), _cap_add(hi, delta)) for lo, hi in self._intervals]
        )

    def multiplication_by(self, coeff: int) -> "Domain":
        """Superset-free exact multiplication {coeff * v : v in D} is only an
        interval union when |coeff| == 1; otherwise we return the exact set
        for small domains and the convex-ish interval scaling for large ones
        (matching the reference's ContinuousMultiplicationBy semantics for
        propagation use)."""
        if coeff == 0:
            return Domain(0, 0) if not self.is_empty() else Domain()
        if coeff == 1:
            return Domain._from_sorted(list(self._intervals))
        if coeff == -1:
            return self.negation()
        if self.size() <= 1024:
            return Domain.from_values(_cap_mul(v, coeff) for v in self)
        scaled = [
            (_cap_mul(lo, coeff), _cap_mul(hi, coeff)) for lo, hi in self._intervals
        ]
        if coeff < 0:
            scaled = [(hi, lo) for lo, hi in reversed(scaled)]
        return Domain.from_intervals(scaled)

    def continuous_multiplication_by(self, coeff: int) -> "Domain":
        """Smallest interval-union superset closed under division: scales each
        interval's endpoints (reference sorted_interval_list.h)."""
        if coeff == 0:
            return Domain(0, 0) if not self.is_empty() else Domain()
        scaled = [
            (_cap_mul(lo, coeff), _cap_mul(hi, coeff)) for lo, hi in self._intervals
        ]
        if coeff < 0:
            scaled = [(hi, lo) for lo, hi in reversed(scaled)]
        return Domain.from_intervals(scaled)

    def division_by(self, coeff: int) -> "Domain":
        """{v // coeff rounded toward zero : v in D} superset as intervals."""
        assert coeff != 0
        def div(v: int) -> int:
            q = abs(v) // abs(coeff)
            return q if (v >= 0) == (coeff > 0) else -q
        scaled = [(div(lo), div(hi)) for lo, hi in self._intervals]
        if coeff < 0:
            scaled = [(hi, lo) for lo, hi in reversed(scaled)]
        return Domain.from_intervals(scaled)

    def inverse_multiplication_by(self, coeff: int) -> "Domain":
        """{v : coeff * v in D} (exact)."""
        assert coeff != 0
        out: List[Tuple[int, int]] = []
        c = abs(coeff)
        for lo, hi in (self.negation() if coeff < 0 else self)._intervals:
            # smallest v with c*v >= lo  /  largest v with c*v <= hi
            nlo = -((-lo) // c) if lo <= 0 else (lo + c - 1) // c
            nhi = hi // c if hi >= 0 else -((-hi + c - 1) // c)
            if nlo <= nhi:
                out.append((nlo, nhi))
        return Domain.from_intervals(out)

    def relaxed(self) -> "Domain":
        """The convex hull [min, max]."""
        if self.is_empty():
            return Domain()
        return Domain(self.min(), self.max())

    def is_included_in(self, other: "Domain") -> bool:
        return self.intersection_with(other).size() == self.size() if \
            self._bounded() else self._subset_unbounded(other)

    def _bounded(self) -> bool:
        return not self._intervals or (
            self._intervals[0][0] > INT_MIN and self._intervals[-1][1] < INT_MAX
        )

    def _subset_unbounded(self, other: "Domain") -> bool:
        for lo, hi in self._intervals:
            covered = False
            for olo, ohi in other._intervals:
                if olo <= lo and hi <= ohi:
                    covered = True
                    break
            if not covered:
                return False
        return True

    # ---- dunder -------------------------------------------------------
    def __eq__(self, other: object) -> bool:
        return isinstance(other, Domain) and self._intervals == other._intervals

    def __hash__(self) -> int:
        return hash(tuple(self._intervals))

    def __repr__(self) -> str:
        parts = ",".join(
            f"[{lo},{hi}]" if lo != hi else f"[{lo}]" for lo, hi in self._intervals
        )
        return f"Domain({parts})"
