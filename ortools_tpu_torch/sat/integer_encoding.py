"""General integer CP models on the native CDCL core via order encoding.

Capability parity: the reference's integer-literal machinery — order
("IntegerEncoder::GetOrCreateAssociatedLiteral", ``ortools/sat/integer.h``)
and value encodings wired into clause learning via
``ortools/sat/cp_model_loader.cc`` — realized eagerly: a CpModelIR whose
variables have enumerable domains is compiled to CNF over order literals
``[x <= v]`` and solved by the native CDCL engine (_native/cdcl.cc).  The
reference generates these clauses lazily during search; an eager, budgeted
encoding reaches the same propagation strength on small/medium domains
while keeping the whole search inside the learning core.

Supported fragment (everything else falls back to the CP engine):
  bool_or / bool_and / at_most_one / exactly_one / bool_xor,
  linear (any coefficients, enforcement literals, multi-interval domains),
  all_diff / lin_max / element / table over affine single-variable
  expressions.

Linear constraints use a partial-sum ladder (the order-encoding addition
a + b = s with window clipping — the eager form of the reference's lazy
sum propagation): each prefix sum gets its own order ladder, clipped to
the window still reachable AND still feasible for the constraint domain;
staircase conflict clauses cut sums that leave the window.

Optimization runs the ft10-prover pattern (scheduling/jobshop.py): the
objective gets a ladder with NO domain restriction, and one incremental
solver instance answers ``objective <= B`` queries through assumptions —
learnt clauses persist across the whole binary descent (reference parity:
objective probing in cp_model_solver.cc).
"""

from __future__ import annotations

import math
import time
from bisect import bisect_left, bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain

TRUE_LIT = 1     # SAT var 1 is constrained true
FALSE_LIT = -1

_SUPPORTED = frozenset([
    "bool_or", "bool_and", "at_most_one", "exactly_one", "bool_xor",
    "linear", "all_diff", "lin_max", "element", "table",
    "interval", "no_overlap", "cumulative",
])


class _Overflow(Exception):
    """Encoding exceeded its size budget — caller falls back."""


class _Ladder:
    """Order encoding of an integer quantity: ``lits[t]`` <=> (S <= vals[t])
    for t < len(vals) - 1; (S <= vals[-1]) is implicitly true.  ``lits``
    holds DIMACS literals (possibly negated or constant)."""

    __slots__ = ("vals", "lits")

    def __init__(self, vals: List[int], lits: List[int]):
        self.vals = vals
        self.lits = lits

    def le_idx(self, t: int) -> int:
        """Literal for (S <= vals[t]); t may be out of range."""
        if t < 0:
            return FALSE_LIT
        if t >= len(self.vals) - 1:
            return TRUE_LIT
        return self.lits[t]

    def le_value(self, v: int) -> int:
        """Literal for (S <= v) for arbitrary integer v."""
        return self.le_idx(bisect_right(self.vals, v) - 1)

    def ge_value(self, v: int) -> int:
        """Literal for (S >= v)."""
        return -self.le_value(v - 1)


class Encoder:
    """CNF builder over order-encoded integer variables."""

    def __init__(self, model: ir.CpModelIR,
                 max_domain: int = 1024,
                 max_ladder: int = 4096,
                 budget_literals: int = 4_000_000):
        self.model = model
        self.max_domain = max_domain
        self.max_ladder = max_ladder
        self.budget = budget_literals
        self.nlits = 0
        self.next_var = 1            # var 1 reserved as TRUE
        self.clauses: List[List[int]] = [[TRUE_LIT]]
        self.ladders: List[Optional[_Ladder]] = []
        self._eq_cache: Dict[Tuple[int, int], int] = {}
        self.infeasible = False

    # -- low-level ---------------------------------------------------------
    def new_var(self) -> int:
        self.next_var += 1
        return self.next_var

    def emit(self, clause: Sequence[int]) -> None:
        out = []
        for lit in clause:
            if lit == TRUE_LIT:
                return  # satisfied
            if lit == FALSE_LIT:
                continue
            out.append(lit)
        if not out:
            self.infeasible = True
            return
        self.nlits += len(out) + 1
        if self.nlits > self.budget:
            raise _Overflow
        self.clauses.append(out)

    # -- variables ----------------------------------------------------------
    def build_variables(self) -> None:
        for v, var in enumerate(self.model.variables):
            dom = var.domain
            if dom.is_empty():
                self.infeasible = True
                self.ladders.append(_Ladder([0], []))
                continue
            if dom.size() > self.max_domain:
                raise _Overflow
            vals = list(dom)
            k = len(vals)
            if k == 1:
                self.ladders.append(_Ladder(vals, []))
                continue
            lits = [self.new_var() for _ in range(k - 1)]
            for t in range(k - 2):
                self.emit([-lits[t], lits[t + 1]])
            self.ladders.append(_Ladder(vals, lits))

    def var_ladder(self, v: int) -> _Ladder:
        return self.ladders[v]

    # IR boolean literal -> DIMACS literal over the var's {0,1} ladder.
    def bool_lit(self, lit: int) -> int:
        v = ir.literal_index(lit)
        lad = self.ladders[v]
        # (x = 1) == not (x <= 0) when 0 in domain; fixed domains constant
        if len(lad.vals) == 1:
            truth = lad.vals[0] != 0
            pos = TRUE_LIT if truth else FALSE_LIT
        else:
            pos = -lad.le_value(0)
        return pos if ir.literal_is_positive(lit) else -pos

    def enf_neg(self, ct: ir.ConstraintIR) -> List[int]:
        return [-self.bool_lit(l) for l in ct.enforcement_literals]

    # value literal for vals[t] of variable v (created on demand)
    def eq_idx(self, v: int, t: int) -> int:
        lad = self.ladders[v]
        k = len(lad.vals)
        if k == 1:
            return TRUE_LIT
        if t == 0:
            return lad.le_idx(0)
        if t == k - 1:
            return -lad.le_idx(k - 2)
        key = (v, t)
        e = self._eq_cache.get(key)
        if e is None:
            e = self.new_var()
            self._eq_cache[key] = e
            self.emit([-e, lad.le_idx(t)])
            self.emit([-e, -lad.le_idx(t - 1)])
            self.emit([e, -lad.le_idx(t), lad.le_idx(t - 1)])
        return e

    def eq_value(self, v: int, value: int) -> int:
        lad = self.ladders[v]
        t = bisect_left(lad.vals, value)
        if t >= len(lad.vals) or lad.vals[t] != value:
            return FALSE_LIT
        return self.eq_idx(v, t)

    # -- affine single-variable expressions ---------------------------------
    def affine(self, expr: ir.LinearExprIR) -> Optional[Tuple[int, int, int]]:
        """(c, v, o) for c*x_v + o; v = -1 for constants; None if not affine."""
        terms = [(v, c) for v, c in zip(expr.vars, expr.coeffs) if c != 0]
        if not terms:
            return (0, -1, expr.offset)
        if len(terms) > 1:
            return None
        v, c = terms[0]
        return (c, v, expr.offset)

    def affine_ladder(self, aff: Tuple[int, int, int]) -> _Ladder:
        """Order ladder of c*x + o (no new clauses: literals are reused)."""
        c, v, o = aff
        if v < 0 or c == 0:
            return _Ladder([o], [])
        lad = self.ladders[v]
        if c > 0:
            vals = [c * x + o for x in lad.vals]
            lits = list(lad.lits)
        else:
            vals = [c * x + o for x in reversed(lad.vals)]
            lits = [-l for l in reversed(lad.lits)]
        return _Ladder(vals, lits)

    def affine_eq_value(self, aff: Tuple[int, int, int], w: int) -> int:
        c, v, o = aff
        if v < 0 or c == 0:
            return TRUE_LIT if o == w else FALSE_LIT
        q, r = divmod(w - o, c)
        if r != 0:
            return FALSE_LIT
        return self.eq_value(v, q)

    # -- linear constraints: partial-sum ladders -----------------------------
    def _term_ladder(self, v: int, c: int) -> _Ladder:
        return self.affine_ladder((c, v, 0))

    def _sum_step(self, p: _Ladder, t: _Ladder, wlo: int, whi: int,
                  hard_window: bool) -> _Ladder:
        """Ladder for S = P + T clipped to [wlo, whi].  When hard_window,
        sums outside the window are made contradictory (staircase cuts);
        otherwise the window must already contain every reachable sum."""
        pv, tv = p.vals, t.vals
        if len(pv) * len(tv) * 2 > max(self.budget - self.nlits, 0):
            raise _Overflow  # the pair loops below would blow the budget
        values = sorted({a + b for a in pv for b in tv
                         if wlo <= a + b <= whi})
        if not values:
            self.infeasible = True
            return _Ladder([wlo], [])
        if len(values) > self.max_ladder:
            # coarsen to an arithmetic superset (sound: extra thresholds)
            g = 0
            for seq in (pv, tv):
                for i in range(1, len(seq)):
                    g = math.gcd(g, seq[i] - seq[i - 1])
            g = max(g, 1)
            lo, hi = values[0], values[-1]
            if (hi - lo) // g + 1 > self.max_ladder:
                raise _Overflow
            values = list(range(lo, hi + 1, g))
            if values[-1] != hi:
                values.append(hi)
        s = _Ladder(values,
                    [self.new_var() for _ in range(len(values) - 1)])
        for i in range(len(values) - 2):
            self.emit([-s.lits[i], s.lits[i + 1]])
        if hard_window:
            # (P >= a) & (T >= b) -> false for minimal pairs with a+b > whi
            for j in range(len(tv)):
                b = tv[j]
                i = bisect_right(pv, whi - b)
                if i < len(pv):
                    self.emit([p.le_idx(i - 1), t.le_idx(j - 1)])
            # (P <= a) & (T <= b) -> false for maximal pairs with a+b < wlo
            for j in range(len(tv)):
                b = tv[j]
                i = bisect_left(pv, wlo - b) - 1
                if i >= 0:
                    self.emit([-p.le_idx(i), -t.le_idx(j)])
        # upper: (P <= a) & (T <= b) -> (S <= a+b)
        for j in range(len(tv)):
            b = tv[j]
            tl = t.le_idx(j)
            for i in range(len(pv)):
                u = pv[i] + b
                if u >= values[-1]:
                    break  # implied for this and all larger a
                if u < values[0]:
                    continue
                self.emit([-p.le_idx(i), -tl, s.le_value(u)])
        # lower: (P >= a) & (T >= b) -> (S >= a+b)
        for j in range(len(tv)):
            b = tv[j]
            tl = t.le_idx(j - 1)  # (T >= tv[j]) == -le_idx(j-1)
            for i in range(len(pv) - 1, -1, -1):
                l = pv[i] + b
                if l <= values[0]:
                    break  # implied for this and all smaller a
                if l > values[-1]:
                    continue
                self.emit([p.le_idx(i - 1), tl, -s.le_value(l - 1)])
        return s

    def sum_ladder(self, terms: List[Tuple[int, int]],
                   dom: Optional[Domain], hard: bool) -> Optional[_Ladder]:
        """Ladder of sum(c*x) clipped against dom (when hard).  Returns the
        final ladder; ``None`` means the sum is constant (empty terms)."""
        if not terms:
            return None
        lads = [self._term_ladder(v, c) for v, c in terms]
        mins = [l.vals[0] for l in lads]
        maxs = [l.vals[-1] for l in lads]
        suf_min = [0] * (len(lads) + 1)
        suf_max = [0] * (len(lads) + 1)
        for i in range(len(lads) - 1, -1, -1):
            suf_min[i] = suf_min[i + 1] + mins[i]
            suf_max[i] = suf_max[i + 1] + maxs[i]
        s = lads[0]
        for k in range(1, len(lads)):
            reach_lo = s.vals[0] + mins[k]
            reach_hi = s.vals[-1] + maxs[k]
            if hard and dom is not None:
                wlo = max(reach_lo, dom.min() - suf_max[k + 1])
                whi = min(reach_hi, dom.max() - suf_min[k + 1])
            else:
                wlo, whi = reach_lo, reach_hi
            s = self._sum_step(s, lads[k], wlo, whi,
                               hard_window=hard and dom is not None
                               and (wlo > reach_lo or whi < reach_hi))
            if self.infeasible:
                return s
        return s

    def restrict_ladder(self, s: _Ladder, dom: Domain,
                        gate: List[int]) -> None:
        """Emit (gated) clauses forcing S into dom."""
        vals = s.vals
        # upper bound
        hi = dom.max()
        t = bisect_right(vals, hi) - 1
        if t < 0:
            self.emit(list(gate))  # unsatisfiable when enforced
            return
        self.emit(list(gate) + [s.le_idx(t)])
        # lower bound
        lo = dom.min()
        t = bisect_left(vals, lo)
        if t >= len(vals):
            self.emit(list(gate))
            return
        self.emit(list(gate) + [-s.le_idx(t - 1)])
        # holes: forbid each gap (b_prev, a_next)
        ivs = dom.intervals()
        for q in range(len(ivs) - 1):
            b_prev = ivs[q][1]
            a_next = ivs[q + 1][0]
            # (S <= b_prev) | (S >= a_next)
            self.emit(list(gate)
                      + [s.le_value(b_prev), s.ge_value(a_next)])

    # -- constraints ---------------------------------------------------------
    def encode_constraint(self, ct: ir.ConstraintIR) -> None:
        gate = self.enf_neg(ct)
        k = ct.kind
        if k == "bool_or":
            self.emit(gate + [self.bool_lit(l) for l in ct.args.literals])
        elif k == "bool_and":
            for l in ct.args.literals:
                self.emit(gate + [self.bool_lit(l)])
        elif k in ("at_most_one", "exactly_one"):
            lits = [self.bool_lit(l) for l in ct.args.literals]
            self._amo(lits, gate)
            if k == "exactly_one":
                self.emit(gate + lits)
        elif k == "bool_xor":
            self._xor(ct, gate)
        elif k == "linear":
            self._linear(ct, gate)
        elif k == "all_diff":
            self._all_diff(ct, gate)
        elif k == "lin_max":
            self._lin_max(ct, gate)
        elif k == "element":
            self._element(ct, gate)
        elif k == "table":
            self._table(ct, gate)
        elif k == "interval":
            self._interval(ct, gate)
        elif k == "no_overlap":
            self._no_overlap(ct, gate)
        elif k == "cumulative":
            self._cumulative(ct, gate)
        else:
            raise _Overflow  # out of fragment (checked earlier; safety)

    def _amo(self, lits: List[int], gate: List[int]) -> None:
        n = len(lits)
        if n <= 6 or gate:
            for i in range(n):
                for j in range(i + 1, n):
                    self.emit(gate + [-lits[i], -lits[j]])
            return
        # sequential ladder (ungated fast path)
        s_prev = None
        for i, l in enumerate(lits):
            if i == n - 1:
                if s_prev is not None:
                    self.emit([-s_prev, -l])
                break
            s = self.new_var()
            self.emit([-l, s])
            if s_prev is not None:
                self.emit([-s_prev, s])
                self.emit([-s_prev, -l])
            s_prev = s

    def _xor(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        lits = [self.bool_lit(l) for l in ct.args.literals]
        acc = None
        for l in lits:
            if acc is None:
                acc = l
                continue
            x = self.new_var()
            self.emit([-x, acc, l])
            self.emit([-x, -acc, -l])
            self.emit([x, -acc, l])
            self.emit([x, acc, -l])
            acc = x
        self.emit(gate + ([acc] if acc is not None else []))

    def _linear(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        a = ct.args
        self._linear_raw(a.vars, a.coeffs, a.domain, gate)

    def _linear_raw(self, vars_: Sequence[int], coeffs: Sequence[int],
                    dom: Domain, gate: List[int]) -> None:
        merged: Dict[int, int] = {}
        for v, c in zip(vars_, coeffs):
            merged[v] = merged.get(v, 0) + c
        terms = [(v, c) for v, c in merged.items() if c != 0]
        if not terms:
            if not dom.contains(0):
                self.emit(list(gate))
            return
        g = 0
        for _, c in terms:
            g = math.gcd(g, abs(c))
        if g > 1:
            terms = [(v, c // g) for v, c in terms]
            dom = dom.inverse_multiplication_by(g)
            if dom.is_empty():
                self.emit(list(gate))
                return
        if len(terms) == 1:
            v, c = terms[0]
            s = self._term_ladder(v, c)
            self.restrict_ladder(s, dom, gate)
            return
        # order heaviest terms first: keeps intermediate windows tight
        terms.sort(key=lambda t: -abs(t[1])
                   * (self.ladders[t[0]].vals[-1]
                      - self.ladders[t[0]].vals[0]))
        hard = not gate
        s = self.sum_ladder(terms, dom, hard)
        if self.infeasible or s is None:
            return
        self.restrict_ladder(s, dom, gate)

    def _all_diff(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        affs = []
        for e in ct.args.exprs:
            aff = self.affine(e)
            if aff is None:
                raise _Overflow
            affs.append(aff)
        by_value: Dict[int, List[int]] = {}
        for aff in affs:
            lad = self.affine_ladder(aff)
            for w in lad.vals:
                by_value.setdefault(w, []).append(
                    self.affine_eq_value(aff, w))
        for w, lits in by_value.items():
            lits = [l for l in lits if l != FALSE_LIT]
            if any(l == TRUE_LIT for l in lits):
                fixed = sum(1 for l in lits if l == TRUE_LIT)
                if fixed > 1:
                    self.emit(list(gate))
                    return
                for l in lits:
                    if l != TRUE_LIT:
                        self.emit(gate + [-l])
                continue
            if len(lits) > 1:
                self._amo(lits, gate)

    def _lin_max(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        tgt = self.affine(ct.args.target)
        if tgt is None:
            raise _Overflow
        affs = []
        for e in ct.args.exprs:
            aff = self.affine(e)
            if aff is None:
                raise _Overflow
            affs.append(aff)
        tlad = self.affine_ladder(tgt)
        elads = [self.affine_ladder(a) for a in affs]
        # target >= e_i: for each value w of e_i: (e_i >= w) -> (tgt >= w)
        for el in elads:
            for j, w in enumerate(el.vals):
                self.emit(gate + [el.le_idx(j - 1), tlad.ge_value(w)])
        # target <= max: (tgt >= u) -> OR_i (e_i >= u)
        for t, u in enumerate(tlad.vals):
            self.emit(gate + [tlad.le_idx(t - 1)]
                      + [el.ge_value(u) for el in elads])

    def _element(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        idx = self.affine(ct.args.index)
        tgt = self.affine(ct.args.target)
        if idx is None or tgt is None:
            raise _Overflow
        n = len(ct.args.exprs)
        ilad = self.affine_ladder(idx)
        self.restrict_ladder(ilad, Domain(0, n - 1), gate)
        tlad = self.affine_ladder(tgt)
        for ival in ilad.vals:
            if ival < 0 or ival >= n:
                continue
            aff = self.affine(ct.args.exprs[ival])
            if aff is None:
                raise _Overflow
            g = self.affine_eq_value(idx, ival)
            if g == FALSE_LIT:
                continue
            elad = self.affine_ladder(aff)
            guard = gate + ([] if g == TRUE_LIT else [-g])
            # threshold equality over merged boundary values
            for w in sorted(set(tlad.vals) | set(elad.vals)):
                tl = tlad.le_value(w)
                el = elad.le_value(w)
                self.emit(guard + [-tl, el])
                self.emit(guard + [tl, -el])

    def _table(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        affs = []
        for e in ct.args.exprs:
            aff = self.affine(e)
            if aff is None:
                raise _Overflow
            affs.append(aff)
        if ct.args.negated:
            for row in ct.args.values:
                self.emit(gate + [-self.affine_eq_value(a, w)
                                  for a, w in zip(affs, row)])
            return
        sels = []
        support: Dict[Tuple[int, int], List[int]] = {}
        for row in ct.args.values:
            eqs = [self.affine_eq_value(a, w) for a, w in zip(affs, row)]
            if any(l == FALSE_LIT for l in eqs):
                continue
            sel = self.new_var()
            sels.append(sel)
            for kcol, l in enumerate(eqs):
                if l != TRUE_LIT:
                    self.emit([-sel, l])
                support.setdefault((kcol, row[kcol]), []).append(sel)
        if not sels:
            self.emit(list(gate))
            return
        self.emit(gate + sels)
        # support direction: x_k = w -> some selecting tuple
        for aff, kcol in zip(affs, range(len(affs))):
            lad = self.affine_ladder(aff)
            for w in lad.vals:
                eq = self.affine_eq_value(aff, w)
                if eq == FALSE_LIT:
                    continue
                rows = support.get((kcol, w), [])
                self.emit(gate + ([] if eq == TRUE_LIT else [-eq]) + rows)

    # -- scheduling fragment -------------------------------------------------
    # Generalizes the ft10-prover order encoding (scheduling/jobshop.py,
    # reference heritage sat/intervals.h + sat/disjunctive.h) to arbitrary
    # CpModel interval / no_overlap / cumulative constraints, so general
    # scheduling models ride the learning core instead of the Python
    # propagation engine.

    def _interval(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        """start + size = end, size >= 0 (both gated on presence)."""
        a = ct.args
        vars_ = list(a.start.vars) + list(a.size.vars) + list(a.end.vars)
        coeffs = (list(a.start.coeffs) + list(a.size.coeffs)
                  + [-c for c in a.end.coeffs])
        const = a.start.offset + a.size.offset - a.end.offset
        self._linear_raw(vars_, coeffs, Domain(-const, -const), gate)
        if a.size.vars:
            self._linear_raw(list(a.size.vars), list(a.size.coeffs),
                             Domain(-a.size.offset, None), gate)
        elif a.size.offset < 0:
            self.emit(list(gate))

    def _presence_gate(self, iv_idx: int) -> List[int]:
        iv = self.model.constraints[iv_idx]
        return [-self.bool_lit(l) for l in iv.enforcement_literals]

    def _before_le(self, iv_a, iv_b, gate: List[int]) -> None:
        """end_a <= start_b under ``gate`` (matches the reference's
        zero-size no_overlap semantics: point intervals may touch but not
        sit strictly inside another interval)."""
        ea, sb = iv_a.args.end, iv_b.args.start
        vars_ = list(ea.vars) + list(sb.vars)
        coeffs = list(ea.coeffs) + [-c for c in sb.coeffs]
        const = ea.offset - sb.offset
        self._linear_raw(vars_, coeffs, Domain(None, -const), gate)

    def _no_overlap(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        idxs = list(ct.args.intervals)
        for i in range(len(idxs)):
            for j in range(i + 1, len(idxs)):
                iv_i = self.model.constraints[idxs[i]]
                iv_j = self.model.constraints[idxs[j]]
                pres = (self._presence_gate(idxs[i])
                        + self._presence_gate(idxs[j]))
                p = self.new_var()
                self._before_le(iv_i, iv_j, gate + pres + [-p])
                self._before_le(iv_j, iv_i, gate + pres + [p])

    def _cumulative(self, ct: ir.ConstraintIR, gate: List[int]) -> None:
        """Time-decomposition: at every candidate start time t,
        sum_i demand_i * [i covers t] <= capacity.  Constant capacity,
        demands and sizes; affine single-variable starts (else overflow
        -> caller falls back to the propagation engine)."""
        a = ct.args
        if a.capacity.vars or gate:
            raise _Overflow
        cap = a.capacity.offset
        tasks = []  # (aff_start, dur, demand, presence_gate)
        t_points: set = set()
        for iv_idx, dem in zip(a.intervals, a.demands):
            if dem.vars:
                raise _Overflow
            d_dem = dem.offset
            iv = self.model.constraints[iv_idx]
            if iv.args.size.vars:
                raise _Overflow
            dur = iv.args.size.offset
            if dur <= 0 or d_dem <= 0:
                continue  # matches checker: only z>0 & demand>0 load
            aff = self.affine(iv.args.start)
            if aff is None:
                raise _Overflow
            lad = self.affine_ladder(aff)
            tasks.append((aff, dur, d_dem, self._presence_gate(iv_idx)))
            t_points.update(lad.vals)
        if not tasks:
            return
        for t in sorted(t_points):
            cap_t = cap  # remaining capacity at t after constant loads
            terms: List[Tuple[int, int]] = []
            for aff, dur, d_dem, pres in tasks:
                lad = self.affine_ladder(aff)
                le_t = lad.le_value(t)          # [s <= t]
                le_before = lad.le_value(t - dur)  # [s <= t - d]
                if le_t == FALSE_LIT or le_before == TRUE_LIT:
                    continue  # cannot cover t
                if le_t == TRUE_LIT and le_before == FALSE_LIT and not pres:
                    # always covers t: constant load
                    cap_t -= d_dem
                    if cap_t < 0:
                        self.infeasible = True
                        return
                    continue
                y = self.new_var()
                cl = list(pres)
                if le_t != TRUE_LIT:
                    cl.append(-le_t)
                if le_before != FALSE_LIT:
                    cl.append(le_before)
                self.emit(cl + [y])
                # synthetic 0/1 ladder for the indicator
                v_idx = len(self.ladders)
                self.ladders.append(_Ladder([0, 1], [-y]))
                terms.append((v_idx, d_dem))
            if not terms:
                continue
            if sum(d for _, d in terms) <= cap_t:
                continue  # never violable at t
            s = self.sum_ladder(terms, Domain(None, cap_t), True)
            if self.infeasible:
                return
            if s is not None:
                self.restrict_ladder(s, Domain(None, cap_t), [])

    # -- decoding -------------------------------------------------------------
    def decode(self, model_bools: np.ndarray) -> List[int]:
        def lit_true(lit: int) -> bool:
            if lit == TRUE_LIT:
                return True
            if lit == FALSE_LIT:
                return False
            v = abs(lit) - 1
            val = bool(model_bools[v])
            return val if lit > 0 else not val

        out = []
        for v in range(len(self.model.variables)):
            lad = self.ladders[v]
            value = lad.vals[-1]
            for t, l in enumerate(lad.lits):
                if lit_true(l):
                    value = lad.vals[t]
                    break
            out.append(value)
        return out

    def flat_clauses(self) -> np.ndarray:
        total = sum(len(c) + 1 for c in self.clauses)
        flat = np.zeros(total, dtype=np.int32)
        i = 0
        for c in self.clauses:
            flat[i:i + len(c)] = c
            i += len(c) + 1
        return flat


def encode_model(model: ir.CpModelIR, max_domain: int = 1024,
                 budget_literals: int = 4_000_000) -> Optional[Encoder]:
    """Encode a model to CNF; None when out of fragment / over budget."""
    for ct in model.constraints:
        if ct.kind not in _SUPPORTED:
            return None
    enc = Encoder(model, max_domain=max_domain,
                  budget_literals=budget_literals)
    try:
        enc.build_variables()
        for ct in model.constraints:
            if enc.infeasible:
                break
            enc.encode_constraint(ct)
    except _Overflow:
        return None
    return enc


def solve_integer_cdcl(model: ir.CpModelIR, deadline: float,
                       should_stop=None,
                       conflict_chunk: int = 20_000,
                       max_domain: int = 1024,
                       budget_literals: int = 4_000_000,
                       known_sum_lower_bound: Optional[int] = None):
    """Solve a general integer CP model on the CDCL core.

    Returns None when the model is out of the encodable fragment, else
    ``(status, values, bound, num_conflicts)`` with status 1 = solved
    (optimal when an objective is present), 0 = infeasible, -1 = unknown
    (``values`` may still hold the best solution found; ``bound`` is the
    proven objective lower bound in minimization sense)."""
    obj = model.objective
    if time.perf_counter() > deadline or \
            (should_stop is not None and should_stop()):
        return None
    enc = encode_model(model, max_domain=max_domain,
                       budget_literals=budget_literals)
    if enc is None:
        return None
    if enc.infeasible:
        return 0, None, math.inf, 0

    sense = 1
    obj_ladder = None
    if obj is not None:
        sense = -1 if obj.maximize else 1
        merged: Dict[int, int] = {}
        for v, c in zip(obj.vars, obj.coeffs):
            merged[v] = merged.get(v, 0) + sense * c
        terms = [(v, c) for v, c in merged.items() if c != 0]
        try:
            obj_ladder = enc.sum_ladder(terms, None, hard=False) \
                if terms else None
        except _Overflow:
            return None
        if enc.infeasible:
            return 0, None, math.inf, 0

    from ortools_tpu_torch.sat.cdcl import CdclSolver, SAT, UNSAT

    solver = CdclSolver(enc.next_var)
    if not solver.add_clauses_flat(enc.flat_clauses()):
        return 0, None, math.inf, solver.num_conflicts

    # Hint-guided phase seeding (reference sat_decision.h
    # SetAssignmentPreference): make every ladder literal's saved phase
    # agree with the hinted value so decisions walk toward the hint.
    if model.solution_hint:
        phases = np.full(solver.num_vars, -1, dtype=np.int8)
        for v, h in model.solution_hint:
            if v >= len(enc.ladders):
                continue
            lad = enc.ladders[v]
            if lad is None:
                continue
            for t, lit in enumerate(lad.lits):
                var = abs(int(lit)) - 1
                if var <= 0:  # var 0 is the reserved TRUE constant
                    continue
                want = 1 if h <= lad.vals[t] else 0
                phases[var] = want if lit > 0 else 1 - want
        solver.set_phases(phases)

    def timed_solve(assumptions: Sequence[int]) -> int:
        while True:
            st = solver.solve(list(assumptions),
                              conflict_budget=conflict_chunk)
            if st != -1:
                return st
            if time.perf_counter() > deadline or \
                    (should_stop is not None and should_stop()):
                return -1

    assumptions = [enc.bool_lit(l) for l in model.assumptions]
    st = timed_solve(assumptions)
    if st == UNSAT:
        return 0, None, math.inf, solver.num_conflicts
    if st != SAT:
        return -1, None, -math.inf, solver.num_conflicts
    values = enc.decode(solver.model())
    if obj is None or obj_ladder is None:
        return 1, values, 0.0, solver.num_conflicts

    def internal_obj(vals: List[int]) -> int:
        return sense * sum(c * vals[v]
                           for v, c in zip(obj.vars, obj.coeffs))

    best = values
    best_v = internal_obj(values)
    lb = obj_ladder.vals[0]
    if known_sum_lower_bound is not None:
        # externally proven bound (e.g. the root LP relaxation,
        # sat/lp_propagator.py) shrinks the binary descent range
        lb = max(lb, int(known_sum_lower_bound))
    while lb < best_v:
        if time.perf_counter() > deadline or \
                (should_stop is not None and should_stop()):
            return (-1, best, float(lb), solver.num_conflicts)
        mid = (lb + best_v - 1) // 2
        a = obj_ladder.le_value(mid)
        if a == FALSE_LIT:
            lb = mid + 1
            continue
        extra = [] if a == TRUE_LIT else [a]
        st = timed_solve(assumptions + extra)
        if st == SAT:
            cand = enc.decode(solver.model())
            cv = internal_obj(cand)
            if cv < best_v:
                best, best_v = cand, cv
        elif st == UNSAT:
            lb = mid + 1
        else:
            return (-1, best, float(lb), solver.num_conflicts)
    return 1, best, float(best_v), solver.num_conflicts
