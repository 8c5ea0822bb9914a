"""CP propagation + depth-first search engine (host).

Capability parity: the roles of ``ortools/sat``'s propagation loop
(SatSolver::Propagate + propagator classes, SURVEY §3.1 hot path) and
integer search (integer_search.cc), re-scoped for round 1:

- domains are host-side ``Domain`` interval lists (exact integer arithmetic);
- propagators run to a fix point through a work queue (the analogue of
  GenericLiteralWatcher, integer.h:1357) — bounds/value reasoning per
  constraint kind, enforcement-literal semantics included;
- search is DFS with fail-first variable selection and value splitting,
  with user decision strategies honored first (cp_model.proto:506);
- optimization is solve / tighten-objective-bound / re-solve (objective
  constraint added between solutions), yielding proven optima;
- no clause learning yet: the CDCL core is planned as a native (C++)
  component in a later round (SURVEY §7 phase 4 note).

Completeness: propagators only prune values that cannot appear in any
solution, and the search enumerates remaining domains, so the engine is
complete on finite domains; every returned solution is re-checked by
sat/checker.py before leaving the solver facade.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.scheduling_propagators import (
    disjunctive_bounds,
    energetic_reasoning_bounds,
    timetable_bounds,
)
from ortools_tpu_torch.utils.domain import Domain, INT_MAX, INT_MIN

Doms = List[Domain]


class Conflict(Exception):
    pass


class Engine:
    def __init__(self, model: ir.CpModelIR, deadline: float = float("inf"),
                 max_branches: int = 10_000_000,
                 var_rule: str = "min_domain",
                 value_rule: str = "min",
                 seed: int = 0,
                 value_hints: Optional[Dict[int, int]] = None,
                 should_stop=None, profile: bool = False,
                 lp_propagator=None, lp_cutoff: Optional[int] = None,
                 lp_interval: int = 32) -> None:
        self.model = model
        # Node-level LP re-propagation (reference
        # linear_programming_constraint.h Propagate at every level):
        # called every `lp_interval` branches with the current domains.
        self.lp_propagator = lp_propagator
        self.lp_cutoff = lp_cutoff
        self.lp_interval = max(1, lp_interval)
        self.num_lp_prunes = 0
        self.deadline = deadline
        # cooperative interruption (reference util/sigint.h via the
        # shared time limit's stop flag)
        self.should_stop = should_stop or (lambda: False)
        self.max_branches = max_branches
        self.num_branches = 0
        self.num_conflicts = 0
        self.var_rule = var_rule  # min_domain | random | first
        self.value_rule = value_rule  # min | max | split | random
        # partial solution hints used as value ordering (the reference's
        # hint-following search, cp_model_solver QuickSolveWithHint role)
        self.value_hints = value_hints or {}
        import random as _random

        self._rng = _random.Random(seed)
        self._circuit_cache: Dict[int, tuple] = {}
        # per-propagator timing table (reference StatsGroup /
        # TimeDistribution, util/stats.h; DemonProfiler role): constraint
        # kind -> [num_runs, total_seconds]
        self.propagator_stats: Dict[str, list] = {}
        self.profile_propagators = profile
        # resumable search state (search_budget)
        self._current: Optional[Doms] = None
        self._stack: List[Tuple[Doms, int, Domain]] = []
        self._build()

    # ------------------------------------------------------------------
    def _build(self) -> None:
        m = self.model
        self.nvars = len(m.variables)
        # var -> constraint indices watching it
        self.watchers: List[Set[int]] = [set() for _ in range(self.nvars)]
        self.active_constraints: List[int] = []
        for ci, ct in enumerate(m.constraints):
            if ct.kind == "interval":
                # intervals are propagated through their scheduling
                # constraints and as plain linear relations added here
                pass
            self.active_constraints.append(ci)
            for v in self._constraint_vars(ct):
                if 0 <= v < self.nvars:
                    self.watchers[v].add(ci)

    def _constraint_vars(self, ct: ir.ConstraintIR) -> List[int]:
        out = [ir.literal_index(l) for l in ct.enforcement_literals]
        a = ct.args
        k = ct.kind
        if k in ("bool_or", "bool_and", "at_most_one", "exactly_one",
                 "bool_xor"):
            out += [ir.literal_index(l) for l in a.literals]
        elif k == "linear":
            out += list(a.vars)
        elif k == "all_diff":
            for e in a.exprs:
                out += e.vars
        elif k == "lin_max":
            out += a.target.vars
            for e in a.exprs:
                out += e.vars
        elif k == "int_prod":
            out += a.target.vars
            for e in a.exprs:
                out += e.vars
        elif k == "int_div":
            out += a.target.vars + a.num.vars + a.den.vars
        elif k == "int_mod":
            out += a.target.vars + a.num.vars + a.mod.vars
        elif k == "element":
            out += a.index.vars + a.target.vars
            for e in a.exprs:
                out += e.vars
        elif k == "table":
            for e in a.exprs:
                out += e.vars
        elif k == "interval":
            out += a.start.vars + a.size.vars + a.end.vars
        elif k in ("no_overlap", "cumulative"):
            for kk in a.intervals:
                ict = self.model.constraints[kk]
                out += self._constraint_vars(ict)
            if k == "cumulative":
                out += a.capacity.vars
                for e in a.demands:
                    out += e.vars
        elif k == "circuit":
            out += [ir.literal_index(l) for l in a.literals]
        elif k == "inverse":
            out += list(a.f_direct) + list(a.f_inverse)
        return out

    # ------------------------------------------------------------------
    # domain helpers (raise Conflict on wipeout)
    def _set(self, doms: Doms, v: int, nd: Domain, queue: Set[int]) -> None:
        if nd.is_empty():
            raise Conflict()
        if nd != doms[v]:
            doms[v] = nd
            queue.update(self.watchers[v])

    def _intersect(self, doms: Doms, v: int, d: Domain,
                   queue: Set[int]) -> None:
        self._set(doms, v, doms[v].intersection_with(d), queue)

    def _fix_literal(self, doms: Doms, lit: int, value: bool,
                     queue: Set[int]) -> None:
        v = ir.literal_index(lit)
        want = 1 if (value == (lit >= 0)) else 0
        self._intersect(doms, v, Domain(want, want), queue)

    def _lit_state(self, doms: Doms, lit: int) -> Optional[bool]:
        v = ir.literal_index(lit)
        d = doms[v]
        if d.is_fixed():
            val = bool(d.fixed_value())
            return val if lit >= 0 else not val
        return None

    # expression bounds under doms
    def _expr_hull(self, doms: Doms, e: ir.LinearExprIR) -> Tuple[int, int]:
        lo = hi = e.offset
        for v, c in zip(e.vars, e.coeffs):
            d = doms[v]
            a, b = c * d.min(), c * d.max()
            lo += min(a, b)
            hi += max(a, b)
        return lo, hi

    def _tighten_expr(self, doms: Doms, e: ir.LinearExprIR, lo: int, hi: int,
                      queue: Set[int]) -> None:
        """Enforce lo <= e <= hi by bounds propagation on e's variables."""
        if lo > hi:
            raise Conflict()
        cur_lo, cur_hi = self._expr_hull(doms, e)
        if cur_lo > hi or cur_hi < lo:
            raise Conflict()
        if cur_lo >= lo and cur_hi <= hi:
            return
        for v, c in zip(e.vars, e.coeffs):
            if c == 0:
                continue
            d = doms[v]
            a, b = c * d.min(), c * d.max()
            t_lo, t_hi = min(a, b), max(a, b)
            rest_lo = cur_lo - t_lo
            rest_hi = cur_hi - t_hi
            # c*v must lie within [lo - rest_hi, hi - rest_lo]
            term_dom = Domain(lo - rest_hi, hi - rest_lo)
            self._intersect(doms, v,
                            term_dom.inverse_multiplication_by(c), queue)

    # ------------------------------------------------------------------
    def _enforcement_state(self, doms: Doms,
                           ct: ir.ConstraintIR) -> Optional[bool]:
        """True = enforced, False = inactive, None = undecided."""
        all_true = True
        for lit in ct.enforcement_literals:
            s = self._lit_state(doms, lit)
            if s is False:
                return False
            if s is None:
                all_true = False
        return True if all_true else None

    def propagate(self, doms: Doms, queue: Set[int]) -> None:
        """Run the constraint queue to a fix point; raises Conflict."""
        rounds = 0
        while queue:
            rounds += 1
            if rounds % 256 == 0 and (
                    time.perf_counter() > self.deadline
                    or self.should_stop()):
                raise TimeoutError()
            ci = queue.pop()
            ct = self.model.constraints[ci]
            enf = self._enforcement_state(doms, ct)
            if enf is False:
                continue
            if enf is None:
                self._propagate_reverse(doms, ct, queue)
                continue
            if self.profile_propagators:
                t0 = time.perf_counter()
                try:
                    self._propagate_one(doms, ct, queue)
                finally:
                    rec = self.propagator_stats.setdefault(
                        ct.kind, [0, 0.0])
                    rec[0] += 1
                    rec[1] += time.perf_counter() - t0
            else:
                self._propagate_one(doms, ct, queue)

    def _propagate_reverse(self, doms: Doms, ct: ir.ConstraintIR,
                           queue: Set[int]) -> None:
        """Enforcement undecided: if the constraint is certainly violated,
        force the last undecided enforcement literal to false."""
        violated = False
        a = ct.args
        if ct.kind == "linear":
            e = ir.LinearExprIR(a.vars, a.coeffs, 0)
            lo, hi = self._expr_hull(doms, e)
            violated = a.domain.intersection_with(Domain(lo, hi)).is_empty()
        elif ct.kind == "bool_or":
            violated = all(
                self._lit_state(doms, l) is False for l in a.literals
            )
        elif ct.kind == "bool_and":
            violated = any(
                self._lit_state(doms, l) is False for l in a.literals
            )
        if not violated:
            return
        undecided = [l for l in ct.enforcement_literals
                     if self._lit_state(doms, l) is None]
        if len(undecided) == 1 and all(
            self._lit_state(doms, l) is True
            for l in ct.enforcement_literals if l not in undecided
        ):
            self._fix_literal(doms, undecided[0], False, queue)

    # ------------------------------------------------------------------
    def _propagate_one(self, doms: Doms, ct: ir.ConstraintIR,
                       queue: Set[int]) -> None:
        a = ct.args
        k = ct.kind
        if k == "bool_or":
            unfixed = []
            for lit in a.literals:
                s = self._lit_state(doms, lit)
                if s is True:
                    return
                if s is None:
                    unfixed.append(lit)
            if not unfixed:
                raise Conflict()
            if len(unfixed) == 1:
                self._fix_literal(doms, unfixed[0], True, queue)
        elif k == "bool_and":
            for lit in a.literals:
                self._fix_literal(doms, lit, True, queue)
        elif k in ("at_most_one", "exactly_one"):
            true_lits = []
            unfixed = []
            for lit in a.literals:
                s = self._lit_state(doms, lit)
                if s is True:
                    true_lits.append(lit)
                elif s is None:
                    unfixed.append(lit)
            if len(true_lits) > 1:
                raise Conflict()
            if len(true_lits) == 1:
                for lit in unfixed:
                    self._fix_literal(doms, lit, False, queue)
            elif k == "exactly_one":
                if not unfixed:
                    raise Conflict()
                if len(unfixed) == 1:
                    self._fix_literal(doms, unfixed[0], True, queue)
        elif k == "bool_xor":
            parity = 0
            unfixed = []
            for lit in a.literals:
                s = self._lit_state(doms, lit)
                if s is None:
                    unfixed.append(lit)
                elif s:
                    parity ^= 1
            if not unfixed:
                if parity != 1:
                    raise Conflict()
            elif len(unfixed) == 1:
                self._fix_literal(doms, unfixed[0], parity == 0, queue)
        elif k == "linear":
            e = ir.LinearExprIR(a.vars, a.coeffs, 0)
            hull = a.domain  # rhs domain (may have holes; use hull bounds)
            self._tighten_expr(doms, e, hull.min(), hull.max(), queue)
            # exact filtering when a single variable remains unfixed
            unfixed = [i for i, v in enumerate(a.vars)
                       if not doms[v].is_fixed()]
            if len(unfixed) == 1 and a.domain.num_intervals() > 1:
                i = unfixed[0]
                v, c = a.vars[i], a.coeffs[i]
                rest = sum(cc * doms[vv].fixed_value()
                           for j, (vv, cc) in enumerate(zip(a.vars, a.coeffs))
                           if j != i)
                self._intersect(
                    doms, v,
                    a.domain.offset(-rest).inverse_multiplication_by(c),
                    queue,
                )
            elif not unfixed:
                s = sum(c * doms[v].fixed_value()
                        for v, c in zip(a.vars, a.coeffs))
                if not a.domain.contains(s):
                    raise Conflict()
        elif k == "all_diff":
            # value propagation on fixed expressions + small pigeonhole
            fixed_vals: Dict[int, int] = {}
            for i, e in enumerate(a.exprs):
                lo, hi = self._expr_hull(doms, e)
                if lo == hi:
                    if lo in fixed_vals.values():
                        raise Conflict()
                    fixed_vals[i] = lo
            for i, e in enumerate(a.exprs):
                if i in fixed_vals:
                    continue
                if len(e.vars) == 1 and e.coeffs[0] in (1, -1):
                    v, c = e.vars[0], e.coeffs[0]
                    for val in fixed_vals.values():
                        # e = c*v + off == val  ->  v == (val-off)/c
                        t = (val - e.offset) * c
                        if doms[v].contains(t):
                            self._intersect(
                                doms, v,
                                Domain(t, t).complement(), queue,
                            )
            # Hall-interval bounds consistency (reference
            # sat/all_different.cc AllDifferentBoundsPropagator): for every
            # value interval [lo, hi], if the expressions whose hulls fit
            # inside number hi-lo+1 they saturate it, and any other
            # expression is pushed out of the interval.
            hulls = [self._expr_hull(doms, e) for e in a.exprs]
            n_ad = len(hulls)
            if 2 <= n_ad <= 64:
                los = sorted({lo for lo, _ in hulls})
                his = sorted({hi for _, hi in hulls})
                for lo_v in los:
                    for hi_v in his:
                        if hi_v < lo_v:
                            continue
                        width = hi_v - lo_v + 1
                        inside = [i for i, (l, h) in enumerate(hulls)
                                  if l >= lo_v and h <= hi_v]
                        if len(inside) > width:
                            raise Conflict()
                        if len(inside) == width:
                            ins = set(inside)
                            for i, (l, h) in enumerate(hulls):
                                if i in ins:
                                    continue
                                # push e_i out of the Hall interval
                                if lo_v <= l <= hi_v and h > hi_v:
                                    self._tighten_expr(
                                        doms, a.exprs[i], hi_v + 1, h,
                                        queue)
                                elif lo_v <= h <= hi_v and l < lo_v:
                                    self._tighten_expr(
                                        doms, a.exprs[i], l, lo_v - 1,
                                        queue)
                                elif l >= lo_v and h <= hi_v:
                                    raise Conflict()
        elif k == "lin_max":
            los, his = zip(*(self._expr_hull(doms, e) for e in a.exprs))
            t_lo, t_hi = self._expr_hull(doms, a.target)
            # target <= max(his); target >= max(los)
            self._tighten_expr(doms, a.target, max(los), max(his), queue)
            t_lo, t_hi = self._expr_hull(doms, a.target)
            # each expr <= target_hi
            for e, lo_e in zip(a.exprs, los):
                self._tighten_expr(doms, e, lo_e, t_hi, queue)
            # if only one expr can reach target_lo, it must
            can = [i for i, h in enumerate(his) if h >= t_lo]
            if len(can) == 1:
                i = can[0]
                self._tighten_expr(doms, a.exprs[i], t_lo, his[i], queue)
        elif k == "int_prod":
            lo = hi = 1
            fixed_all = True
            for e in a.exprs:
                elo, ehi = self._expr_hull(doms, e)
                cands = [lo * elo, lo * ehi, hi * elo, hi * ehi]
                lo, hi = min(cands), max(cands)
                fixed_all &= elo == ehi
            self._tighten_expr(doms, a.target, lo, hi, queue)
            if fixed_all:
                pass  # target already pinned by hull equality
            elif len(a.exprs) == 2:
                # reverse: divide target hull by the fixed operand
                t_lo, t_hi = self._expr_hull(doms, a.target)
                for i in (0, 1):
                    olo, ohi = self._expr_hull(doms, a.exprs[1 - i])
                    if olo == ohi and olo != 0:
                        d = Domain(t_lo, t_hi).inverse_multiplication_by(olo)
                        self._tighten_expr(doms, a.exprs[i], d.min(), d.max(),
                                           queue)
        elif k == "int_div":
            nlo, nhi = self._expr_hull(doms, a.num)
            dlo, dhi = self._expr_hull(doms, a.den)
            if dlo == dhi:
                if dlo == 0:
                    raise Conflict()
                c = dlo

                def div(x):
                    q = abs(x) // abs(c)
                    return q if (x >= 0) == (c > 0) else -q

                cands = [div(nlo), div(nhi)]
                self._tighten_expr(doms, a.target, min(cands), max(cands),
                                   queue)
        elif k == "int_mod":
            mlo, mhi = self._expr_hull(doms, a.mod)
            if mlo == mhi:
                if mlo == 0:
                    raise Conflict()
                mm = abs(mlo)
                nlo, nhi = self._expr_hull(doms, a.num)
                lo = -(mm - 1) if nlo < 0 else 0
                hi = (mm - 1) if nhi > 0 else 0
                self._tighten_expr(doms, a.target, lo, hi, queue)
                if nlo == nhi:
                    r = abs(nlo) % mm
                    if nlo < 0:
                        r = -r
                    self._tighten_expr(doms, a.target, r, r, queue)
        elif k == "element":
            n_exprs = len(a.exprs)
            self._tighten_expr(doms, a.index, 0, n_exprs - 1, queue)
            i_lo, i_hi = self._expr_hull(doms, a.index)
            t_lo, t_hi = self._expr_hull(doms, a.target)
            # prune index values whose expr hull misses target hull
            if len(a.index.vars) == 1 and a.index.coeffs[0] in (1, -1):
                iv, ic = a.index.vars[0], a.index.coeffs[0]
                for idx in range(max(0, i_lo), min(n_exprs, i_hi + 1)):
                    e_lo, e_hi = self._expr_hull(doms, a.exprs[idx])
                    if e_hi < t_lo or e_lo > t_hi:
                        vv = (idx - a.index.offset) * ic
                        if doms[iv].contains(vv):
                            self._intersect(doms, iv,
                                            Domain(vv, vv).complement(),
                                            queue)
            i_lo, i_hi = self._expr_hull(doms, a.index)
            if i_lo == i_hi:
                e = a.exprs[i_lo]
                # target == e
                lo1, hi1 = self._expr_hull(doms, e)
                self._tighten_expr(doms, a.target, lo1, hi1, queue)
                t_lo, t_hi = self._expr_hull(doms, a.target)
                self._tighten_expr(doms, e, t_lo, t_hi, queue)
            else:
                lows, highs = [], []
                for idx in range(max(0, i_lo), min(n_exprs, i_hi + 1)):
                    lo1, hi1 = self._expr_hull(doms, a.exprs[idx])
                    lows.append(lo1)
                    highs.append(hi1)
                if lows:
                    self._tighten_expr(doms, a.target, min(lows), max(highs),
                                       queue)
        elif k == "table":
            self._propagate_table(doms, a, queue)
        elif k == "interval":
            # start + size = end, size >= 0
            s, z, e = a.start, a.size, a.end
            z_lo, z_hi = self._expr_hull(doms, z)
            self._tighten_expr(doms, z, max(0, z_lo), z_hi, queue)
            for _ in range(2):
                s_lo, s_hi = self._expr_hull(doms, s)
                z_lo, z_hi = self._expr_hull(doms, z)
                e_lo, e_hi = self._expr_hull(doms, e)
                self._tighten_expr(doms, e, s_lo + z_lo, s_hi + z_hi, queue)
                self._tighten_expr(doms, s, e_lo - z_hi, e_hi - z_lo, queue)
                self._tighten_expr(doms, z, e_lo - s_hi, e_hi - s_lo, queue)
        elif k == "no_overlap":
            self._propagate_no_overlap(doms, a, queue)
        elif k == "cumulative":
            self._propagate_cumulative(doms, a, queue)
        elif k == "circuit":
            self._propagate_circuit(doms, a, queue)
        elif k == "inverse":
            nn = len(a.f_direct)
            for arr, other in ((a.f_direct, a.f_inverse),
                               (a.f_inverse, a.f_direct)):
                for i, v in enumerate(arr):
                    self._intersect(doms, v, Domain(0, nn - 1), queue)
                    if doms[v].is_fixed():
                        j = doms[v].fixed_value()
                        self._intersect(doms, other[j], Domain(i, i), queue)
        else:
            raise ValueError(f"unknown constraint kind {k}")

    def _propagate_table(self, doms: Doms, a: ir.TableArgs,
                         queue: Set[int]) -> None:
        simple = all(len(e.vars) == 1 and e.coeffs[0] == 1 and e.offset == 0
                     for e in a.exprs)
        if a.negated:
            # forbid each tuple once all-but-one positions are decided
            for t in a.values:
                undecided = []
                ok = True
                for pos, e in enumerate(a.exprs):
                    lo, hi = self._expr_hull(doms, e)
                    if lo == hi:
                        if lo != t[pos]:
                            ok = False
                            break
                    else:
                        undecided.append(pos)
                if not ok:
                    continue
                if not undecided:
                    raise Conflict()
                if len(undecided) == 1 and simple:
                    pos = undecided[0]
                    v = a.exprs[pos].vars[0]
                    bad = t[pos]
                    if doms[v].contains(bad):
                        self._intersect(doms, v,
                                        Domain(bad, bad).complement(), queue)
            return
        # positive table: GAC when all exprs are plain variables
        if not simple:
            # fall back: check only when everything is fixed
            vals = []
            for e in a.exprs:
                lo, hi = self._expr_hull(doms, e)
                if lo != hi:
                    return
                vals.append(lo)
            if tuple(vals) not in a.values:
                raise Conflict()
            return
    # (simple positive table)
        vars_ = [e.vars[0] for e in a.exprs]
        live = [t for t in a.values
                if all(doms[v].contains(val) for v, val in zip(vars_, t))]
        if not live:
            raise Conflict()
        for pos, v in enumerate(vars_):
            support = Domain.from_values([t[pos] for t in live])
            self._intersect(doms, v, support, queue)

    def _interval_info(self, doms: Doms, k: int):
        """(present?, s_lo, s_hi, z_lo, z_hi, e_lo, e_hi) for interval ct k;
        present is True/False/None (optional undecided)."""
        ct = self.model.constraints[k]
        enf = self._enforcement_state(doms, ct)
        a = ct.args
        s_lo, s_hi = self._expr_hull(doms, a.start)
        z_lo, z_hi = self._expr_hull(doms, a.size)
        e_lo, e_hi = self._expr_hull(doms, a.end)
        return enf, s_lo, s_hi, z_lo, z_hi, e_lo, e_hi

    def _propagate_no_overlap(self, doms: Doms, a: ir.NoOverlapArgs,
                              queue: Set[int]) -> None:
        infos = [(k, self._interval_info(doms, k)) for k in a.intervals]
        present = [(k, info) for k, info in infos if info[0] is True]
        # Pairwise disjunctive reasoning.  Per the reference
        # (cp_model.proto:131-133) size-0 intervals DO matter: a point
        # interval strictly inside another is infeasible, so zero-size
        # intervals are not skipped.  For each pair at most one ordering
        # ("i before j" meaning end_i <= start_j) may remain possible; if
        # none is, the pair (hence the constraint) is infeasible.
        for i in range(len(present)):
            ki, (_, si_lo, si_hi, zi_lo, _, ei_lo, ei_hi) = present[i]
            for j in range(i + 1, len(present)):
                kj, (_, sj_lo, sj_hi, zj_lo, _, ej_lo, ej_hi) = present[j]
                i_before_j = ei_lo <= sj_hi  # end_i <= start_j satisfiable
                j_before_i = ej_lo <= si_hi
                if not i_before_j and not j_before_i:
                    # covers mandatory-part overlap AND the zero-size-
                    # inside-interval case
                    raise Conflict()
                ai = self.model.constraints[ki].args
                aj = self.model.constraints[kj].args
                if not i_before_j:  # -> j must be before i
                    self._tighten_expr(doms, aj.end,
                                       ej_lo, min(ej_hi, si_hi), queue)
                    self._tighten_expr(doms, ai.start,
                                       max(si_lo, ej_lo), si_hi, queue)
                elif not j_before_i:  # -> i must be before j
                    self._tighten_expr(doms, ai.end,
                                       ei_lo, min(ei_hi, sj_hi), queue)
                    self._tighten_expr(doms, aj.start,
                                       max(sj_lo, ei_lo), sj_hi, queue)
        # Θ-tree-style overload checking + edge finding over the whole
        # task set (reference sat/disjunctive.h:135-232, theta_tree.h) —
        # strictly stronger than the pairwise pass for 3+ tasks.
        tasks = [(k, info) for k, info in present if info[3] > 0]
        if len(tasks) >= 3:
            est = np.array([info[1] for _, info in tasks], dtype=np.int64)
            lct = np.array([info[6] for _, info in tasks], dtype=np.int64)
            dur = np.array([info[3] for _, info in tasks], dtype=np.int64)
            new_est, new_lct, ok = disjunctive_bounds(est, lct, dur)
            if not ok:
                raise Conflict()
            for t, (k, info) in enumerate(tasks):
                at = self.model.constraints[k].args
                if new_est[t] > est[t]:
                    self._tighten_expr(doms, at.start,
                                       int(new_est[t]), info[2], queue)
                if new_lct[t] < lct[t]:
                    self._tighten_expr(doms, at.end,
                                       info[5], int(new_lct[t]), queue)

    def _propagate_cumulative(self, doms: Doms, a: ir.CumulativeArgs,
                              queue: Set[int]) -> None:
        """Timetable propagation (reference sat/timetable.h): mandatory-
        part profile conflict + per-task start/end tightening + capacity
        lower bound, via sat/scheduling_propagators.timetable_bounds."""
        cap_lo, cap_hi = self._expr_hull(doms, a.capacity)
        tasks = []  # (k, info, d_lo)
        for kk, dem in zip(a.intervals, a.demands):
            enf, s_lo, s_hi, z_lo, _, e_lo, e_hi = \
                self._interval_info(doms, kk)
            if enf is not True:
                continue
            d_lo, _ = self._expr_hull(doms, dem)
            if d_lo <= 0 or z_lo <= 0:
                continue
            tasks.append((kk, (s_lo, s_hi, e_lo, e_hi, z_lo), d_lo))
        if not tasks:
            return
        est = np.array([t[1][0] for t in tasks], dtype=np.int64)
        lst = np.array([t[1][1] for t in tasks], dtype=np.int64)
        ect = np.array([t[1][2] for t in tasks], dtype=np.int64)
        lct = np.array([t[1][3] for t in tasks], dtype=np.int64)
        dur = np.array([t[1][4] for t in tasks], dtype=np.int64)
        dem_lo = np.array([t[2] for t in tasks], dtype=np.int64)
        new_est, new_lct, ok, prof_max = timetable_bounds(
            est, lst, ect, lct, dur, dem_lo, int(cap_hi))
        if not ok:
            raise Conflict()
        if prof_max > cap_lo:
            self._tighten_expr(doms, a.capacity, int(prof_max), cap_hi,
                               queue)
        # Energetic reasoning on top of the timetable bounds (reference
        # sat/cumulative_energy.{h,cc}); O(n^2) windows vectorized, so
        # gate by task count.
        if 2 <= len(tasks) <= 144:
            new_est, new_lct, ok = energetic_reasoning_bounds(
                new_est, new_lct, dur, dem_lo, int(cap_hi))
            if not ok:
                raise Conflict()
        for t, (kk, info, _) in enumerate(tasks):
            at = self.model.constraints[kk].args
            if new_est[t] > est[t]:
                self._tighten_expr(doms, at.start,
                                   int(new_est[t]), info[1], queue)
            if new_lct[t] < lct[t]:
                self._tighten_expr(doms, at.end,
                                   info[2], int(new_lct[t]), queue)

    def _propagate_circuit(self, doms: Doms, a: ir.CircuitArgs,
                           queue: Set[int]) -> None:
        # Degree reasoning: every node has exactly one outgoing and one
        # incoming true arc (a true self-loop marks the node skipped).
        key = id(a)
        cached = self._circuit_cache.get(key)
        if cached is None:
            out_arcs: Dict[int, List[int]] = {}
            in_arcs: Dict[int, List[int]] = {}
            for t, h, lit in zip(a.tails, a.heads, a.literals):
                out_arcs.setdefault(t, []).append(lit)
                in_arcs.setdefault(h, []).append(lit)
            cached = (out_arcs, in_arcs)
            self._circuit_cache[key] = cached
        out_arcs, in_arcs = cached
        for group in list(out_arcs.values()) + list(in_arcs.values()):
            true_lits = []
            unfixed = []
            for lit in group:
                s = self._lit_state(doms, lit)
                if s is True:
                    true_lits.append(lit)
                elif s is None:
                    unfixed.append(lit)
            if len(true_lits) > 1:
                raise Conflict()
            if len(true_lits) == 1:
                for lit in unfixed:
                    self._fix_literal(doms, lit, False, queue)
            else:
                if not unfixed:
                    raise Conflict()  # node with no outgoing/incoming arc
                if len(unfixed) == 1:
                    self._fix_literal(doms, unfixed[0], True, queue)
        # selected arc map; detect premature subcycles
        nexts: Dict[int, int] = {}
        nodes = set(a.tails) | set(a.heads)
        for t, h, lit in zip(a.tails, a.heads, a.literals):
            s = self._lit_state(doms, lit)
            if s is True:
                if t in nexts and nexts[t] != h:
                    raise Conflict()
                nexts[t] = h
        # nodes that can still be skipped: their self-loop is true or
        # undecided; everyone else must be on the circuit
        may_skip: Set[int] = set()
        for t, h, lit in zip(a.tails, a.heads, a.literals):
            if t == h and self._lit_state(doms, lit) is not False:
                may_skip.add(t)
        definitely_visit = nodes - may_skip
        active = {t: h for t, h in nexts.items() if t != h}
        # follow chains; a closed cycle must cover every definite node
        seen_global: Set[int] = set()
        for start in list(active.keys()):
            if start in seen_global:
                continue
            path = [start]
            cur = start
            while cur in active:
                nxt = active[cur]
                if nxt == start:
                    if definitely_visit - set(path):
                        raise Conflict()  # cycle closed, mandatory node out
                    break
                if nxt in path:
                    raise Conflict()  # lasso
                path.append(nxt)
                cur = nxt
            seen_global.update(path)

    # ------------------------------------------------------------------
    # search
    def initial_domains(self) -> Doms:
        return [v.domain for v in self.model.variables]

    def root_propagate(self, doms: Doms) -> bool:
        try:
            self.propagate(doms, set(self.active_constraints))
            return True
        except Conflict:
            return False

    def _pick_variable(self, doms: Doms) -> Optional[int]:
        # honor user decision strategies first (choose_first semantics)
        for strat in self.model.search_strategies:
            for v in strat.variables:
                if not doms[v].is_fixed():
                    return v
        if self.var_rule == "first":
            for v in range(self.nvars):
                if not doms[v].is_fixed():
                    return v
            return None
        if self.var_rule == "random":
            unfixed = [v for v in range(self.nvars)
                       if not doms[v].is_fixed()]
            return self._rng.choice(unfixed) if unfixed else None
        best_v, best_size = None, None
        for v in range(self.nvars):
            d = doms[v]
            if d.is_fixed():
                continue
            size = d.size()
            if best_size is None or size < best_size:
                best_v, best_size = v, size
                if size == 2:
                    break
        return best_v

    def _branch_domains(self, d: Domain, var: int = -1
                        ) -> Tuple[Domain, Domain]:
        """(left, right) split of a non-fixed domain per value_rule."""
        hint = self.value_hints.get(var)
        if hint is not None and d.contains(hint):
            left = Domain(hint, hint)
            return left, d.intersection_with(left.complement())
        if self.value_rule == "max":
            val = d.max()
            left = Domain(val, val)
        elif self.value_rule == "split":
            mid = (d.min() + d.max()) // 2
            left = d.intersection_with(Domain(None, mid))
            if left.is_empty() or left == d:
                val = d.min()
                left = Domain(val, val)
        elif self.value_rule == "random":
            lo, hi = d.min(), d.max()
            val = self._rng.randint(lo, hi)
            if not d.contains(val):
                val = d.min()
            left = Domain(val, val)
        else:  # "min"
            val = d.min()
            left = Domain(val, val)
        right = d.intersection_with(left.complement())
        return left, right

    def search(self, doms: Doms,
               on_solution: Callable[[List[int]], bool]) -> str:
        """DFS to completion.  Returns "done" | "stopped" | "limit"."""
        self.start_search(doms)
        return self.search_budget(on_solution, self.max_branches)

    def start_search(self, doms: Doms) -> None:
        self._current = doms
        self._stack = []

    def search_budget(self, on_solution: Callable[[List[int]], bool],
                      max_branches: int) -> str:
        """Resumable DFS slice: runs until the tree is exhausted ("done"),
        the callback stops it ("stopped"), the global limits hit ("limit"),
        or the slice budget runs out ("paused") — the substrate for the
        deterministic interleaved portfolio (reference subsolver.cc:111)."""
        assert self._current is not None, "start_search first"
        current = self._current
        stack = self._stack
        slice_end = self.num_branches + max_branches

        while True:
            if time.perf_counter() > self.deadline or self.should_stop():
                self._current = current
                return "limit"
            v = self._pick_variable(current)
            if v is None:
                values = [d.fixed_value() for d in current]
                if not on_solution(values):
                    self._current = current
                    return "stopped"
                # treat as conflict: backtrack
                current = self._backtrack(stack)
                if current is None:
                    return "done"
                continue
            if self.num_branches >= self.max_branches:
                self._current = current
                return "limit"
            if self.num_branches >= slice_end:
                self._current = current
                return "paused"
            self.num_branches += 1
            left, right = self._branch_domains(current[v], v)
            stack.append((list(current), v, right))
            try:
                q: Set[int] = set()
                self._set(current, v, left, q)
                self.propagate(current, q)
                if (self.lp_propagator is not None
                        and self.num_branches % self.lp_interval == 0):
                    self._lp_propagate(current)
            except Conflict:
                self.num_conflicts += 1
                current = self._backtrack(stack)
                if current is None:
                    return "done"

    def _lp_propagate(self, current: Doms) -> None:
        """Run the node LP; raise Conflict on a proven prune, apply
        reduced-cost tightenings otherwise."""
        out = self.lp_propagator.propagate(current, self.lp_cutoff,
                                           self.deadline)
        if out is None:
            return
        if out == "infeasible":
            self.num_lp_prunes += 1
            raise Conflict()
        q: Set[int] = set()
        changed = False
        for v, nlo, nhi in out:
            if v >= len(current):
                continue
            d = current[v]
            nd = d.intersection_with(Domain(
                nlo if nlo is not None else d.min(),
                nhi if nhi is not None else d.max()))
            if nd.is_empty():
                self.num_lp_prunes += 1
                raise Conflict()
            if nd != d:
                current[v] = nd
                q.update(self.watchers[v])
                changed = True
        if changed:
            self.propagate(current, q)

    def _backtrack(self, stack) -> Optional[Doms]:
        while stack:
            doms, v, rest = stack.pop()
            try:
                q: Set[int] = set()
                self._set(doms, v, rest, q)
                self.propagate(doms, q)
                return doms
            except Conflict:
                self.num_conflicts += 1
                continue
        return None
