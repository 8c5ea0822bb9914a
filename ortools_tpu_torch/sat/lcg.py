"""Lazy clause generation: general-integer CP models on the native LCG core.

Capability parity: the reference's central CP-SAT architecture — integer
variables INSIDE the clause-learning core via lazily created bound
literals and explained bound propagation:
``IntegerEncoder`` (ortools/sat/integer.h:453), ``IntegerTrail``
(integer.h:722), ``LinearPropagator`` (sat/linear_propagation.h:176),
precedences (sat/precedences.h:111).  The native engine is
``_native/lcg.cc``; this module compiles a ``CpModelIR`` fragment onto it
and runs the assumption-driven objective descent.

Contrast with the two existing integer paths:
  - ``sat/integer_encoding.py`` (eager order encoding): same learning
    power but the ladder is materialized up front — blows up on large
    domains (gated at max_domain=1024 values);
  - ``sat/engine.py`` (DFS): propagates any constraint but learns nothing.
Here bound literals [x >= v] are created only when propagation,
explanation, or branching actually touches the bound v, so scheduling
horizons of 10^5+ cost nothing until used.

Supported fragment (compile_model returns None otherwise, callers fall
back): bool_or / bool_and / at_most_one / exactly_one / bool_xor,
linear (enforcement literals, multi-interval domains), interval /
no_overlap (pairwise reified precedences), lin_max, all_diff (pairwise),
cumulative with fixed sizes/demands/capacity (time-indexed decomposition).

Every model variable becomes a native integer variable; boolean literals
are the lazily shared bound literals [x >= 1] — one uniform space for
clauses, linears, and learning.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ortools_tpu_torch._native.build import load_library
from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain

_LIB = None

# external sentinel literals from the native core
TRUE_EXT = 2**31 - 1
FALSE_EXT = -(2**31 - 1)

SAT = 1
UNSAT = 0
UNKNOWN = -1


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library("lcg")
        c = ctypes
        sigs = [
            ("lcg_new", c.c_void_p, []),
            ("lcg_free", None, [c.c_void_p]),
            ("lcg_new_bool", c.c_int32, [c.c_void_p]),
            ("lcg_new_int", c.c_int32, [c.c_void_p, c.c_int64, c.c_int64]),
            ("lcg_num_bools", c.c_int32, [c.c_void_p]),
            ("lcg_add_clause", c.c_int32,
             [c.c_void_p, c.POINTER(c.c_int32), c.c_int32]),
            ("lcg_add_linear", c.c_int32,
             [c.c_void_p, c.POINTER(c.c_int32), c.c_int32,
              c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.c_int32,
              c.c_int64, c.c_int64]),
            ("lcg_ge_literal", c.c_int32,
             [c.c_void_p, c.c_int32, c.c_int64]),
            ("lcg_solve", c.c_int32,
             [c.c_void_p, c.POINTER(c.c_int32), c.c_int32, c.c_int64,
              c.c_double]),
            ("lcg_int_value", c.c_int64, [c.c_void_p, c.c_int32]),
            ("lcg_bool_value", c.c_int32, [c.c_void_p, c.c_int32]),
            ("lcg_get_core", c.c_int32,
             [c.c_void_p, c.POINTER(c.c_int32)]),
            ("lcg_set_int_hint", None, [c.c_void_p, c.c_int32, c.c_int64]),
            ("lcg_num_conflicts", c.c_int64, [c.c_void_p]),
            ("lcg_num_propagations", c.c_int64, [c.c_void_p]),
            ("lcg_num_bound_literals", c.c_int64, [c.c_void_p]),
            ("lcg_num_ints", c.c_int32, [c.c_void_p]),
            ("lcg_set_export_limits", None,
             [c.c_void_p, c.c_int32, c.c_int32]),
            ("lcg_export_shared", c.c_int32,
             [c.c_void_p, c.POINTER(c.c_int64), c.c_int32]),
            ("lcg_import_shared", c.c_int32,
             [c.c_void_p, c.POINTER(c.c_int64), c.c_int32]),
            ("lcg_num_shared_imported", c.c_int64, [c.c_void_p]),
        ]
        for name, res, args in sigs:
            f = getattr(lib, name)
            f.restype = res
            f.argtypes = args
        _LIB = lib
    return _LIB


_BIG = 2**52  # "infinite" linear-side sentinel, well under the native cap


class LcgSolver:
    """Thin incremental wrapper over the native LCG core."""

    def __init__(self) -> None:
        self._lib = _lib()
        self._handle = ctypes.c_void_p(self._lib.lcg_new())
        self.infeasible = False

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.lcg_free(self._handle)
                self._handle = None
        except Exception:
            pass

    # -- building ----------------------------------------------------------
    def new_int(self, lb: int, ub: int) -> int:
        return self._lib.lcg_new_int(self._handle, lb, ub)

    def new_bool01(self) -> int:
        """A fresh [0,1] integer used as an auxiliary boolean; its literal
        is ``self.ge(x, 1)``."""
        return self.new_int(0, 1)

    def ge(self, x: int, v: int) -> int:
        """External literal for [x >= v] (TRUE_EXT/FALSE_EXT sentinels)."""
        return self._lib.lcg_ge_literal(self._handle, x, v)

    def le(self, x: int, v: int) -> int:
        return -self.ge(x, v + 1)

    def add_clause(self, lits: Sequence[int]) -> None:
        out = []
        for l in lits:
            if l == TRUE_EXT:
                return  # satisfied
            if l == FALSE_EXT:
                continue
            out.append(int(l))
        if not out:
            self.infeasible = True
            return
        arr = (ctypes.c_int32 * len(out))(*out)
        if self._lib.lcg_add_clause(self._handle, arr, len(out)) != 0:
            self.infeasible = True

    def add_linear(self, enf: Sequence[int], xs: Sequence[int],
                   cs: Sequence[int], lo: Optional[int],
                   hi: Optional[int]) -> None:
        es = []
        for e in enf:
            if e == FALSE_EXT:
                return  # never enforced
            if e == TRUE_EXT:
                continue
            es.append(int(e))
        lo = -_BIG if lo is None or lo < -_BIG else int(lo)
        hi = _BIG if hi is None or hi > _BIG else int(hi)
        ea = (ctypes.c_int32 * max(1, len(es)))(*es)
        xa = (ctypes.c_int32 * max(1, len(xs)))(*[int(x) for x in xs])
        ca = (ctypes.c_int64 * max(1, len(cs)))(*[int(c) for c in cs])
        if self._lib.lcg_add_linear(self._handle, ea, len(es), xa, ca,
                                    len(xs), lo, hi) != 0:
            self.infeasible = True

    def set_int_hint(self, x: int, value: int) -> None:
        self._lib.lcg_set_int_hint(self._handle, x, value)

    # -- solving -----------------------------------------------------------
    def solve(self, assumptions: Sequence[int] = (),
              conflict_budget: int = 0,
              time_budget: float = 0.0) -> int:
        if self.infeasible:
            return UNSAT
        out = []
        for a in assumptions:
            if a == TRUE_EXT:
                continue
            if a == FALSE_EXT:
                return UNSAT
            out.append(int(a))
        arr = (ctypes.c_int32 * max(1, len(out)))(*out)
        return self._lib.lcg_solve(self._handle, arr, len(out),
                                   conflict_budget, time_budget)

    def int_value(self, x: int) -> int:
        return self._lib.lcg_int_value(self._handle, x)

    def lit_value(self, lit: int) -> bool:
        if lit == TRUE_EXT:
            return True
        if lit == FALSE_EXT:
            return False
        v = self._lib.lcg_bool_value(self._handle, abs(lit) - 1)
        return bool(v) if lit > 0 else not v

    # -- shared clauses (reference SharedClausesManager,
    # synchronization.h:538): binary clauses + unit facts described at
    # model level (plain bool / [x >= v] bound literal) so instances
    # built from the same model prefix can exchange them ----------------
    def set_export_limits(self, n_bools: int, n_ints: int) -> None:
        self._lib.lcg_set_export_limits(self._handle, n_bools, n_ints)

    def export_shared(self, max_clauses: int = 1024):
        import numpy as np

        buf = np.zeros(8 * max_clauses, dtype=np.int64)
        n = self._lib.lcg_export_shared(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_clauses)
        return buf[: 8 * n].reshape(n, 8).copy()

    def import_shared(self, descs) -> None:
        import numpy as np

        descs = np.ascontiguousarray(descs, dtype=np.int64)
        if descs.size == 0:
            return
        n = descs.shape[0]
        r = self._lib.lcg_import_shared(
            self._handle,
            descs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
        if r != 0:
            self.infeasible = True

    @property
    def num_shared_imported(self) -> int:
        return self._lib.lcg_num_shared_imported(self._handle)

    @property
    def num_ints(self) -> int:
        return self._lib.lcg_num_ints(self._handle)

    @property
    def num_conflicts(self) -> int:
        return self._lib.lcg_num_conflicts(self._handle)

    @property
    def num_bound_literals(self) -> int:
        return self._lib.lcg_num_bound_literals(self._handle)


# --------------------------------------------------------------------------
# CpModelIR -> native program
# --------------------------------------------------------------------------

_SUPPORTED = frozenset([
    "bool_or", "bool_and", "at_most_one", "exactly_one", "bool_xor",
    "linear", "interval", "no_overlap", "lin_max", "all_diff", "cumulative",
    "no_overlap_2d", "table", "element", "circuit", "inverse",
])

_MAX_CIRCUIT_NODES = 128   # MTZ lowering budget
_MAX_CIRCUIT_ARCS = 8000
_MAX_INVERSE = 100         # n^2 channeling bools

_MAX_TABLE_CELLS = 60_000   # tuples x width budget per table constraint

_MAX_PAIRS = 30_000        # no_overlap pairwise budget
_MAX_ALLDIFF = 40          # pairwise all_diff width
_MAX_TIMEINDEX = 400_000   # cumulative time-indexed cells


class _Unsupported(Exception):
    pass


class LcgProgram:
    """A compiled model: native solver + var maps + decode."""

    def __init__(self, model: ir.CpModelIR):
        self.model = model
        self.s = LcgSolver()
        self.nvars = len(model.variables)
        self.xs: List[int] = []
        for v in model.variables:
            d = v.domain
            lo, hi = int(d.min()), int(d.max())
            if abs(lo) > _BIG or abs(hi) > _BIG:
                raise _Unsupported("unbounded variable domain")
            x = self.s.new_int(lo, hi)
            self.xs.append(x)
        # domain holes: [x >= gap_lo] -> [x >= next_lo]
        for i, v in enumerate(model.variables):
            ivs = v.domain.intervals()
            for k in range(len(ivs) - 1):
                a_end = ivs[k][1]
                b_start = ivs[k + 1][0]
                self.s.add_clause([
                    -self.s.ge(self.xs[i], a_end + 1),
                    self.s.ge(self.xs[i], b_start),
                ])
        # interval constraint index -> (start, size, end exprs, enf lits)
        self.intervals: Dict[int, Tuple[ir.LinearExprIR, ir.LinearExprIR,
                                        ir.LinearExprIR, List[int]]] = {}

    # -- literal/expr helpers ----------------------------------------------
    def lit(self, l: int) -> int:
        """Model literal -> native external literal ([x >= 1])."""
        v = ir.literal_index(l)
        g = self.s.ge(self.xs[v], 1)
        return g if ir.literal_is_positive(l) else -g

    def _merge_expr(self, exprs_coeffs) -> Tuple[List[int], List[int], int]:
        """[(expr, mult)] -> (native var list, coeffs, constant)."""
        acc: Dict[int, int] = {}
        const = 0
        for e, m in exprs_coeffs:
            const += m * e.offset
            for v, c in zip(e.vars, e.coeffs):
                acc[v] = acc.get(v, 0) + m * c
        xs, cs = [], []
        for v, c in acc.items():
            if c != 0:
                xs.append(self.xs[v])
                cs.append(c)
        return xs, cs, const

    def add_expr_le(self, e1: ir.LinearExprIR, e2: ir.LinearExprIR,
                    enf: Sequence[int], slack: int = 0) -> None:
        """enf -> e1 + slack <= e2."""
        xs, cs, const = self._merge_expr([(e1, 1), (e2, -1)])
        self.s.add_linear(enf, xs, cs, None, -const - slack)

    # -- constraint compilation ---------------------------------------------
    def compile(self) -> None:
        m = self.model
        for idx, ct in enumerate(m.constraints):
            if ct.kind not in _SUPPORTED:
                raise _Unsupported(ct.kind)
            enf = [self.lit(l) for l in ct.enforcement_literals]
            neg_enf = [-e for e in enf]
            kind, a = ct.kind, ct.args
            if kind == "bool_or":
                self.s.add_clause(neg_enf + [self.lit(l)
                                             for l in a.literals])
            elif kind == "bool_and":
                for l in a.literals:
                    self.s.add_clause(neg_enf + [self.lit(l)])
            elif kind in ("at_most_one", "exactly_one"):
                lits = [self.lit(l) for l in a.literals]
                self._add_amo(lits, neg_enf)
                if kind == "exactly_one":
                    self.s.add_clause(neg_enf + lits)
            elif kind == "bool_xor":
                if enf:
                    raise _Unsupported("enforced bool_xor")
                self._add_xor([self.lit(l) for l in a.literals])
            elif kind == "linear":
                self._add_linear(a, enf, neg_enf)
            elif kind == "interval":
                self.intervals[idx] = (a.start, a.size, a.end, enf)
                # start + size == end under enforcement
                xs, cs, const = self._merge_expr(
                    [(a.start, 1), (a.size, 1), (a.end, -1)])
                self.s.add_linear(enf, xs, cs, -const, -const)
            elif kind == "no_overlap":
                self._add_no_overlap(a.intervals)
            elif kind == "no_overlap_2d":
                self._add_no_overlap_2d(a.x_intervals, a.y_intervals)
            elif kind == "lin_max":
                self._add_lin_max(a, enf, neg_enf)
            elif kind == "table":
                self._add_table(a, enf, neg_enf)
            elif kind == "element":
                self._add_element(a, enf, neg_enf)
            elif kind == "all_diff":
                self._add_all_diff(a.exprs, enf)
            elif kind == "cumulative":
                self._add_cumulative(a, enf)
            elif kind == "circuit":
                if enf:
                    raise _Unsupported("enforced circuit")
                self._add_circuit(a)
            elif kind == "inverse":
                if enf:
                    raise _Unsupported("enforced inverse")
                self._add_inverse(a)
            if self.s.infeasible:
                return

    def _add_circuit(self, a: "ir.CircuitArgs") -> None:
        """Circuit on the learning core via the MTZ order encoding
        (reference propagates circuit natively with SCC reasoning,
        ortools/sat/circuit.h:60; here degree rows + enforced
        Miller-Tucker-Zemlin rank differences keep the whole constraint
        inside clause learning — weaker per-node pruning, repaid by
        learned clauses + the LP/bound propagation the LCG core brings).

        Semantics (cp_model.proto CircuitConstraintProto): the true arcs
        must give every touched node in/out degree exactly one (a true
        self-loop means the node is skipped), and the non-skipped nodes
        must form ONE circuit."""
        arcs = list(zip(a.tails, a.heads, a.literals))
        nodes = sorted({t for t, _, _ in arcs} | {h for _, h, _ in arcs})
        if len(nodes) > _MAX_CIRCUIT_NODES or len(arcs) > _MAX_CIRCUIT_ARCS:
            raise _Unsupported("circuit too large for MTZ lowering")
        has_self = {t for t, h, _ in arcs if t == h}
        always_visited = [v for v in nodes if v not in has_self]
        if not always_visited:
            raise _Unsupported("circuit with every node optional")
        root = always_visited[0]
        out_l: Dict[int, List[int]] = {v: [] for v in nodes}
        in_l: Dict[int, List[int]] = {v: [] for v in nodes}
        for t, h, l in arcs:
            nl = self.lit(l)
            out_l[t].append(nl)
            in_l[h].append(nl)
        for v in nodes:
            for grp in (out_l[v], in_l[v]):
                self.s.add_clause(list(grp))
                self._add_amo(list(grp), [])
        n = len(nodes)
        u = {}
        for v in nodes:
            u[v] = (self.s.new_int(0, 0) if v == root
                    else self.s.new_int(1, n - 1))
        for t, h, l in arcs:
            if t == h or h == root:
                continue
            # arc true -> u[h] - u[t] >= 1 (no subtour avoids the root)
            self.s.add_linear([self.lit(l)], [u[h], u[t]], [1, -1],
                              1, None)

    def _add_inverse(self, a: "ir.InverseArgs") -> None:
        """Inverse (bijection channeling) on the learning core: aux
        bools t_ij = [f_direct[i] = j] tied to BOTH functions through
        bound-literal clauses (reference loads inverse natively,
        cp_model_loader.cc; here 6 clauses + one aux bool per pair)."""
        n = len(a.f_direct)
        if n != len(a.f_inverse):
            raise _Unsupported("inverse with mismatched lengths")
        if n > _MAX_INVERSE:
            raise _Unsupported("inverse too large for channeling")
        fd = [self.xs[v] for v in a.f_direct]
        fi = [self.xs[v] for v in a.f_inverse]
        # domains must live in [0, n)
        for v in list(a.f_direct) + list(a.f_inverse):
            d = self.model.variables[v].domain
            if d.min() < 0 or d.max() >= n:
                raise _Unsupported("inverse domain out of range")
        t = [[self.s.new_bool01() for _ in range(n)] for _ in range(n)]
        for i in range(n):
            for j in range(n):
                tl = self.s.ge(t[i][j], 1)
                # t -> f_d[i] = j ; ~t -> f_d[i] != j
                self.s.add_clause([-tl, self.s.ge(fd[i], j)])
                self.s.add_clause([-tl, self.s.le(fd[i], j)])
                self.s.add_clause([tl, self.s.le(fd[i], j - 1),
                                   self.s.ge(fd[i], j + 1)])
                # t -> f_inv[j] = i ; ~t -> f_inv[j] != i
                self.s.add_clause([-tl, self.s.ge(fi[j], i)])
                self.s.add_clause([-tl, self.s.le(fi[j], i)])
                self.s.add_clause([tl, self.s.le(fi[j], i - 1),
                                   self.s.ge(fi[j], i + 1)])
        for i in range(n):
            row = [self.s.ge(t[i][j], 1) for j in range(n)]
            col = [self.s.ge(t[j][i], 1) for j in range(n)]
            self.s.add_clause(list(row))
            self._add_amo(list(row), [])
            self.s.add_clause(list(col))
            self._add_amo(list(col), [])

    def _add_amo(self, lits: List[int], neg_enf: List[int]) -> None:
        n = len(lits)
        if n <= 1:
            return
        if n <= 10:
            for i in range(n):
                for j in range(i + 1, n):
                    self.s.add_clause(neg_enf + [-lits[i], -lits[j]])
            return
        # sequential encoding: s_i = OR(lits[:i+1])
        prev = None
        for i in range(n - 1):
            si = self.s.ge(self.s.new_bool01(), 1)
            self.s.add_clause(neg_enf + [-lits[i], si])
            if prev is not None:
                self.s.add_clause(neg_enf + [-prev, si])
                self.s.add_clause(neg_enf + [-lits[i], -prev])
            prev = si
        self.s.add_clause(neg_enf + [-lits[n - 1], -prev])

    def _add_xor(self, lits: List[int]) -> None:
        # chain: carry = parity of prefix; final parity must be 1
        carry = None  # literal for running parity
        for l in lits:
            if carry is None:
                carry = l
                continue
            nxt = self.s.ge(self.s.new_bool01(), 1)
            # nxt <-> carry XOR l
            self.s.add_clause([-nxt, carry, l])
            self.s.add_clause([-nxt, -carry, -l])
            self.s.add_clause([nxt, -carry, l])
            self.s.add_clause([nxt, carry, -l])
            carry = nxt
        if carry is None:
            self.s.infeasible = True  # XOR() == 1 unsatisfiable
        else:
            self.s.add_clause([carry])

    def _add_linear(self, a: ir.LinearArgs, enf: List[int],
                    neg_enf: List[int]) -> None:
        ivs = a.domain.intervals()
        xs = [self.xs[v] for v in a.vars]
        if len(ivs) == 1:
            lo, hi = ivs[0]
            self.s.add_linear(
                enf, xs, a.coeffs,
                None if lo <= -_BIG else lo,
                None if hi >= _BIG else hi)
            return
        # disjunctive domain: selector per interval, exactly-one
        sels = [self.s.ge(self.s.new_bool01(), 1) for _ in ivs]
        self.s.add_clause(neg_enf + sels)
        for sl, (lo, hi) in zip(sels, ivs):
            self.s.add_linear(
                enf + [sl], xs, a.coeffs,
                None if lo <= -_BIG else lo,
                None if hi >= _BIG else hi)

    def _add_no_overlap(self, interval_idx: List[int]) -> None:
        items = []
        for k in interval_idx:
            if k not in self.intervals:
                raise _Unsupported("no_overlap over missing interval")
            items.append(self.intervals[k])
        n = len(items)
        if n * (n - 1) // 2 > _MAX_PAIRS:
            raise _Unsupported("no_overlap too wide")
        for i in range(n):
            s_i, _, e_i, enf_i = items[i]
            for j in range(i + 1, n):
                s_j, _, e_j, enf_j = items[j]
                b = self.s.ge(self.s.new_bool01(), 1)
                both = enf_i + enf_j
                # b -> end_i <= start_j ; ¬b -> end_j <= start_i
                self.add_expr_le(e_i, s_j, both + [b])
                self.add_expr_le(e_j, s_i, both + [-b])

    def _add_no_overlap_2d(self, x_idx: List[int],
                           y_idx: List[int]) -> None:
        """Rectangles must separate on some axis: per pair, four
        half-reified precedences under a covering clause — the learning
        core's replacement for the O(n^2) big-M expansion
        (reference diffn.cc propagates; here the 4-way disjunction rides
        CDCL so separation decisions are LEARNED)."""
        boxes = []
        for kx, ky in zip(x_idx, y_idx):
            if kx not in self.intervals or ky not in self.intervals:
                raise _Unsupported("no_overlap_2d over missing interval")
            boxes.append((self.intervals[kx], self.intervals[ky]))
        n = len(boxes)
        if 4 * (n * (n - 1) // 2) > _MAX_PAIRS:
            raise _Unsupported("no_overlap_2d too wide")
        for i in range(n):
            (sx_i, _, ex_i, enf_xi), (sy_i, _, ey_i, enf_yi) = boxes[i]
            for j in range(i + 1, n):
                (sx_j, _, ex_j, enf_xj), (sy_j, _, ey_j, enf_yj) = \
                    boxes[j]
                both = enf_xi + enf_yi + enf_xj + enf_yj
                sels = [self.s.ge(self.s.new_bool01(), 1)
                        for _ in range(4)]
                self.s.add_clause([-e for e in both] + sels)
                self.add_expr_le(ex_i, sx_j, both + [sels[0]])  # i left
                self.add_expr_le(ex_j, sx_i, both + [sels[1]])  # i right
                self.add_expr_le(ey_i, sy_j, both + [sels[2]])  # i below
                self.add_expr_le(ey_j, sy_i, both + [sels[3]])  # i above

    def _add_expr_eq(self, e: ir.LinearExprIR, value: int,
                     enf: Sequence[int]) -> None:
        xs, cs, const = self._merge_expr([(e, 1)])
        self.s.add_linear(enf, xs, cs, value - const, value - const)

    def _eq_lit(self, e: ir.LinearExprIR, value: int) -> int:
        """External literal equivalent to expr == value (single positive
        unit-coefficient variable: conjunction of two bound literals via
        an aux; general exprs raise)."""
        if not e.vars:
            return TRUE_EXT if e.offset == value else FALSE_EXT
        if len(e.vars) == 1 and e.coeffs[0] == 1:
            x = self.xs[e.vars[0]]
            v = value - e.offset
            ge = self.s.ge(x, v)
            le = self.s.le(x, v)
            if ge in (TRUE_EXT, FALSE_EXT) or le in (TRUE_EXT, FALSE_EXT):
                if ge == FALSE_EXT or le == FALSE_EXT:
                    return FALSE_EXT
                return le if ge == TRUE_EXT else ge
            b = self.s.ge(self.s.new_bool01(), 1)
            self.s.add_clause([-b, ge])
            self.s.add_clause([-b, le])
            self.s.add_clause([b, -ge, -le])
            return b
        raise _Unsupported("eq literal on a general expression")

    def _add_table(self, a: ir.TableArgs, enf: List[int],
                   neg_enf: List[int]) -> None:
        """Positive table via tuple selectors (reference
        cp_model_expand.cc ExpandPositiveTable role, on the learning
        core); negative table as per-tuple blocking clauses."""
        width = len(a.exprs)
        if width * max(1, len(a.values)) > _MAX_TABLE_CELLS:
            raise _Unsupported("table too wide")
        doms = [v.domain for v in self.model.variables]
        if a.negated:
            # forbid each tuple: OR_i (expr_i != v_i)
            for tup in a.values:
                lits = []
                feasible = True
                for e, v in zip(a.exprs, tup):
                    eq = self._eq_lit(e, int(v))
                    if eq == TRUE_EXT:
                        continue  # this column always matches
                    if eq == FALSE_EXT:
                        feasible = False
                        break
                    lits.append(-eq)
                if not feasible:
                    continue  # tuple can never be taken: nothing to do
                self.s.add_clause(neg_enf + lits)
            return
        sels = []
        for tup in a.values:
            ok = all(ir.expr_domain(e, doms).contains(int(v))
                     for e, v in zip(a.exprs, tup))
            if not ok:
                continue
            b = self.s.ge(self.s.new_bool01(), 1)
            sels.append(b)
            for e, v in zip(a.exprs, tup):
                self._add_expr_eq(e, int(v), enf + [b])
        if not sels:
            for e in neg_enf:
                self.s.add_clause([e])
            if not neg_enf:
                self.s.infeasible = True
            return
        self.s.add_clause(neg_enf + sels)

    def _add_element(self, a: ir.ElementArgs, enf: List[int],
                     neg_enf: List[int]) -> None:
        """exprs[index] == target through index-value selectors (the
        element role of cp_model_expand.cc, on the learning core)."""
        doms = [v.domain for v in self.model.variables]
        idx_dom = ir.expr_domain(a.index, doms)
        if idx_dom.size() > 4096:
            raise _Unsupported("element index domain too large")
        vals = [v for lo, hi in idx_dom.intervals()
                for v in range(lo, hi + 1)]
        sels = []
        for k in vals:
            if not (0 <= k < len(a.exprs)):
                continue
            eq = self._eq_lit(a.index, int(k))
            if eq == FALSE_EXT:
                continue
            sels.append(eq)
            # eq -> target == exprs[k]
            xs, cs, const = self._merge_expr([(a.target, 1),
                                              (a.exprs[int(k)], -1)])
            e2 = enf + ([eq] if eq != TRUE_EXT else [])
            self.s.add_linear(e2, xs, cs, -const, -const)
        # index must take one of the valid positions
        live = [s for s in sels if s != TRUE_EXT]
        if len(live) == len(sels):
            self.s.add_clause(neg_enf + live)
        if not sels:
            for e in neg_enf:
                self.s.add_clause([e])
            if not neg_enf:
                self.s.infeasible = True

    def _add_lin_max(self, a: ir.LinMaxArgs, enf: List[int],
                     neg_enf: List[int]) -> None:
        # target >= each expr
        for e in a.exprs:
            self.add_expr_le(e, a.target, enf)
        # target <= some expr (selector disjunction)
        sels = [self.s.ge(self.s.new_bool01(), 1) for _ in a.exprs]
        self.s.add_clause(neg_enf + sels)
        for sl, e in zip(sels, a.exprs):
            self.add_expr_le(a.target, e, enf + [sl])

    def _add_all_diff(self, exprs: List[ir.LinearExprIR],
                      enf: List[int]) -> None:
        if len(exprs) > _MAX_ALLDIFF:
            raise _Unsupported("all_diff too wide")
        for i in range(len(exprs)):
            for j in range(i + 1, len(exprs)):
                b = self.s.ge(self.s.new_bool01(), 1)
                self.add_expr_le(exprs[i], exprs[j], enf + [b], slack=1)
                self.add_expr_le(exprs[j], exprs[i], enf + [-b], slack=1)

    def _add_cumulative(self, a: ir.CumulativeArgs,
                        enf: List[int]) -> None:
        if a.capacity.vars or any(d.vars for d in a.demands):
            raise _Unsupported("variable capacity/demand cumulative")
        cap = a.capacity.offset
        tasks = []  # (start expr, duration, demand, enf lits)
        doms = [v.domain for v in self.model.variables]
        t_min, t_max = None, None
        cells = 0
        for k, dem in zip(a.intervals, a.demands):
            if k not in self.intervals:
                raise _Unsupported("cumulative over missing interval")
            s_e, sz_e, e_e, ienf = self.intervals[k]
            if sz_e.vars:
                szd = ir.expr_domain(sz_e, doms)
                if szd.min() != szd.max():
                    raise _Unsupported("variable-size cumulative")
                dur = int(szd.min())
            else:
                dur = sz_e.offset
            if dem.offset == 0 or dur == 0:
                continue
            sd = ir.expr_domain(s_e, doms)
            lo, hi = int(sd.min()), int(sd.max())
            tasks.append((s_e, dur, dem.offset, ienf, lo, hi))
            cells += hi + dur - lo
            t_min = lo if t_min is None else min(t_min, lo)
            t_max = hi + dur if t_max is None else max(t_max, hi + dur)
        if not tasks:
            return
        if cells > _MAX_TIMEINDEX:
            raise _Unsupported("cumulative horizon too large")
        # time-indexed: b_{k,t} <-> task k runs at time t (given enforced)
        by_time: Dict[int, List[Tuple[int, int]]] = {}
        for s_e, dur, dem, ienf, lo, hi in tasks:
            if len(s_e.vars) != 1 or s_e.coeffs[0] != 1:
                raise _Unsupported("non-affine cumulative start")
            sx = self.xs[s_e.vars[0]]
            off = s_e.offset
            for t in range(lo, hi + dur):
                # runs at t  <=>  start <= t - off  AND  start >= t-dur+1-off
                u = self.s.ge(sx, t - dur + 1 - off)
                v = self.s.le(sx, t - off)
                bx = self.s.new_bool01()
                b = self.s.ge(bx, 1)
                ne = [-e for e in (enf + ienf)]
                self.s.add_clause([-b, u])
                self.s.add_clause([-b, v])
                self.s.add_clause(ne + [b, -u, -v])
                # an absent (unenforced) task never occupies capacity
                for e in enf + ienf:
                    self.s.add_clause([-b, e])
                by_time.setdefault(t, []).append((bx, dem))
        for t, terms in by_time.items():
            if sum(d for _, d in terms) <= cap:
                continue
            self.s.add_linear([], [x for x, _ in terms],
                              [d for _, d in terms], None, cap)

    def decode(self) -> List[int]:
        return [int(self.s.int_value(x)) for x in self.xs]


def compile_model(model: ir.CpModelIR) -> Optional[LcgProgram]:
    """Compile onto the LCG core; None when out of fragment."""
    try:
        prog = LcgProgram(model)
        prog.compile()
        # shared-clause scope: only literals over the deterministic
        # compile-time prefix cross workers — bools/ints created later
        # (worker-private objective vars, lazily created bound literals
        # translate by (var, bound) value, which is instance-independent)
        prog.s.set_export_limits(
            prog.s._lib.lcg_num_bools(prog.s._handle), prog.s.num_ints)
        return prog
    except _Unsupported:
        return None


# --------------------------------------------------------------------------
# solve entry (same contract as integer_encoding.solve_integer_cdcl)
# --------------------------------------------------------------------------

def solve_lcg(model: ir.CpModelIR, deadline: float, should_stop=None,
              conflict_chunk: int = 20_000,
              known_sum_lower_bound: Optional[int] = None,
              warm_values: Optional[List[int]] = None):
    """Solve a CpModelIR on the native LCG core.

    Returns None when the model is out of the fragment, else
    ``(status, values, bound, num_conflicts)`` with status 1 = solved
    (optimal when an objective is present), 0 = infeasible, -1 = unknown
    (``values`` may hold the best solution found; ``bound`` is the proven
    lower bound on sense*sum, minimization sense, no offset)."""
    obj = model.objective
    if time.perf_counter() > deadline or \
            (should_stop is not None and should_stop()):
        return None
    prog = compile_model(model)
    if prog is None:
        return None
    s = prog.s
    if s.infeasible:
        return 0, None, math.inf, 0

    sense = 1
    obj_x = None
    obj_lo = 0
    if obj is not None and obj.vars:
        sense = -1 if obj.maximize else 1
        merged: Dict[int, int] = {}
        for v, c in zip(obj.vars, obj.coeffs):
            merged[v] = merged.get(v, 0) + sense * c
        terms = [(v, c) for v, c in merged.items() if c != 0]
        if terms:
            doms = [v.domain for v in model.variables]
            lo = sum(min(c * doms[v].min(), c * doms[v].max())
                     for v, c in terms)
            hi = sum(max(c * doms[v].min(), c * doms[v].max())
                     for v, c in terms)
            if abs(int(lo)) > _BIG or abs(int(hi)) > _BIG:
                return None  # objective range too wide for the ladder
            obj_lo = int(lo)
            obj_x = s.new_int(int(lo), int(hi))
            s.add_linear([], [prog.xs[v] for v, _ in terms] + [obj_x],
                         [c for _, c in terms] + [-1], 0, 0)

    # hints seed lazy literal phases
    for v, h in model.solution_hint:
        if 0 <= v < prog.nvars:
            s.set_int_hint(prog.xs[v], h)

    assumptions = [prog.lit(l) for l in model.assumptions]

    def timed_solve(assump) -> int:
        while True:
            left = deadline - time.perf_counter()
            if left <= 0 or (should_stop is not None and should_stop()):
                return -1
            st = s.solve(assump, conflict_budget=conflict_chunk,
                         time_budget=max(0.05, left))
            if st != -1:
                return st

    st = timed_solve(assumptions)
    if st == UNSAT:
        return 0, None, math.inf, s.num_conflicts
    if st != SAT:
        return -1, None, -math.inf, s.num_conflicts
    values = prog.decode()
    if obj is None or obj_x is None:
        return 1, values, 0.0, s.num_conflicts

    def internal_obj(vals: List[int]) -> int:
        return sense * sum(c * vals[v]
                           for v, c in zip(obj.vars, obj.coeffs))

    best = values
    best_v = internal_obj(values)
    # verified warm start (e.g. a completed solution hint): the ladder
    # begins below the incumbent instead of at the first SAT point
    # (reference QuickSolveWithHint seeding, cp_model_solver.cc:1968)
    if warm_values is not None and len(warm_values) >= prog.nvars:
        wv = internal_obj(warm_values)
        if wv < best_v:
            best, best_v = list(warm_values[:prog.nvars]), wv
    lb = obj_lo
    if known_sum_lower_bound is not None:
        lb = max(lb, int(known_sum_lower_bound))
    while lb < best_v:
        if time.perf_counter() > deadline or \
                (should_stop is not None and should_stop()):
            return (-1, best, float(lb), s.num_conflicts)
        mid = (lb + best_v - 1) // 2
        a = s.le(obj_x, mid)
        if a == FALSE_EXT:
            lb = mid + 1
            continue
        extra = [] if a == TRUE_EXT else [a]
        st = timed_solve(assumptions + extra)
        if st == SAT:
            cand = prog.decode()
            cv = internal_obj(cand)
            if cv < best_v:
                best, best_v = cand, cv
        elif st == UNSAT:
            lb = mid + 1
        else:
            return (-1, best, float(lb), s.num_conflicts)
    return 1, best, float(best_v), s.num_conflicts
