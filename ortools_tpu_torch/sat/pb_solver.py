"""Pseudo-Boolean solver with cutting-planes conflict analysis.

Capability parity: ``ortools/sat/pb_constraint.h:526``
(``ResolvePBConflict`` — PB conflicts learn PB constraints via
cutting-planes resolution, not clauses).  The native core
(``_native/pbsat.cc``) implements a division-based calculus in the style
of RoundingSat: counter propagation over saturated >=-constraints,
weaken + ceil-divide at the resolution pivot, saturating addition, and a
1UIP clause fallback under coefficient-overflow pressure.  Counting
families (pigeonhole OPB) that defeat clause learning close in
polynomially many conflicts here.

Soundness contract: every SAT model the native core reports is
re-verified in numpy against the ORIGINAL constraints before being
returned (A.9 runtime-verification contract); optimization incumbents
come only from verified models, and OPTIMAL is claimed only when the
strengthened cutoff comes back UNSAT.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ortools_tpu_torch._native.build import load_library

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library("pbsat")
        c = ctypes
        sigs = [
            ("pb_new", c.c_void_p, [c.c_int]),
            ("pb_free", None, [c.c_void_p]),
            ("pb_add", c.c_int,
             [c.c_void_p, c.c_int, c.POINTER(c.c_longlong),
              c.POINTER(c.c_int32), c.c_longlong]),
            ("pb_solve", c.c_int,
             [c.c_void_p, c.c_longlong, c.POINTER(c.c_int8)]),
            ("pb_conflicts", c.c_longlong, [c.c_void_p]),
            ("pb_propagations", c.c_longlong, [c.c_void_p]),
            ("pb_learned", c.c_longlong, [c.c_void_p]),
            ("pb_clause_fallbacks", c.c_longlong, [c.c_void_p]),
            ("pb_set_overflow_guard", None, [c.c_void_p, c.c_longlong]),
        ]
        for name, res, args in sigs:
            f = getattr(lib, name)
            f.restype = res
            f.argtypes = args
        _LIB = lib
    return _LIB


@dataclasses.dataclass
class PbConstraint:
    """sum coefs[i] * lit(lits[i]) >= degree over 0/1 variables, where
    literal +v means x_v and -v-1 ... — here lits are encoded as
    (var, negated) pairs for clarity."""

    coefs: np.ndarray  # int64
    vars: np.ndarray  # int32 variable indices
    negated: np.ndarray  # bool per term
    degree: int


def _lit(v: int, neg: bool) -> int:
    return 2 * int(v) + (1 if neg else 0)


class PbSolver:
    """One PB instance; supports incremental constraint adds (the
    optimization loop adds objective cutoffs between solves)."""

    def __init__(self, n_vars: int):
        self.n = int(n_vars)
        self._h = _lib().pb_new(self.n)
        self._cons: List[PbConstraint] = []
        self._root_unsat = False

    def __del__(self):
        try:
            _lib().pb_free(self._h)
        except Exception:
            pass

    def add_geq(self, coefs: Sequence[int], vars_: Sequence[int],
                negated: Sequence[bool], degree: int) -> None:
        """Add sum coefs[i]*lit_i >= degree (lit_i = ~x when negated)."""
        coefs = np.ascontiguousarray(coefs, dtype=np.int64)
        vars_ = np.ascontiguousarray(vars_, dtype=np.int64)
        negated = np.ascontiguousarray(negated, dtype=bool)
        self._cons.append(PbConstraint(coefs, vars_.astype(np.int32),
                                       negated, int(degree)))
        lits = np.ascontiguousarray(
            2 * vars_ + negated.astype(np.int64), dtype=np.int32)
        c = ctypes
        r = _lib().pb_add(
            self._h, len(coefs),
            coefs.ctypes.data_as(c.POINTER(c.c_longlong)),
            lits.ctypes.data_as(c.POINTER(c.c_int32)),
            int(degree))
        if r != 0:
            self._root_unsat = True

    def add_leq(self, coefs, vars_, negated, bound: int) -> None:
        """sum coefs[i]*lit_i <= bound  ==  sum -coefs * lit >= -bound."""
        self.add_geq([-int(x) for x in coefs], vars_, negated, -int(bound))

    def add_eq(self, coefs, vars_, negated, rhs: int) -> None:
        self.add_geq(coefs, vars_, negated, rhs)
        self.add_leq(coefs, vars_, negated, rhs)

    def _verify(self, model: np.ndarray) -> bool:
        for pc in self._cons:
            litval = np.where(pc.negated, 1 - model[pc.vars],
                              model[pc.vars])
            if int(pc.coefs @ litval) < pc.degree:
                return False
        return True

    def solve(self, conflict_budget: int = 10**9,
              ) -> Tuple[str, Optional[np.ndarray]]:
        """Returns ("SAT", model) / ("UNSAT", None) / ("UNKNOWN", None).
        SAT models are numpy-verified against the original rows."""
        if self._root_unsat:
            return "UNSAT", None
        out = np.zeros(self.n, dtype=np.int8)
        c = ctypes
        st = _lib().pb_solve(self._h, int(conflict_budget),
                             out.ctypes.data_as(c.POINTER(c.c_int8)))
        if st == 10:
            model = out.astype(np.int64)
            if not self._verify(model):
                # native bug shield: never report an unverified model
                return "UNKNOWN", None
            return "SAT", model
        if st == 20:
            return "UNSAT", None
        return "UNKNOWN", None

    def set_overflow_guard(self, guard: int) -> None:
        """Test hook: lower the cutting-planes coefficient guard so the
        clause-analysis fallback path gets exercised."""
        _lib().pb_set_overflow_guard(self._h, int(guard))

    @property
    def num_conflicts(self) -> int:
        return int(_lib().pb_conflicts(self._h))

    @property
    def num_pb_learned(self) -> int:
        return int(_lib().pb_learned(self._h))

    @property
    def num_clause_fallbacks(self) -> int:
        return int(_lib().pb_clause_fallbacks(self._h))


def minimize(solver: PbSolver, obj_coefs: Sequence[int],
             obj_vars: Sequence[int],
             deadline: float = math.inf,
             conflict_budget_per_call: int = 50_000,
             should_stop=None,
             ) -> Tuple[str, Optional[np.ndarray], float]:
    """Solution-improving search: minimize sum obj_coefs * x[obj_vars]
    by repeatedly adding the PB cutoff  obj <= incumbent - 1.

    Returns (status, best_model, best_objective): status "OPTIMAL" when
    the strengthened cutoff proves UNSAT, "FEASIBLE" on
    deadline/budget, "UNSAT"/"UNKNOWN" otherwise."""
    obj_coefs = np.asarray(obj_coefs, dtype=np.int64)
    obj_vars = np.asarray(obj_vars, dtype=np.int64)
    best = None
    best_obj = math.inf
    while time.perf_counter() < deadline and not (
            should_stop is not None and should_stop()):
        st, model = solver.solve(conflict_budget_per_call)
        if st == "SAT":
            val = int(obj_coefs @ model[obj_vars])
            if val < best_obj:
                best, best_obj = model, val
            # cutoff: obj <= best-1
            solver.add_leq(obj_coefs.tolist(), obj_vars.tolist(),
                           [False] * len(obj_vars), best_obj - 1)
        elif st == "UNSAT":
            if best is None:
                return "UNSAT", None, math.inf
            return "OPTIMAL", best, float(best_obj)
        else:
            break
    if best is None:
        return "UNKNOWN", None, math.inf
    return "FEASIBLE", best, float(best_obj)


def pigeonhole(n_holes: int) -> PbSolver:
    """PHP(n+1, n) as PB rows: per-pigeon sum_h x[p,h] >= 1, per-hole
    sum_p x[p,h] <= 1.  UNSAT; exponential for clause learning,
    polynomial for cutting planes — the canonical separation."""
    p, h = n_holes + 1, n_holes
    s = PbSolver(p * h)
    for i in range(p):
        vs = [i * h + j for j in range(h)]
        s.add_geq([1] * h, vs, [False] * h, 1)
    for j in range(h):
        vs = [i * h + j for i in range(p)]
        s.add_leq([1] * p, vs, [False] * p, 1)
    return s
