"""ctypes wrapper over the native CDCL SAT core (_native/cdcl.cc).

Capability parity: the Python face of the reference's SatSolver
(ortools/sat/sat_solver.h:63) — incremental clause addition, solving under
assumptions with failed-assumption cores, conflict budgets, model access.
Literals are DIMACS-style signed integers (+-(var+1)); variable indices
are 0-based on the Python side.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ortools_tpu_torch._native.build import load_library

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library("cdcl")
        lib.cdcl_new.restype = ctypes.c_void_p
        lib.cdcl_new.argtypes = [ctypes.c_int32]
        lib.cdcl_free.argtypes = [ctypes.c_void_p]
        lib.cdcl_new_var.restype = ctypes.c_int32
        lib.cdcl_new_var.argtypes = [ctypes.c_void_p]
        lib.cdcl_num_vars.restype = ctypes.c_int32
        lib.cdcl_num_vars.argtypes = [ctypes.c_void_p]
        lib.cdcl_add_clause.restype = ctypes.c_int32
        lib.cdcl_add_clause.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32
        ]
        lib.cdcl_add_clauses.restype = ctypes.c_int32
        lib.cdcl_add_clauses.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
        ]
        lib.cdcl_solve.restype = ctypes.c_int32
        lib.cdcl_solve.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int64,
        ]
        lib.cdcl_get_model.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8)
        ]
        lib.cdcl_get_core.restype = ctypes.c_int32
        lib.cdcl_get_core.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
        ]
        lib.cdcl_set_phases.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8), ctypes.c_int32
        ]
        lib.cdcl_enable_proof.argtypes = [ctypes.c_void_p]
        lib.cdcl_set_inprocessing.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int32]
        lib.cdcl_num_vivified.restype = ctypes.c_int64
        lib.cdcl_num_vivified.argtypes = [ctypes.c_void_p]
        lib.cdcl_num_otf_subsumed.restype = ctypes.c_int64
        lib.cdcl_num_otf_subsumed.argtypes = [ctypes.c_void_p]
        lib.cdcl_proof_size.restype = ctypes.c_int64
        lib.cdcl_proof_size.argtypes = [ctypes.c_void_p]
        lib.cdcl_get_proof.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
        ]
        lib.cdcl_num_conflicts.restype = ctypes.c_int64
        lib.cdcl_num_conflicts.argtypes = [ctypes.c_void_p]
        lib.cdcl_num_propagations.restype = ctypes.c_int64
        lib.cdcl_num_propagations.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


SAT = 1
UNSAT = 0
UNKNOWN = -1


class CdclSolver:
    """Incremental CDCL solver over the native core."""

    def __init__(self, num_vars: int = 0, proof: bool = False):
        self._lib = _lib()
        self._handle = ctypes.c_void_p(self._lib.cdcl_new(num_vars))
        self._num_assumptions = 0
        self._proof = proof
        if proof:
            self._lib.cdcl_enable_proof(self._handle)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.cdcl_free(self._handle)
                self._handle = None
        except Exception:
            pass

    # -- model building ---------------------------------------------------
    def new_var(self) -> int:
        return int(self._lib.cdcl_new_var(self._handle))

    @property
    def num_vars(self) -> int:
        return int(self._lib.cdcl_num_vars(self._handle))

    def add_clause(self, lits: Sequence[int]) -> bool:
        """lits: signed DIMACS literals over 0-based vars, i.e. +-(v+1).
        Returns False once the formula is UNSAT at level zero."""
        arr = (ctypes.c_int32 * len(lits))(*lits)
        return self._lib.cdcl_add_clause(self._handle, arr, len(lits)) == 0

    def add_clauses(self, clauses: Iterable[Sequence[int]]) -> bool:
        ok = True
        for c in clauses:
            ok = self.add_clause(c) and ok
        return ok

    def add_clauses_flat(self, flat: np.ndarray) -> bool:
        """Bulk-add clauses from a 0-terminated int32 array (DIMACS body
        layout) — orders of magnitude faster than per-clause ctypes calls
        for large encodings."""
        flat = np.ascontiguousarray(flat, dtype=np.int32)
        ptr = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        return self._lib.cdcl_add_clauses(
            self._handle, ptr, ctypes.c_int64(len(flat))
        ) == 0

    # convenience encodings
    def add_at_most_one(self, lits: Sequence[int]) -> bool:
        """Pairwise for small n, sequential (ladder) encoding for large."""
        n = len(lits)
        ok = True
        if n <= 5:
            for i in range(n):
                for j in range(i + 1, n):
                    ok = self.add_clause([-lits[i], -lits[j]]) and ok
            return ok
        # sequential: s_i means "one of lits[0..i] is true"
        s_prev = None
        for i, l in enumerate(lits):
            if i == n - 1:
                if s_prev is not None:
                    ok = self.add_clause([-s_prev, -l]) and ok
                break
            s = self.new_var() + 1
            ok = self.add_clause([-l, s]) and ok
            if s_prev is not None:
                ok = self.add_clause([-s_prev, s]) and ok
                ok = self.add_clause([-s_prev, -l]) and ok
            s_prev = s
        return ok

    def set_phases(self, values: Sequence[int]) -> None:
        """Seed the saved phases (hint-guided value ordering; reference
        sat_decision.h SetAssignmentPreference): values[v] = 1 prefer
        true, 0 prefer false, -1 keep the default."""
        arr = (ctypes.c_int8 * len(values))(*[int(v) for v in values])
        self._lib.cdcl_set_phases(self._handle, arr, len(values))

    # -- solving ----------------------------------------------------------
    def solve(self, assumptions: Sequence[int] = (),
              conflict_budget: int = 0) -> int:
        """Returns SAT (1), UNSAT (0) or UNKNOWN (-1, budget exhausted).
        conflict_budget <= 0 means unlimited."""
        arr = (ctypes.c_int32 * len(assumptions))(*assumptions)
        self._num_assumptions = len(assumptions)
        return int(self._lib.cdcl_solve(
            self._handle, arr, len(assumptions), conflict_budget
        ))

    def model(self) -> np.ndarray:
        """Boolean assignment after SAT (index = variable)."""
        n = self.num_vars
        buf = (ctypes.c_int8 * n)()
        self._lib.cdcl_get_model(self._handle, buf)
        return np.ctypeslib.as_array(buf).astype(bool).copy()

    def core(self) -> List[int]:
        """Failed-assumption literals after UNSAT-under-assumptions."""
        buf = (ctypes.c_int32 * max(1, self._num_assumptions + 1))()
        n = self._lib.cdcl_get_core(self._handle, buf)
        return [int(buf[i]) for i in range(n)]

    def proof(self) -> List:
        """DRAT proof events: ("a"|"d", [ext_lits]) in emission order
        (reference sat/drat_writer.h).  Requires proof=True."""
        sz = int(self._lib.cdcl_proof_size(self._handle))
        buf = (ctypes.c_int32 * max(1, sz))()
        if sz:
            self._lib.cdcl_get_proof(self._handle, buf)
        out = []
        i = 0
        while i < sz:
            n = buf[i]
            i += 1
            kind = "d" if n < 0 else "a"
            k = abs(n)
            out.append((kind, [int(buf[i + t]) for t in range(k)]))
            i += k
        return out

    def write_drat(self, path: str) -> None:
        """Write the recorded proof in textual DRAT format."""
        with open(path, "w") as f:
            for kind, lits in self.proof():
                prefix = "d " if kind == "d" else ""
                f.write(prefix + " ".join(map(str, lits)) + " 0\n")

    def set_inprocessing(self, on: bool) -> None:
        """Toggle restart-time vivification + deferred OTF-subsumption
        deletions (reference sat_inprocessing.h:160-210); on by
        default — the toggle exists for measured comparisons."""
        self._lib.cdcl_set_inprocessing(self._handle, 1 if on else 0)

    @property
    def num_vivified(self) -> int:
        return int(self._lib.cdcl_num_vivified(self._handle))

    @property
    def num_otf_subsumed(self) -> int:
        return int(self._lib.cdcl_num_otf_subsumed(self._handle))

    @property
    def num_conflicts(self) -> int:
        return int(self._lib.cdcl_num_conflicts(self._handle))

    @property
    def num_propagations(self) -> int:
        return int(self._lib.cdcl_num_propagations(self._handle))


def solve_dimacs(path: str, conflict_budget: int = 0):
    """Solve a DIMACS CNF file; returns (status, model | None)."""
    nvars = 0
    clauses: List[List[int]] = []
    with open(path) as f:
        cur: List[int] = []
        for line in f:
            line = line.strip()
            if not line or line.startswith(("c", "%")):
                continue
            if line.startswith("p"):
                parts = line.split()
                nvars = int(parts[2])
                continue
            for tok in line.split():
                v = int(tok)
                if v == 0:
                    clauses.append(cur)
                    cur = []
                else:
                    cur.append(v)
        if cur:
            clauses.append(cur)
    s = CdclSolver(nvars)
    for c in clauses:
        if not s.add_clause(c):
            return UNSAT, None
    status = s.solve(conflict_budget=conflict_budget)
    return status, (s.model() if status == SAT else None)
