"""LP/QP model IR (host side), the PyTorch port's own copy of
``ortools_tpu/models/lp.py`` (the port imports nothing of the JAX package).

Capability parity: ``ortools/pdlp/quadratic_program.h:126-132``
(QuadraticProgram) and ``ortools/lp_data/lp_data.h:56`` (LinearProgram),
merged into one host-side structure:

    min  objective_constant + c^T x + (1/2) x^T diag(q) x
    s.t. constraint_lower <= A x <= constraint_upper
         variable_lower   <=   x <= variable_upper

with equality rows expressed as constraint_lower == constraint_upper and
integrality flags for the MIP layer (the reference keeps integrality in
LinearProgram / MPModelProto rather than in pdlp's QP).

The host model uses numpy + scipy.sparse (CSR/CSC/COO accepted).  Device
solvers consume it via ``ortools_tpu_torch.ops.block_sparse.BlockSparseMatrix``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class QuadraticProgram:
    """min objective_constant + c·x + ½ x·diag(q)·x subject to two-sided
    constraint and variable bounds."""

    objective_vector: np.ndarray  # c, shape [n]
    constraint_matrix: sp.spmatrix  # A, shape [m, n]
    constraint_lower: np.ndarray  # shape [m], may be -inf
    constraint_upper: np.ndarray  # shape [m], may be +inf
    variable_lower: np.ndarray  # shape [n], may be -inf
    variable_upper: np.ndarray  # shape [n], may be +inf
    objective_constant: float = 0.0
    objective_matrix_diagonal: Optional[np.ndarray] = None  # q, shape [n]
    # The stored objective is always in the ORIGINAL sense; maximize=True
    # means callers should maximize it (as_minimization() negates).
    maximize: bool = False
    integrality: Optional[np.ndarray] = None  # bool, shape [n]
    variable_names: Optional[List[str]] = None
    constraint_names: Optional[List[str]] = None
    name: str = ""

    # ---- shape/consistency --------------------------------------------
    @property
    def num_variables(self) -> int:
        return int(self.constraint_matrix.shape[1])

    @property
    def num_constraints(self) -> int:
        return int(self.constraint_matrix.shape[0])

    @property
    def num_nonzeros(self) -> int:
        return int(self.constraint_matrix.nnz)

    def is_lp(self) -> bool:
        return self.objective_matrix_diagonal is None or not np.any(
            self.objective_matrix_diagonal
        )

    def validate(self) -> List[str]:
        """Return a list of validation errors (empty == valid).

        Mirrors the checks of ``pdlp/quadratic_program.h`` ValidateQuadraticProgramDimensions
        and ``linear_solver/model_validator.cc``: consistent dimensions, no
        NaNs, lower <= upper, finite objective, no infinite entries in A.
        """
        errs: List[str] = []
        m, n = self.constraint_matrix.shape
        if self.objective_vector.shape != (n,):
            errs.append(f"objective_vector shape {self.objective_vector.shape} != ({n},)")
        for arr, nm, sz in (
            (self.constraint_lower, "constraint_lower", m),
            (self.constraint_upper, "constraint_upper", m),
            (self.variable_lower, "variable_lower", n),
            (self.variable_upper, "variable_upper", n),
        ):
            if arr.shape != (sz,):
                errs.append(f"{nm} shape {arr.shape} != ({sz},)")
        if errs:
            return errs
        if np.any(np.isnan(self.objective_vector)):
            errs.append("NaN in objective_vector")
        if np.any(np.isinf(self.objective_vector)):
            errs.append("inf in objective_vector")
        data = self.constraint_matrix.tocoo().data
        if data.size and (np.any(np.isnan(data)) or np.any(np.isinf(data))):
            errs.append("NaN/inf in constraint_matrix")
        for lo, hi, nm in (
            (self.constraint_lower, self.constraint_upper, "constraint"),
            (self.variable_lower, self.variable_upper, "variable"),
        ):
            if np.any(np.isnan(lo)) or np.any(np.isnan(hi)):
                errs.append(f"NaN in {nm} bounds")
            elif np.any(lo > hi):
                bad = int(np.argmax(lo > hi))
                errs.append(f"{nm} bounds crossed at index {bad}: [{lo[bad]}, {hi[bad]}]")
            if np.any(lo == np.inf) or np.any(hi == -np.inf):
                errs.append(f"{nm} bound at wrong infinity")
        if self.objective_matrix_diagonal is not None:
            q = self.objective_matrix_diagonal
            if q.shape != (n,):
                errs.append(f"objective_matrix_diagonal shape {q.shape} != ({n},)")
            elif np.any(q < 0):
                errs.append("objective_matrix_diagonal has negative entries (non-convex)")
        return errs

    # ---- transforms ----------------------------------------------------
    def as_minimization(self) -> "QuadraticProgram":
        """Return an equivalent minimization problem (negate if maximize)."""
        if not self.maximize:
            return self
        return dataclasses.replace(
            self,
            objective_vector=-self.objective_vector,
            objective_constant=-self.objective_constant,
            maximize=False,
        )

    def objective_value(self, x: np.ndarray) -> float:
        v = self.objective_constant + float(self.objective_vector @ x)
        if self.objective_matrix_diagonal is not None:
            v += 0.5 * float(self.objective_matrix_diagonal @ (x * x))
        return v

    def transpose_matrix(self) -> sp.csr_matrix:
        return sp.csr_matrix(self.constraint_matrix.T)


def random_lp(
    m: int,
    n: int,
    density: float = 0.01,
    seed: int = 0,
    ensure_feasible: bool = True,
    dtype=np.float64,
) -> QuadraticProgram:
    """Generate a random sparse LP with a known feasible point.

    Used by tests and benchmarks (the reference generates canned fixtures in
    pdlp/test_util.h; we generate structured random ones instead).
    Constraints: A x <= b with b = A x0 + margin, bounds 0 <= x <= 10.
    """
    rng = np.random.default_rng(seed)
    nnz = max(m, min(m * n, int(density * m * n)))
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    a = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    a.sum_duplicates()
    x0 = rng.uniform(0.0, 5.0, size=n).astype(dtype)
    b = a @ x0
    if ensure_feasible:
        b = b + rng.uniform(0.1, 1.0, size=m).astype(dtype)
    c = rng.standard_normal(n).astype(dtype)
    return QuadraticProgram(
        objective_vector=c,
        constraint_matrix=a,
        constraint_lower=np.full(m, -np.inf, dtype=dtype),
        constraint_upper=b.astype(dtype),
        variable_lower=np.zeros(n, dtype=dtype),
        variable_upper=np.full(n, 10.0, dtype=dtype),
        name=f"random_lp_{m}x{n}",
    )
