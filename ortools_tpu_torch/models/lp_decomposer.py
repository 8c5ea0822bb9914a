"""LP decomposition into independent blocks.

Capability parity: ``ortools/lp_data/lp_decomposer.{h,cc}`` — split an LP
whose variable/constraint incidence graph is disconnected into independent
sub-LPs (used by the reference's BOP to solve blocks separately).  Here the
components come from one scipy connected-components pass over the
bipartite incidence graph, and solutions are recombined positionally.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from ortools_tpu_torch.models.lp import QuadraticProgram


@dataclasses.dataclass
class LpDecomposition:
    blocks: List[QuadraticProgram]
    var_maps: List[np.ndarray]  # block k's columns -> original columns
    row_maps: List[np.ndarray]
    num_variables: int
    num_constraints: int

    def assemble_solution(self, xs: List[np.ndarray]) -> np.ndarray:
        x = np.zeros(self.num_variables)
        for vm, xk in zip(self.var_maps, xs):
            x[vm] = xk
        return x

    def assemble_duals(self, ys: List[np.ndarray]) -> np.ndarray:
        y = np.zeros(self.num_constraints)
        for rm, yk in zip(self.row_maps, ys):
            y[rm] = yk
        return y


def decompose(qp: QuadraticProgram) -> LpDecomposition:
    """Split into independent blocks (>= 1; a connected LP returns itself).

    Variables not touching any constraint form one extra box-only block.
    """
    m, n = qp.num_constraints, qp.num_variables
    a = sp.csr_matrix(qp.constraint_matrix)
    # bipartite graph: nodes = rows [0, m) and cols [m, m + n)
    coo = a.tocoo()
    g = sp.coo_matrix(
        (np.ones(len(coo.data)), (coo.row, m + coo.col)),
        shape=(m + n, m + n),
    )
    ncomp, labels = connected_components(g, directed=False)
    row_labels = labels[:m]
    col_labels = labels[m:]
    # components with at least one column become blocks; empty-column
    # components (isolated rows) keep their rows in the first block that
    # exists — an isolated row has no entries and is feasibility-checked
    # by any solver as 0 in [cl, cu].
    blocks: List[QuadraticProgram] = []
    var_maps: List[np.ndarray] = []
    row_maps: List[np.ndarray] = []
    comp_of_cols = np.unique(col_labels) if n else np.zeros(0, dtype=int)
    for comp in comp_of_cols:
        cols = np.nonzero(col_labels == comp)[0]
        rows = np.nonzero(row_labels == comp)[0]
        sub = sp.csr_matrix(a[np.ix_(rows, cols)]) if len(rows) else \
            sp.csr_matrix((0, len(cols)))
        blocks.append(QuadraticProgram(
            objective_vector=qp.objective_vector[cols],
            constraint_matrix=sub,
            constraint_lower=qp.constraint_lower[rows],
            constraint_upper=qp.constraint_upper[rows],
            variable_lower=qp.variable_lower[cols],
            variable_upper=qp.variable_upper[cols],
            objective_matrix_diagonal=(
                qp.objective_matrix_diagonal[cols]
                if qp.objective_matrix_diagonal is not None else None),
            integrality=(np.asarray(qp.integrality)[cols]
                         if qp.integrality is not None else None),
            maximize=qp.maximize,
            name=f"{qp.name}_block{len(blocks)}",
        ))
        var_maps.append(cols)
        row_maps.append(rows)
    return LpDecomposition(blocks, var_maps, row_maps, n, m)
