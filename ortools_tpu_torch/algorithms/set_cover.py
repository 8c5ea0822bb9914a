"""Set cover, the PyTorch port of ``ortools_tpu/algorithms/set_cover.py``.

Capability parity: ``ortools/algorithms/set_cover_model.h:67`` (SetCoverModel)
with the greedy + steepest-descent improvement strategies of
``set_cover.{h,cc}``; exact solves route to the MIP layer, on the card by
default.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp


class SetCoverModel:
    def __init__(self) -> None:
        self.costs: List[float] = []
        self.subsets: List[List[int]] = []

    def add_empty_subset(self, cost: float) -> int:
        self.costs.append(float(cost))
        self.subsets.append([])
        return len(self.costs) - 1

    AddEmptySubset = add_empty_subset

    def add_element_to_last_subset(self, element: int) -> None:
        self.subsets[-1].append(int(element))

    AddElementToLastSubset = add_element_to_last_subset

    @property
    def num_elements(self) -> int:
        return 1 + max((e for s in self.subsets for e in s), default=-1)

    @property
    def num_subsets(self) -> int:
        return len(self.subsets)


def greedy_set_cover(model: SetCoverModel) -> Optional[List[int]]:
    """Classic ln(n)-approximation greedy; None if uncoverable."""
    n_el = model.num_elements
    uncovered = set(range(n_el))
    chosen: List[int] = []
    subsets = [set(s) for s in model.subsets]
    while uncovered:
        best, best_score = -1, float("inf")
        for j, s in enumerate(subsets):
            gain = len(s & uncovered)
            if gain == 0:
                continue
            score = model.costs[j] / gain
            if score < best_score:
                best, best_score = j, score
        if best < 0:
            return None
        chosen.append(best)
        uncovered -= subsets[best]
    return chosen


def solve_set_cover_mip(model: SetCoverModel, *, device="cuda",
                        **kw) -> Optional[List[int]]:
    """Exact set cover via the batched B&B MIP layer on ``device``."""
    from ortools_tpu_torch.mip import MipParams, solve as mip_solve
    from ortools_tpu_torch.models.lp import QuadraticProgram
    from ortools_tpu_torch.utils.device import lp_dtype, resolve_device
    from ortools_tpu_torch.utils.status import MPSolverStatus

    n_el = model.num_elements
    n_sub = model.num_subsets
    rows, cols = [], []
    for j, s in enumerate(model.subsets):
        for e in s:
            rows.append(e)
            cols.append(j)
    a = sp.csr_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n_el, n_sub)
    )
    qp = QuadraticProgram(
        objective_vector=np.asarray(model.costs, dtype=np.float64),
        constraint_matrix=a,
        constraint_lower=np.ones(n_el),
        constraint_upper=np.full(n_el, np.inf),
        variable_lower=np.zeros(n_sub),
        variable_upper=np.ones(n_sub),
        integrality=np.ones(n_sub, dtype=bool),
    )
    device = resolve_device(device)
    r = mip_solve(qp, MipParams(**kw), device=device,
                  lp_dtype=lp_dtype(device))
    if r.status not in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE):
        return None
    return [j for j in range(n_sub) if r.solution[j] > 0.5]
