"""Bin packing, the PyTorch port of ``ortools_tpu/packing/bin_packing.py``.

Capability parity: ``ortools/packing`` (vector_bin_packing +
arc_flow_solver) scoped to round 1: 1-D bin packing with a first-fit-
decreasing heuristic and an exact assignment-MIP model through the
framework's own B&B (the reference's arc-flow MIP formulation is a
round-2 upgrade).  The MIP runs on ``device``, the card by default.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class BinPackingInstance:
    capacity: int
    sizes: List[int]

    @property
    def num_items(self) -> int:
        return len(self.sizes)

    def lower_bound(self) -> int:
        return int(np.ceil(sum(self.sizes) / self.capacity))


def first_fit_decreasing(instance: BinPackingInstance) -> List[List[int]]:
    order = np.argsort(-np.asarray(instance.sizes))
    bins: List[List[int]] = []
    loads: List[int] = []
    for i in order:
        size = instance.sizes[i]
        placed = False
        for b in range(len(bins)):
            if loads[b] + size <= instance.capacity:
                bins[b].append(int(i))
                loads[b] += size
                placed = True
                break
        if not placed:
            bins.append([int(i)])
            loads.append(size)
    return bins


def solve_bin_packing(instance: BinPackingInstance,
                      max_bins: Optional[int] = None, *, device="cuda",
                      **kw) -> Optional[List[List[int]]]:
    """Exact minimum-bin packing via assignment MIP: x[i,b] item->bin,
    y[b] bin used; minimize sum y.  The MIP runs on ``device``; ``kw``
    goes to ``MipParams``."""
    from ortools_tpu_torch.mip import MipParams, solve as mip_solve
    from ortools_tpu_torch.utils.device import lp_dtype, resolve_device
    from ortools_tpu_torch.utils.status import MPSolverStatus

    from ortools_tpu_torch.models.lp import QuadraticProgram

    device = resolve_device(device)
    n = instance.num_items
    ffd = first_fit_decreasing(instance)
    ub_bins = len(ffd)
    if max_bins is None:
        max_bins = ub_bins
    if ub_bins == instance.lower_bound():
        return ffd  # FFD already optimal
    b_cnt = max_bins
    nx = n * b_cnt
    rows, cols, vals = [], [], []
    r = 0
    cl, cu = [], []
    # each item in exactly one bin
    for i in range(n):
        for b in range(b_cnt):
            rows.append(r)
            cols.append(i * b_cnt + b)
            vals.append(1.0)
        cl.append(1.0)
        cu.append(1.0)
        r += 1
    # capacity: sum_i size_i x[i,b] - C y[b] <= 0
    for b in range(b_cnt):
        for i in range(n):
            rows.append(r)
            cols.append(i * b_cnt + b)
            vals.append(float(instance.sizes[i]))
        rows.append(r)
        cols.append(nx + b)
        vals.append(-float(instance.capacity))
        cl.append(-np.inf)
        cu.append(0.0)
        r += 1
    # symmetry breaking: y[b] >= y[b+1]
    for b in range(b_cnt - 1):
        rows.extend([r, r])
        cols.extend([nx + b, nx + b + 1])
        vals.extend([1.0, -1.0])
        cl.append(0.0)
        cu.append(np.inf)
        r += 1
    c = np.concatenate([np.zeros(nx), np.ones(b_cnt)])
    qp = QuadraticProgram(
        objective_vector=c,
        constraint_matrix=sp.csr_matrix(
            (vals, (rows, cols)), shape=(r, nx + b_cnt)
        ),
        constraint_lower=np.asarray(cl),
        constraint_upper=np.asarray(cu),
        variable_lower=np.zeros(nx + b_cnt),
        variable_upper=np.ones(nx + b_cnt),
        integrality=np.ones(nx + b_cnt, dtype=bool),
    )
    res = mip_solve(qp, MipParams(**kw), device=device,
                    lp_dtype=lp_dtype(device))
    if res.status not in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE):
        return None
    bins: List[List[int]] = [[] for _ in range(b_cnt)]
    for i in range(n):
        for b in range(b_cnt):
            if res.solution[i * b_cnt + b] > 0.5:
                bins[b].append(i)
                break
    return [b for b in bins if b]
