"""Node-LP backends for the batched branch-and-bound (port of
``ortools_tpu/mip/node_lp.py``).

``PdhgNodeBackend`` solves B node LPs together by batched PDHG
(``pdlp/batched.py``): every product is a block SpMM on the card.  The
JAX module's ``SimplexNodeBackend`` and ``choose_backend`` need the simplex
and the native core; they come with the port of the branch-and-bound.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.pdlp.batched import BatchSolver
from ortools_tpu_torch.pdlp.params import PdhgParams


@dataclasses.dataclass
class NodeLpResult:
    """Per-node LP results (leading axis = node). Mirrors the
    pdlp.batched.BatchSolveResult fields the B&B consumes."""
    primal_solution: np.ndarray
    dual_solution: np.ndarray
    # Valid lower bound on each node LP (exact Lagrangian dual value for
    # PDHG) — safe to prune on.
    dual_bound: np.ndarray
    primal_infeasible: np.ndarray  # bool — certified infeasible
    optimal: np.ndarray  # bool — LP solved to optimality
    skipped: np.ndarray  # bool — not attempted (deadline); re-enqueue as-is


class PdhgNodeBackend:
    """Batched-PDHG node LPs at one static batch shape.

    The backend keeps one ``BatchSolver`` across its calls: the scaled
    problem, σ_max, and the majors with their buffers and captured CUDA
    graphs, which hold for a fixed batch size B.  A short batch is
    therefore padded by repeating its first node, so that every call runs
    on the same graphs and a second call captures nothing.  The
    branch-and-bound raises ``iteration_limit`` for a batch that holds a
    retried node; only the host loop reads it, so a call whose
    ``lp_params`` differ from the solver's in ``iteration_limit`` alone
    keeps the solver and passes the limit to it.  A call with other
    ``lp_params`` builds a new solver.  ``device`` and ``v0`` (the
    power-iteration start) are those of ``solve_batch``."""

    name = "pdhg"

    def __init__(self, qp_min: QuadraticProgram, lp_params: PdhgParams,
                 batch_size: int, device="cuda", v0=None):
        self.qp = qp_min
        self.lp_params = lp_params
        self.batch_size = batch_size
        self.device = device
        self.v0 = v0
        self._solver: Optional[BatchSolver] = None

    def _solver_for(self, params: PdhgParams) -> BatchSolver:
        """The kept solver, unless ``params`` differ from its params in
        more than ``iteration_limit``."""
        kept = None if self._solver is None else self._solver.params
        if kept is None or dataclasses.replace(
                params, iteration_limit=kept.iteration_limit) != kept:
            self._solver = BatchSolver(self.qp, params, self.batch_size,
                                       device=self.device, v0=self.v0)
        return self._solver

    def solve(self, lbs, ubs, warm_x=None, warm_y=None, lp_params=None,
              deadline: float = math.inf) -> NodeLpResult:
        n_real = lbs.shape[0]
        pad = self.batch_size - n_real

        def padded(v):
            if v is None or pad <= 0:
                return v
            return np.concatenate([v, np.repeat(v[:1], pad, axis=0)])

        params = lp_params or self.lp_params
        solver = self._solver_for(params)
        res = solver.solve(padded(lbs), padded(ubs), padded(warm_x),
                           padded(warm_y), deadline,
                           iteration_limit=params.iteration_limit)
        return NodeLpResult(
            primal_solution=res.primal_solution[:n_real],
            dual_solution=res.dual_solution[:n_real],
            dual_bound=res.dual_bound[:n_real],
            primal_infeasible=res.primal_infeasible[:n_real],
            optimal=res.optimal[:n_real],
            skipped=np.zeros(n_real, dtype=bool),
        )
