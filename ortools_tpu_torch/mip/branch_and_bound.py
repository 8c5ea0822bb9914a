"""Batched branch-and-bound MIP solver (port of
``ortools_tpu/mip/branch_and_bound.py``).

Capability parity: the reference's MIP path (CP-SAT with an LP relaxation,
``ortools/sat/linear_programming_constraint.*`` + integer search), re-designed
per SURVEY §7 Phase 3 for an accelerator:

- node LP relaxations are bounded by *batched* PDHG — B&B nodes differ from
  the root only in variable bounds, so up to ``node_batch_size`` node LPs
  advance simultaneously in one batched major on the card
  (pdlp/batched.py), warm started from their parents;
- vectorized interval bound propagation at every node (mip/propagation.py)
  replaces watch-list propagation;
- the frontier + incumbent live on the host (the analogue of the
  reference's SharedTreeManager / SharedResponseManager, work_assignment.h
  and synchronization.h) with best-bound node selection;
- every incumbent is re-verified against the original model before being
  accepted (the reference's solution-checker contract, SURVEY §4.5).

Round 2 adds the reference's two tree-size levers:

- root cutting planes (mip/cuts.py: single-row MIR + knapsack covers, the
  ``ortools/sat/cuts.cc`` roles) — appended as ordinary rows so every node
  LP in every batch is strengthened by the same block-sparse SpMM;
- pseudo-cost branching (``ortools/sat/pseudo_costs.h``): per-variable
  up/down objective-gain statistics harvested from the batched node LP
  bounds, product-rule selection, most-fractional fallback until a
  variable is reliable.

The port follows the JAX module line for line apart from two parts that
read JAX there:

- the node LPs' dtype, which the JAX module takes from its x64 flag, is
  the ``lp_dtype`` keyword of ``solve`` (float32 by default, as JAX's
  default on an accelerator), with the same eps rule (1e-7 in float64,
  1e-6 in float32);
- ``solve`` runs on ``device`` ("cuda" by default; it raises where there
  is no card unless the caller asks for "cpu").  Every node-LP backend,
  every sub-MIP and the root device feasibility jump run there, and
  ``device_fj="auto"`` engages the device FJ where ``device`` is a card
  (the JAX module asks for a TPU).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ortools_tpu_torch.mip.cuts import append_cuts, generate_cuts
from ortools_tpu_torch.mip.heuristics import (
    binary_toggle_ls,
    detect_independent_set,
    fj_objective_descent,
    one_two_exchange,
    rc_neighborhood,
    wis_ils,
    greedy_cover,
    ils_polish,
    lp_dive,
    round_and_repair,
)
from ortools_tpu_torch.mip.node_lp import SimplexNodeBackend, choose_backend
from ortools_tpu_torch.mip.propagation import propagate_bounds
from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.pdlp.params import PdhgParams
from ortools_tpu_torch.utils.device import resolve_device
from ortools_tpu_torch.utils.status import MPSolverStatus


@dataclasses.dataclass
class MipParams:
    max_nodes: int = 100_000
    node_batch_size: int = 64
    time_limit_sec: float = math.inf
    rel_gap: float = 1e-4
    abs_gap: float = 1e-6
    integrality_tol: float = 1e-5
    feasibility_tol: float = 1e-6
    lp_params: Optional[PdhgParams] = None
    verbosity: int = 0
    # called with (x, objective_in_original_sense_min_form) on every NEW
    # incumbent (reference math_opt callback.proto MIP_SOLUTION event)
    new_incumbent_callback: object = None
    # Node-LP backend: "auto" | "simplex" | "pdhg" (mip/node_lp.py).
    # Auto routes small pure-LP models to warm-started dual-simplex
    # re-solves (the reference's node-LP design,
    # linear_programming_constraint.h:442) and large ones to batched PDHG.
    node_lp: str = "auto"
    # Best-bound nodes popped per round on the simplex backend (kept small
    # so the frontier stays fresh; PDHG uses node_batch_size).
    simplex_batch_size: int = 8
    # LP-guided diving (mip/heuristics.py::lp_dive) on backends with cheap
    # re-solves; run at the root and every `dive_interval` batches.
    dive_interval: int = 8
    # Cut-and-branch (simplex backend only): every `tree_cut_interval`
    # batches, separate globally-valid cuts at the current best-bound
    # node's LP point and append them (reference: in-tree cut generation,
    # linear_programming_constraint.cc).  0 disables.
    tree_cut_interval: int = 16
    max_tree_cuts: int = 200
    # Feasibility-jump objective descent at the root (pure-integer
    # bounded models; reference FeasibilityJumpSolver).  0 disables.
    fj_root_seconds: float = 8.0
    # RINS sub-MIPs (reference sat/rins.h): every `rins_interval` batches,
    # fix the integers where the node LP agrees with the incumbent and
    # solve the reduced MIP with a small budget.  0 disables.
    rins_interval: int = 24
    rins_max_nodes: int = 400
    rins_time_limit_sec: float = 5.0
    # Local branching (Fischetti-Lodi; reference cp_model_lns.h
    # LocalBranchingLpBasedNeighborhoodGenerator): solve the sub-MIP
    # restricted to the Hamming ball of radius k around the incumbent's
    # binaries.  0 disables.
    local_branching_interval: int = 36
    local_branching_k: int = 12
    local_branching_max_nodes: int = 5000
    local_branching_time_limit_sec: float = 14.0
    # VNS escalation (variable neighborhood search around the incumbent,
    # Hansen-Mladenovic; reference role: the LNS ladder of
    # cp_model_lns.h): when a Hamming ball is solved to PROVEN
    # optimality without improving, enlarge k by `vns_k_step` up to
    # `vns_k_max` instead of stopping; any improvement recenters and
    # resets k.  Unproven no-improvement stops the loop.
    local_branching_vns: bool = True
    vns_k_start: int = 8
    vns_k_step: int = 4
    vns_k_max: int = 16
    vns_time_share: float = 0.6  # of the remaining budget per invocation
    # Root cutting planes (mip/cuts.py).
    cut_rounds: int = 5
    max_cuts_per_round: int = 100
    # Pseudo-cost branching; falls back to most-fractional while a
    # variable has no observations (reliability 1).
    use_pseudo_costs: bool = True
    # Reliability branching (Achterberg-Koch-Martin; reference role
    # sat/pseudo_costs.h + strong branching in integer_search.cc): on the
    # simplex backend, candidates whose pseudo-costs have fewer than
    # `sb_reliability` observations per direction get their two child LPs
    # actually solved (cheap warm dual-simplex re-solves) and the measured
    # gains initialize the pseudo-costs.  0 disables.
    sb_reliability: int = 4
    sb_max_candidates: int = 8
    sb_node_limit: int = 2000
    # Warm start: a candidate solution tried as the first incumbent
    # (re-verified by the feasibility checker like every incumbent);
    # the warm-start pattern of LNS/local-branching sub-solves.
    initial_solution: Optional[np.ndarray] = None
    # Device feasibility jump (sat/fj_device.py — multi-seed FJ in
    # objective-descent mode) as a root heuristic on pure-binary models:
    # "auto" engages only when the solve's device is a card (on the CPU
    # the numpy FJ path is faster); "on"/"off" force it.
    device_fj: str = "auto"
    device_fj_seconds: float = 10.0


@dataclasses.dataclass
class MipResult:
    status: MPSolverStatus
    solution: np.ndarray
    objective_value: float
    best_bound: float
    num_nodes: int
    wall_time_sec: float


@dataclasses.dataclass(order=True)
class _Node:
    bound: float
    seq: int
    lb: np.ndarray = dataclasses.field(compare=False)
    ub: np.ndarray = dataclasses.field(compare=False)
    warm_x: Optional[np.ndarray] = dataclasses.field(compare=False, default=None)
    warm_y: Optional[np.ndarray] = dataclasses.field(compare=False, default=None)
    retries: int = dataclasses.field(compare=False, default=0)
    # Branching provenance for pseudo-cost updates: this node was created
    # by branching variable `branch_var` in direction `branch_dir`
    # (-1 down / +1 up) at parent LP fraction `branch_frac`.
    branch_var: int = dataclasses.field(compare=False, default=-1)
    branch_dir: int = dataclasses.field(compare=False, default=0)
    branch_frac: float = dataclasses.field(compare=False, default=0.0)


class _PseudoCosts:
    """Per-variable up/down objective-gain averages
    (reference ortools/sat/pseudo_costs.h, recast as numpy arrays)."""

    def __init__(self, n: int):
        self.sum_dn = np.zeros(n)
        self.cnt_dn = np.zeros(n, dtype=np.int64)
        self.sum_up = np.zeros(n)
        self.cnt_up = np.zeros(n, dtype=np.int64)

    def update(self, node: "_Node", child_bound: float) -> None:
        j, d = node.branch_var, node.branch_dir
        if j < 0 or d == 0 or not math.isfinite(child_bound) \
                or not math.isfinite(node.bound):
            return
        gain = max(child_bound - node.bound, 0.0)
        if d < 0:
            frac = max(node.branch_frac, 1e-6)
            self.sum_dn[j] += gain / frac
            self.cnt_dn[j] += 1
        else:
            frac = max(1.0 - node.branch_frac, 1e-6)
            self.sum_up[j] += gain / frac
            self.cnt_up[j] += 1

    def observe(self, j: int, d: int, gain: float, frac: float) -> None:
        """Record a directly measured child-LP gain (strong branching)."""
        if not math.isfinite(gain):
            return
        if d < 0:
            self.sum_dn[j] += gain / max(frac, 1e-6)
            self.cnt_dn[j] += 1
        else:
            self.sum_up[j] += gain / max(1.0 - frac, 1e-6)
            self.cnt_up[j] += 1

    def select(self, cand: np.ndarray, frac: np.ndarray) -> int:
        """Product-rule selection among candidate vars with fractions."""
        init_dn = self.cnt_dn[cand] > 0
        init_up = self.cnt_up[cand] > 0
        avg_dn = (self.sum_dn[cand[init_dn]]
                  / self.cnt_dn[cand[init_dn]]).mean() if init_dn.any() else 1.0
        avg_up = (self.sum_up[cand[init_up]]
                  / self.cnt_up[cand[init_up]]).mean() if init_up.any() else 1.0
        pc_dn = np.where(init_dn,
                         self.sum_dn[cand] / np.maximum(self.cnt_dn[cand], 1),
                         avg_dn)
        pc_up = np.where(init_up,
                         self.sum_up[cand] / np.maximum(self.cnt_up[cand], 1),
                         avg_up)
        score = np.maximum(pc_dn * frac, 1e-9) * np.maximum(
            pc_up * (1.0 - frac), 1e-9)
        return int(np.argmax(score))


def _check_feasible(qp: QuadraticProgram, x: np.ndarray, tol: float) -> bool:
    """Solution checker: verify x against the ORIGINAL model (runtime
    self-verification contract, reference cp_model_solver.cc:4376)."""
    ax = qp.constraint_matrix @ x
    scale = 1.0 + np.maximum(
        np.abs(qp.constraint_lower, where=np.isfinite(qp.constraint_lower),
               out=np.zeros_like(ax)),
        np.abs(qp.constraint_upper, where=np.isfinite(qp.constraint_upper),
               out=np.zeros_like(ax)),
    )
    if np.any(ax < qp.constraint_lower - tol * scale):
        return False
    if np.any(ax > qp.constraint_upper + tol * scale):
        return False
    if np.any(x < qp.variable_lower - tol) or np.any(x > qp.variable_upper + tol):
        return False
    return True


def solve(qp: QuadraticProgram, params: Optional[MipParams] = None,
          *, device="cuda", lp_dtype: torch.dtype = torch.float32,
          **kw) -> MipResult:
    device = resolve_device(device)
    params = params or MipParams(**kw)
    start = time.perf_counter()
    qp_min = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0
    n = qp_min.num_variables
    integrality = (
        np.asarray(qp_min.integrality, dtype=bool)
        if qp_min.integrality is not None
        else np.zeros(n, dtype=bool)
    )
    int_idx = np.nonzero(integrality)[0]
    a = sp.csr_matrix(qp_min.constraint_matrix)

    lp_params = params.lp_params or PdhgParams(
        dtype=lp_dtype,
        eps_optimal_absolute=1e-7 if lp_dtype == torch.float64 else 1e-6,
        eps_optimal_relative=1e-7 if lp_dtype == torch.float64 else 1e-6,
        iteration_limit=50_000,
    )

    # Root propagation.
    lb0, ub0, feasible = propagate_bounds(
        a, qp_min.constraint_lower, qp_min.constraint_upper,
        qp_min.variable_lower, qp_min.variable_upper, integrality,
    )
    if not feasible:
        return MipResult(MPSolverStatus.INFEASIBLE, np.zeros(n), math.nan,
                         math.inf, 0, time.perf_counter() - start)

    incumbent_x: Optional[np.ndarray] = None
    incumbent_obj = math.inf
    seq = 0
    num_nodes = 0
    num_batches = 0
    num_tree_cuts = 0
    last_improve_batch = 0
    rins_seen: set = set()
    ils_rng = np.random.default_rng(12345)
    status = MPSolverStatus.NOT_SOLVED
    had_inexact_nodes = False  # nodes dropped without an exactness proof
    dropped_bound = math.inf  # best bound among dropped nodes

    def gap_closed(bound: float) -> bool:
        if incumbent_x is None:
            return False
        return incumbent_obj - bound <= params.abs_gap + params.rel_gap * (
            1.0 + abs(incumbent_obj)
        )

    def try_incumbent(x_cand: np.ndarray) -> None:
        nonlocal incumbent_x, incumbent_obj
        x_r = np.array(x_cand)
        x_r[int_idx] = np.round(x_r[int_idx])
        x_r = np.clip(x_r, qp_min.variable_lower, qp_min.variable_upper)
        if not _check_feasible(qp_min, x_r, params.feasibility_tol):
            return
        obj = qp_min.objective_value(x_r)
        if obj < incumbent_obj - 1e-12:
            incumbent_obj = obj
            incumbent_x = x_r
            if params.new_incumbent_callback is not None:
                params.new_incumbent_callback(np.array(x_r), float(obj))

    if params.initial_solution is not None:
        try_incumbent(np.asarray(params.initial_solution, dtype=np.float64))

    heur_seen: set = set()

    pump_done = [False]

    def run_heuristics(x_lp: np.ndarray) -> None:
        """LP-guided rounding + repair + 1-opt (mip/heuristics.py); every
        candidate goes through the same checker as any incumbent."""
        if not len(int_idx):
            return
        reopt = (backend.resolve_raw
                 if isinstance(backend, SimplexNodeBackend) else None)
        for cand in round_and_repair(qp_min, x_lp, int_idx, reopt=reopt,
                                     seen=heur_seen):
            try_incumbent(cand)
        if not pump_done[0] and incumbent_x is None:
            # alternating-projection feasibility pump (reference
            # sat/feasibility_pump.h), once, when rounding found nothing
            pump_done[0] = True
            from ortools_tpu_torch.mip.heuristics import feasibility_pump

            for cand in feasibility_pump(
                    qp_min, int_idx, x_lp,
                    deadline=start + 0.4 * params.time_limit_sec):
                try_incumbent(cand)

    def run_rins(x_lp: np.ndarray) -> None:
        """RINS (reference sat/rins.{h,cc}): fix integers where the node
        LP agrees with the incumbent, solve the reduced MIP briefly."""
        if incumbent_x is None or not len(int_idx):
            return
        remaining = params.time_limit_sec - (time.perf_counter() - start)
        if remaining < 1.0:
            return
        agree = int_idx[np.abs(x_lp[int_idx] - incumbent_x[int_idx]) <= 1e-6]
        n_free = len(int_idx) - len(agree)
        if n_free < 5 or n_free > 250 or len(agree) == 0:
            return
        # don't re-explore an identical neighborhood
        fp = (incumbent_obj, agree.tobytes(),
              incumbent_x[agree].tobytes())
        if fp in rins_seen:
            return
        rins_seen.add(fp)
        lbr = np.array(qp_min.variable_lower)
        ubr = np.array(qp_min.variable_upper)
        lbr[agree] = incumbent_x[agree]
        ubr[agree] = incumbent_x[agree]
        sub_params = dataclasses.replace(
            params,
            max_nodes=params.rins_max_nodes,
            time_limit_sec=min(params.rins_time_limit_sec, remaining),
            cut_rounds=0, rins_interval=0, tree_cut_interval=0,
            device_fj="off",
            local_branching_interval=0, fj_root_seconds=0.0,
            verbosity=0,
        )
        sub_qp = dataclasses.replace(qp_min, variable_lower=lbr,
                                     variable_upper=ubr)
        r = solve(sub_qp, sub_params, device=device,
                  lp_dtype=lp_dtype)
        if r.status in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE):
            try_incumbent(r.solution)

    lb_seen: set = set()
    # Diverse verified solutions worth exploring as VNS centers (filled
    # by the structure-detected heuristics; different greedy basins lead
    # the ball ladders to different optima).
    center_pool: List[np.ndarray] = []

    def run_local_branching() -> None:
        """Local branching (Fischetti-Lodi 2003) with VNS escalation
        (Hansen-Mladenovic): add the Hamming-ball row
        sum_{x*=0} x_j + sum_{x*=1} (1 - x_j) <= k around a center's
        binaries and solve the sub-MIP; RECENTER on improvement (k
        resets), ENLARGE k when the ball is solved to proven optimality
        without improvement, stop after two unproven misses.  Ladders run
        around the incumbent first, then around diverse heuristic covers
        (center_pool) — different basins reach different optima.  Any
        solution of the restriction is feasible for the original
        problem, and every candidate passes try_incumbent's checker."""
        if incumbent_x is None:
            return
        if not params.local_branching_vns:
            for _ in range(3):
                before = incumbent_obj
                _local_branching_once(incumbent_x,
                                      params.local_branching_k)
                if incumbent_x is None or before == incumbent_obj:
                    return
            return
        loop_deadline = min(
            start + params.time_limit_sec,
            time.perf_counter() + params.vns_time_share * max(
                params.time_limit_sec - (time.perf_counter() - start), 0.0))
        centers = [incumbent_x]
        for c in center_pool:
            if not any(np.array_equal(c, e) for e in centers):
                centers.append(c)
        centers = centers[:4]
        # proportional budget split so a fruitless first ladder cannot
        # starve the other basins
        for idx, center in enumerate(centers):
            now = time.perf_counter()
            if now > loop_deadline - 4.0:
                return
            share = (loop_deadline - now) / (len(centers) - idx)
            _vns_ladder(center, min(loop_deadline, now + max(share, 16.0)),
                        loop_deadline)

    def _vns_ladder(center: np.ndarray, soft_deadline: float,
                    hard_deadline: float) -> None:
        """One ball ladder.  `soft_deadline` is this ladder's fair share
        of the VNS budget; a ladder that keeps improving earns
        extensions up to `hard_deadline` (a walk in progress beats
        starting over from a worse basin)."""
        cen = center
        cen_obj = qp_min.objective_value(cen)
        if params.verbosity >= 1:
            print(f"vns ladder: center obj={cen_obj:.6f} "
                  f"t={time.perf_counter() - start:.1f}s")
        k = params.vns_k_start
        fails = 0
        while (time.perf_counter() < soft_deadline - 2.0
               and k <= params.vns_k_max):
            st, sol, obj = _local_branching_once(cen, k, hard_deadline)
            if st is None:
                return
            if sol is not None and obj < cen_obj - 1e-12:
                cen, cen_obj = sol, obj  # walk the ladder's own chain
                k = params.vns_k_start
                fails = 0
                soft_deadline = min(
                    hard_deadline,
                    max(soft_deadline, time.perf_counter() + 32.0))
            elif st == MPSolverStatus.OPTIMAL:
                k += params.vns_k_step  # proven empty ball: widen
            else:
                # unproven and no improvement: tolerate one miss (the
                # wider ball often contains an improving solution found
                # quickly even without a proof), then stop
                fails += 1
                if fails >= 2:
                    return
                k += params.vns_k_step

    def _local_branching_once(center: np.ndarray, k: int,
                              loop_deadline: float = math.inf):
        """Solve one Hamming-ball sub-MIP around `center`.  Returns
        (status, solution, objective) — solution/objective from the
        sub-solve when feasible, else (status, None, inf); (None, None,
        inf) when skipped."""
        none3 = (None, None, math.inf)
        if center is None or not len(int_idx):
            return none3
        remaining = min(
            params.time_limit_sec - (time.perf_counter() - start),
            loop_deadline - time.perf_counter())
        if remaining < 1.0:
            return none3
        lbv, ubv = qp_min.variable_lower, qp_min.variable_upper
        bin_idx = int_idx[(lbv[int_idx] >= -1e-9)
                          & (ubv[int_idx] <= 1.0 + 1e-9)]
        if len(bin_idx) < 10:
            return none3
        fp = (k, center[bin_idx].tobytes())
        if fp in lb_seen:
            return none3
        lb_seen.add(fp)
        ones = center[bin_idx] >= 0.5
        coeffs = np.where(ones, -1.0, 1.0)
        rhs = float(k) - float(ones.sum())
        row = sp.csr_matrix(
            (coeffs, (np.zeros(len(bin_idx), dtype=int), bin_idx)),
            shape=(1, qp_min.num_variables))
        sub_qp = dataclasses.replace(
            qp_min,
            constraint_matrix=sp.vstack(
                [sp.csr_matrix(qp_min.constraint_matrix), row],
                format="csr"),
            constraint_lower=np.concatenate(
                [qp_min.constraint_lower, [-np.inf]]),
            constraint_upper=np.concatenate(
                [qp_min.constraint_upper, [rhs]]),
            constraint_names=None,
        )
        # wider balls earn proportionally more time (a k=12 proof costs
        # more nodes than a k=8 one, and proofs are what drive the VNS
        # ladder onward)
        ball_budget = params.local_branching_time_limit_sec * max(
            1.0, k / max(params.vns_k_start, 1))
        sub_params = dataclasses.replace(
            params,
            max_nodes=params.local_branching_max_nodes,
            time_limit_sec=min(ball_budget, remaining),
            cut_rounds=2, rins_interval=0, tree_cut_interval=0,
            device_fj="off",
            local_branching_interval=0, fj_root_seconds=0.0,
            verbosity=0,
            initial_solution=center,  # don't rediscover the center
        )
        r = solve(sub_qp, sub_params, device=device,
                  lp_dtype=lp_dtype)
        sol = None
        obj = math.inf
        if r.status in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE):
            try_incumbent(r.solution)
            sol = r.solution
            obj = float(r.objective_value)
        if params.verbosity >= 1:
            print(f"local branching k={k}: {r.status.name} "
                  f"obj={r.objective_value:.6f} nodes={r.num_nodes} "
                  f"t={time.perf_counter() - start:.1f}s")
        return r.status, sol, obj

    def run_dive(x_lp: np.ndarray, lb_d: np.ndarray, ub_d: np.ndarray
                 ) -> None:
        """LP-guided dive (cheap-resolve backends only)."""
        if not len(int_idx) or not isinstance(backend, SimplexNodeBackend):
            return
        remaining = params.time_limit_sec - (time.perf_counter() - start)
        if remaining < 1.0:
            return
        cand = lp_dive(backend, a, qp_min.constraint_lower,
                       qp_min.constraint_upper, x_lp, lb_d, ub_d,
                       int_idx, integrality,
                       integrality_tol=params.integrality_tol,
                       deadline=time.perf_counter()
                       + max(1.0, 0.15 * remaining))
        if cand is not None:
            try_incumbent(cand)

    # ---- root LP + cutting-plane rounds --------------------------------
    # Cuts are globally valid rows appended to qp_min; every later node LP
    # (and the propagator) sees them.  Reference roles: sat/cuts.cc MIR +
    # cover cuts generated at the root LP relaxation.
    root_bound = -math.inf
    root_warm_x = root_warm_y = None
    num_cuts = 0
    backend = choose_backend(qp_min, lp_params, params.node_batch_size,
                             params.node_lp, device=device)
    # Greedy covering incumbent (reference set_cover.h greedy) for
    # >=-structured binary models: a strong first incumbent lets root
    # cuts and pruning bite from the start.
    if len(int_idx):
        gc = greedy_cover(qp_min, int_idx)
        if gc is not None:
            try_incumbent(gc)
    # Structure-detected primal engine: pure independent-set models get
    # an iterated-greedy + (1,2)-swap local search (the portfolio-LS role
    # specialized to packing structure), run BEFORE the cut loop — on
    # these models the primal is the hard side; re-verified as always.
    if len(int_idx) and params.fj_root_seconds > 0:
        wis = detect_independent_set(qp_min)
        if wis is not None:
            adj_w, w_w = wis
            wis_deadline = min(
                start + 0.5 * params.time_limit_sec,
                time.perf_counter() + 40.0)
            try_incumbent(wis_ils(adj_w, w_w, wis_deadline))
        # pure weighted set covering: iterated-greedy destroy/rebuild
        # (reference set_cover.h greedy + improvement role); verified by
        # try_incumbent as always
        from ortools_tpu_torch.mip.heuristics import (detect_set_cover,
                                                      sc_iterated_greedy)

        sc = detect_set_cover(qp_min)
        if sc is not None:
            rows_of_col, cols_of_row, sc_cost = sc
            # two independent greedy seeds: different random restarts
            # land in different basins, and basin diversity is what the
            # VNS ladders below need (a single cover's k<=16 ball can be
            # provably empty while another basin walks to the optimum)
            for sc_seed in (0, 1):
                sc_deadline = min(
                    start + 0.25 * params.time_limit_sec,
                    time.perf_counter() + 10.0)
                sx_cand = sc_iterated_greedy(rows_of_col, cols_of_row,
                                             sc_cost, sc_deadline,
                                             seed=sc_seed)
                if sx_cand is not None:
                    try_incumbent(sx_cand)
                    center_pool.append(
                        np.asarray(sx_cand, dtype=np.float64))
            # CFT-style Lagrangian cover: one more basin
            # (mip/heuristics.py::sc_lagrangian)
            from ortools_tpu_torch.mip.heuristics import sc_lagrangian

            lx_cand, _sc_elites = sc_lagrangian(
                rows_of_col, cols_of_row, sc_cost,
                min(start + 0.3 * params.time_limit_sec,
                    time.perf_counter() + 5.0))
            if lx_cand is not None:
                try_incumbent(lx_cand)
                center_pool.append(np.asarray(lx_cand, dtype=np.float64))

    if len(int_idx) and params.cut_rounds > 0:
        # snapshot of the state before the latest append, for rolling
        # back cut rounds that do not move the root bound (reference
        # linear_constraint_manager.cc keeps only "efficient" cuts; rows
        # that buy no bound slow every node LP for nothing)
        last_append = None  # (qp_min, a, backend, num_cuts, bound_before)
        for _ in range(params.cut_rounds + 1):
            if time.perf_counter() - start > 0.5 * params.time_limit_sec:
                break  # leave at least half the budget to the tree
            res0 = backend.solve(
                lb0[None], ub0[None],
                deadline=start + 0.6 * params.time_limit_sec)
            num_nodes += 1
            if res0.primal_infeasible[0]:
                return MipResult(MPSolverStatus.INFEASIBLE, np.zeros(n),
                                 math.nan, math.inf, num_nodes,
                                 time.perf_counter() - start)
            x_root = res0.primal_solution[0]
            if last_append is not None and res0.optimal[0]:
                gain = float(res0.dual_bound[0]) - last_append[4]
                if gain <= 1e-7 * max(1.0, abs(last_append[4])):
                    # the appended rows bought no bound: drop them and
                    # run the tree on the leaner LP
                    qp_min, a, backend, num_cuts = last_append[:4]
                    root_warm_y = None
                    break
            root_bound = max(root_bound, float(res0.dual_bound[0]))
            root_warm_x, root_warm_y = x_root, res0.dual_solution[0]
            try_incumbent(x_root)
            run_heuristics(x_root)
            run_dive(x_root, lb0, ub0)
            if num_cuts >= params.cut_rounds * params.max_cuts_per_round:
                break
            frac0 = (np.abs(x_root[int_idx] - np.round(x_root[int_idx]))
                     if len(int_idx) else np.zeros(0))
            if frac0.size == 0 or frac0.max() <= params.integrality_tol:
                break  # root already integral — no cut target
            # zero-half stays off here: measured on the battery, the
            # separator fires on NONE of the open instances (mknap,
            # fixed_charge, set_cover_400) and on set_cover_150 its 26
            # dependent rows slow every node LP 3x for a 0.19 bound gain
            # the 96-node tree never needed.  The separator itself is
            # correct, unit-tested, and available via enable_zero_half.
            pool = generate_cuts(
                a, qp_min.constraint_lower, qp_min.constraint_upper,
                lb0, ub0, integrality, x_root,
                max_cuts=params.max_cuts_per_round,
            )
            if pool is None:
                break
            last_append = (qp_min, a, backend, num_cuts,
                           float(res0.dual_bound[0]))
            qp_min = append_cuts(qp_min, pool)
            a = sp.csr_matrix(qp_min.constraint_matrix)
            num_cuts += pool.num_cuts
            root_warm_y = None  # dual dimension changed
            backend = choose_backend(qp_min, lp_params,
                                     params.node_batch_size, params.node_lp,
                                     device=device)
            # Cuts can tighten propagation too.
            lb0, ub0, feasible = propagate_bounds(
                a, qp_min.constraint_lower, qp_min.constraint_upper,
                lb0, ub0, integrality, max_rounds=3,
            )
            if not feasible:
                return MipResult(MPSolverStatus.INFEASIBLE, np.zeros(n),
                                 math.nan, math.inf, num_nodes,
                                 time.perf_counter() - start)
        if params.verbosity >= 1 and num_cuts:
            print(f"root cuts: {num_cuts} rows appended, "
                  f"root bound {root_bound:.6f}")

    # Root feasibility-jump objective descent (reference portfolio's
    # FeasibilityJumpSolver, sat/feasibility_jump.h:48): pure-integer
    # bounded models only; every result re-verified by try_incumbent.
    if len(int_idx) and params.fj_root_seconds > 0:
        # budget scales with the instance: tiny models close faster
        # through the tree than through local search
        fj_budget = min(params.fj_root_seconds,
                        0.1 * params.time_limit_sec,
                        0.02 * max(len(int_idx), 50))
        fj_deadline = min(
            start + params.time_limit_sec,
            time.perf_counter() + fj_budget)
        fx = fj_objective_descent(qp_min, incumbent_x, incumbent_obj,
                                  fj_deadline, bound=root_bound)
        if fx is not None:
            try_incumbent(fx)
        if incumbent_x is not None:
            ex = one_two_exchange(
                qp_min, incumbent_x, params.feasibility_tol,
                deadline=min(start + params.time_limit_sec,
                             time.perf_counter() + 0.5 * params.fj_root_seconds))
            if ex is not None:
                try_incumbent(ex)
        # Reduced-cost neighborhood sub-MIP at the root (LNS around the
        # LP's marginal variables; reference cp_model_lns.h RINS/RENS
        # family).  Budgeted like RINS; results re-verified as always.
        if (incumbent_x is not None and root_warm_y is not None
                and params.rins_interval
                and len(int_idx) == n
                and time.perf_counter() - start
                < 0.6 * params.time_limit_sec):
            nb = rc_neighborhood(qp_min, incumbent_x, root_warm_y, int_idx)
            if nb is not None:
                lbr, ubr = nb
                sub_params = dataclasses.replace(
                    params,
                    max_nodes=4000,
                    time_limit_sec=min(
                        12.0,
                        params.time_limit_sec
                        - (time.perf_counter() - start)),
                    cut_rounds=2, rins_interval=0, tree_cut_interval=0,
            device_fj="off",
                    local_branching_interval=0, fj_root_seconds=0.0,
                    verbosity=0,
                )
                sub_qp = dataclasses.replace(
                    qp_min, variable_lower=lbr, variable_upper=ubr)
                rsub = solve(sub_qp, sub_params, device=device,
                             lp_dtype=lp_dtype)
                if rsub.status in (MPSolverStatus.OPTIMAL,
                                   MPSolverStatus.FEASIBLE):
                    try_incumbent(rsub.solution)

    # Device feasibility jump at the root (reference portfolio's
    # FeasibilityJumpSolver recast as a multi-seed device search,
    # sat/fj_device.py): objective-descent mode hunts a strictly better
    # incumbent with 64 seeds advancing per round on the device.  Engages
    # on a card ("auto"); every result passes try_incumbent's checker.
    if (len(int_idx) == n and incumbent_x is not None
            and params.device_fj != "off"
            and np.all(qp_min.variable_lower[int_idx] >= -1e-9)
            and np.all(qp_min.variable_upper[int_idx] <= 1 + 1e-9)):
        use_dev = params.device_fj == "on"
        if params.device_fj == "auto":
            use_dev = device.type == "cuda"
        remaining_fj = params.time_limit_sec - (
            time.perf_counter() - start)
        if use_dev and remaining_fj > 8.0:
            from ortools_tpu_torch.sat.fj_device import (
                device_feasibility_jump, objective_descent_system)

            cutoff = incumbent_obj - max(
                1e-6, 1e-4 * abs(incumbent_obj))
            a2, lb2, ub2 = objective_descent_system(
                a, qp_min.constraint_lower, qp_min.constraint_upper,
                qp_min.objective_vector, cutoff)
            res_fj = device_feasibility_jump(
                a2, lb2, ub2, n_seeds=64, steps_per_round=128,
                max_rounds=40, x0=incumbent_x,
                deadline=time.perf_counter() + min(
                    params.device_fj_seconds, 0.25 * remaining_fj),
                device=device)
            for cand in res_fj.solutions:
                try_incumbent(cand)

    # root kick: polish the first incumbent before the tree starts (a
    # Hamming ball of k around a good greedy/FJ/dive solution often
    # already contains the optimum — measured distance 9 on mknap_100x5)
    if incumbent_x is not None and params.local_branching_interval:
        run_local_branching()

    pcosts = _PseudoCosts(n)
    frontier: List[_Node] = []
    heapq.heappush(frontier, _Node(root_bound, seq, lb0, ub0,
                                   warm_x=root_warm_x, warm_y=root_warm_y))

    while frontier:
        if num_nodes >= params.max_nodes or (
            time.perf_counter() - start > params.time_limit_sec
        ):
            status = MPSolverStatus.FEASIBLE if incumbent_x is not None \
                else MPSolverStatus.NOT_SOLVED
            break
        # Best-bound batch selection.
        is_simplex = isinstance(backend, SimplexNodeBackend)
        pop_size = (params.simplex_batch_size if is_simplex
                    else params.node_batch_size)
        batch: List[_Node] = []
        while frontier and len(batch) < pop_size:
            node = heapq.heappop(frontier)
            if gap_closed(node.bound):
                continue
            batch.append(node)
        if not batch:
            break
        num_nodes += len(batch)
        num_batches += 1
        lbs = np.stack([nd.lb for nd in batch])
        ubs = np.stack([nd.ub for nd in batch])
        m_cur = qp_min.num_constraints
        warm_x = (
            np.stack([
                nd.warm_x if nd.warm_x is not None else np.zeros(n)
                for nd in batch
            ])
            if not is_simplex and any(nd.warm_x is not None for nd in batch)
            else None
        )
        warm_y = (
            np.stack([
                nd.warm_y if nd.warm_y is not None
                and nd.warm_y.shape == (m_cur,)
                else np.zeros(m_cur)
                for nd in batch
            ])
            if warm_x is not None
            else None
        )
        # Escalate the LP budget for retried (hard) nodes.
        max_retries_in_batch = max(nd.retries for nd in batch)
        batch_lp_params = lp_params
        if max_retries_in_batch > 0:
            batch_lp_params = dataclasses.replace(
                lp_params,
                iteration_limit=lp_params.iteration_limit
                * 4**max_retries_in_batch,
            )
        res = backend.solve(lbs, ubs, warm_x=warm_x, warm_y=warm_y,
                            lp_params=batch_lp_params,
                            deadline=start + params.time_limit_sec)
        for i, nd in enumerate(batch):
            if res.skipped[i]:
                # not attempted (deadline hit mid-batch): keep the node
                seq += 1
                heapq.heappush(frontier, dataclasses.replace(nd, seq=seq))
                continue
            x_lp = res.primal_solution[i]
            # res.dual_bound is a *valid* lower bound on the node LP (exact
            # Lagrangian dual value of the dual iterate) even when the LP
            # did not converge — unlike dual_objective, it is safe to
            # prune on (ADVICE r1: never prune on an unproven residual).
            node_bound = max(nd.bound, float(res.dual_bound[i]))
            pcosts.update(nd, node_bound)
            if res.primal_infeasible[i]:
                # Verified dual-ray certificate: the node LP is infeasible.
                continue
            if gap_closed(node_bound):
                continue
            try_incumbent(x_lp)
            # Full heuristics on the best-bound node, adaptively
            # throttled: while they keep improving the incumbent run
            # them every batch (mixed models lean on LP-guided repair),
            # but once stale back off to every 4th batch — measured
            # ~70% of node-loop wall time re-polishing identical points
            # on small knapsacks.
            obj_before = incumbent_obj
            heur_fresh = num_batches - last_improve_batch <= 8
            mixed = len(int_idx) < n  # continuous part present
            if i == 0 and (mixed or num_batches <= 8
                           or num_batches % 4 == 0):
                run_heuristics(x_lp)
            if incumbent_obj < obj_before - 1e-12:
                last_improve_batch = num_batches
            # Aux heuristics (dive/ILS/RINS/local branching) run at their
            # configured cadence on mixed models; pure-integer models get
            # 4x sparser cadences — there the tree itself is the best
            # primal engine and these were eating ~2/3 of the node budget.
            aux_mult = 1 if mixed else 8
            if i == 0:
                if (num_batches % (params.dive_interval * aux_mult) == 1
                        and (mixed or heur_fresh)):
                    run_dive(x_lp, nd.lb, nd.ub)
                    if incumbent_x is not None:
                        reopt = (backend.resolve_raw if isinstance(
                            backend, SimplexNodeBackend) else None)
                        for cand in ils_polish(qp_min, incumbent_x,
                                               int_idx, ils_rng,
                                               reopt=reopt):
                            try_incumbent(cand)
                if (params.rins_interval
                        and num_batches % (params.rins_interval * aux_mult)
                        == 2
                        and incumbent_x is not None):
                    run_rins(x_lp)
                    ex = one_two_exchange(
                        qp_min, incumbent_x, params.feasibility_tol,
                        deadline=min(start + params.time_limit_sec,
                                     time.perf_counter() + 3.0))
                    if ex is not None:
                        try_incumbent(ex)
                    if mixed and isinstance(backend, SimplexNodeBackend):
                        # facility toggle/swap local search with exact
                        # continuous re-optimization per move
                        tg = binary_toggle_ls(
                            qp_min, incumbent_x, int_idx,
                            backend.resolve_raw,
                            deadline=min(start + params.time_limit_sec,
                                         time.perf_counter() + 6.0))
                        if tg is not None:
                            try_incumbent(tg)
                if (params.local_branching_interval
                        and num_batches % (params.local_branching_interval
                                           * aux_mult) == 4
                        and incumbent_x is not None):
                    run_local_branching()
                if (is_simplex and params.tree_cut_interval
                        and num_batches % (params.tree_cut_interval
                                           * aux_mult) == 3
                        and num_tree_cuts < params.max_tree_cuts):
                    # Cut-and-branch: cuts separated at any LP point with
                    # GLOBAL bounds stay globally valid; appending rows
                    # keeps every frontier node's (lb, ub) meaningful.
                    pool = generate_cuts(
                        a, qp_min.constraint_lower, qp_min.constraint_upper,
                        lb0, ub0, integrality, x_lp,
                        max_cuts=min(40, params.max_tree_cuts
                                     - num_tree_cuts))
                    if pool is not None:
                        qp_min = append_cuts(qp_min, pool)
                        a = sp.csr_matrix(qp_min.constraint_matrix)
                        num_tree_cuts += pool.num_cuts
                        backend = choose_backend(
                            qp_min, lp_params, params.node_batch_size,
                            params.node_lp, device=device)
            frac = np.abs(x_lp[int_idx] - np.round(x_lp[int_idx])) \
                if len(int_idx) else np.zeros(0)
            if frac.size == 0 or frac.max() <= params.integrality_tol:
                if res.optimal[i]:
                    # integer-feasible LP optimum: node is solved exactly
                    continue
                # Unconverged LP whose iterate happens to look integral:
                # nothing is proven.  Branch on any unfixed integer
                # variable to make progress; if all are fixed, retry the
                # node with a bigger LP budget (bounded escalation).
                unfixed = int_idx[(nd.ub[int_idx] - nd.lb[int_idx]) > 0.5]
                if len(unfixed) == 0:
                    if nd.retries < 2:
                        seq += 1
                        heapq.heappush(frontier, _Node(
                            node_bound, seq, nd.lb, nd.ub,
                            warm_x=x_lp, warm_y=res.dual_solution[i],
                            retries=nd.retries + 1,
                        ))
                    else:
                        # give up on proving this node: the final status
                        # may no longer claim OPTIMAL
                        had_inexact_nodes = True
                        dropped_bound = min(dropped_bound, node_bound)
                    continue
                j = int(unfixed[0])
                xj = 0.5 * (nd.lb[j] + nd.ub[j])
            elif params.use_pseudo_costs:
                cand = int_idx[frac > params.integrality_tol]
                fr = x_lp[cand] - np.floor(x_lp[cand])
                # Reliability branching: measure unreliable candidates'
                # child LPs with warm dual-simplex re-solves before
                # trusting the product rule (Achterberg et al.; reference
                # strong-branching role in sat/integer_search.cc).
                if (is_simplex and params.sb_reliability > 0
                        and num_nodes <= params.sb_node_limit
                        and time.perf_counter() - start
                        < 0.75 * params.time_limit_sec):
                    unrel_mask = (np.minimum(pcosts.cnt_dn[cand],
                                             pcosts.cnt_up[cand])
                                  < params.sb_reliability)
                    if unrel_mask.any():
                        # most promising unreliable candidates first
                        order = np.argsort(
                            -np.minimum(fr, 1.0 - fr)[unrel_mask])
                        todo = cand[unrel_mask][order]
                        todo = todo[:params.sb_max_candidates]
                        sb_deadline = min(
                            start + 0.8 * params.time_limit_sec,
                            time.perf_counter() + 5.0)
                        for jj in todo:
                            if time.perf_counter() > sb_deadline:
                                break
                            xjj = float(x_lp[jj])
                            fjj = xjj - math.floor(xjj)
                            for d, lo, hi in (
                                (-1, None, math.floor(xjj)),
                                (+1, math.ceil(xjj), None),
                            ):
                                clb = np.array(nd.lb)
                                cub = np.array(nd.ub)
                                if hi is not None:
                                    cub[jj] = min(cub[jj], hi)
                                if lo is not None:
                                    clb[jj] = max(clb[jj], lo)
                                st, _, _, obj = backend.resolve_raw(
                                    clb, cub, deadline=sb_deadline)
                                if st == MPSolverStatus.OPTIMAL:
                                    pcosts.observe(
                                        int(jj), d,
                                        max(obj - node_bound, 0.0), fjj)
                                elif st == MPSolverStatus.INFEASIBLE:
                                    # child infeasible: a very large
                                    # measured gain (drives selection
                                    # toward this variable)
                                    big = (incumbent_obj - node_bound
                                           if math.isfinite(incumbent_obj)
                                           else abs(node_bound) + 1.0)
                                    pcosts.observe(int(jj), d,
                                                   max(big, 1.0), fjj)
                j = int(cand[pcosts.select(cand, fr)])
                xj = x_lp[j]
            else:
                # Branch on the most fractional integer variable.
                j = int(int_idx[int(np.argmax(frac))])
                xj = x_lp[j]
            b_frac = float(xj - math.floor(xj))
            for direction, lo_add, hi_add in (
                (-1, None, math.floor(xj + params.integrality_tol)),
                (+1, math.ceil(xj - params.integrality_tol), None),
            ):
                clb, cub = np.array(nd.lb), np.array(nd.ub)
                if hi_add is not None:
                    cub[j] = min(cub[j], hi_add)
                if lo_add is not None:
                    clb[j] = max(clb[j], lo_add)
                if clb[j] > cub[j]:
                    continue
                plb, pub, ok = propagate_bounds(
                    a, qp_min.constraint_lower, qp_min.constraint_upper,
                    clb, cub, integrality, max_rounds=3,
                )
                if not ok:
                    continue
                seq += 1
                heapq.heappush(frontier, _Node(
                    node_bound, seq, plb, pub,
                    warm_x=x_lp, warm_y=res.dual_solution[i],
                    branch_var=j, branch_dir=direction, branch_frac=b_frac,
                ))
        if params.verbosity >= 1:
            fb = frontier[0].bound if frontier else incumbent_obj
            print(f"nodes={num_nodes} frontier={len(frontier)} "
                  f"incumbent={incumbent_obj:.6f} bound={fb:.6f}")

    if not frontier and status == MPSolverStatus.NOT_SOLVED:
        if had_inexact_nodes:
            # some nodes were abandoned without an exactness proof — the
            # search is exhausted but optimality cannot be claimed
            status = (MPSolverStatus.FEASIBLE if incumbent_x is not None
                      else MPSolverStatus.NOT_SOLVED)
        else:
            status = (
                MPSolverStatus.OPTIMAL if incumbent_x is not None
                else MPSolverStatus.INFEASIBLE
            )
    bound_candidates = [nd.bound for nd in frontier]
    if had_inexact_nodes:
        bound_candidates.append(dropped_bound)
    best_bound = min(bound_candidates) if bound_candidates else incumbent_obj
    sol = incumbent_x if incumbent_x is not None else np.zeros(n)
    return MipResult(
        status=status,
        solution=sol,
        objective_value=sign * incumbent_obj if incumbent_x is not None
        else math.nan,
        best_bound=sign * best_bound,
        num_nodes=num_nodes,
        wall_time_sec=time.perf_counter() - start,
    )
