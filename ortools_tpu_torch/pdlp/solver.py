"""Restarted adaptive primal-dual hybrid gradient (PDLP), single device,
in PyTorch (port of ``ortools_tpu/pdlp/solver.py``).

Function for function the JAX module's single-device path, so that each
function can be held against its twin on one shared problem and state:
host rescaling and upload (``_ruiz_and_l2_rescale``,
``build_device_problem``), power iteration, the adaptive PDHG step
(``_make_iteration``), majors of ``termination_check_frequency`` steps,
device-side statistics, restarts, and the ``solve()`` host loop with the
mixed-precision (bf16 stream) controller.

What differs from the JAX module:

- PyTorch runs eagerly, so the step-acceptance loop of ``_make_iteration``
  reads one device boolean per attempt (counted in ``host_syncs``).  The
  per-major statistics come to the host in one device-to-host copy.
- Every SpMV on a card launches the block-row CUDA kernels
  (``ops/csrc/block_spmv.cu``); the f32 objective reductions accumulate in
  float64 (``ops/df32.py``).
- The power-iteration start ``v0`` may be passed in; by default it is
  drawn from a ``torch.Generator`` seeded with 0 (other numbers than
  ``jax.random``).
- Not ported yet, and refused with ``NotImplementedError``: the
  ADAPTIVE_HEURISTIC restart rule, the Malitsky-Pock linesearch,
  feasibility polishing, presolve, random projections and meshes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix, auto_block_shape
from ortools_tpu_torch.ops.df32 import sum_df32, vdot_df32
from ortools_tpu_torch.pdlp.params import OptimalityNorm, PdhgParams, RestartStrategy
from ortools_tpu_torch.utils.device import resolve_device
from ortools_tpu_torch.utils.status import TerminationReason

# Device-to-host reads made by the solver: one per step attempt (the
# acceptance test) and one per major (its statistics), and the host time
# spent blocked in them.  Plain counters that callers may reset and read.
host_syncs = 0
host_sync_seconds = 0.0


# ---------------------------------------------------------------------------
# Device problem representation
# ---------------------------------------------------------------------------


class DeviceProblem(NamedTuple):
    """Scaled, padded problem on the device.

    Scaling convention: A' = D_r A D_c, x = D_c x', y = D_r y',
    c' = D_c c, bounds scaled accordingly.  ``orig_*`` tensors are the
    padded original-space data used for residuals and objectives.
    """

    a: BlockSparseMatrix  # scaled A'  (M x N padded)
    at: BlockSparseMatrix  # scaled A'^T
    c: torch.Tensor  # scaled objective [N]
    q: torch.Tensor  # scaled diagonal objective [N] (zeros for LP)
    var_lb: torch.Tensor  # scaled [N]
    var_ub: torch.Tensor
    con_lb: torch.Tensor  # scaled [M]
    con_ub: torch.Tensor
    orig_c: torch.Tensor
    orig_q: torch.Tensor
    orig_var_lb: torch.Tensor
    orig_var_ub: torch.Tensor
    orig_con_lb: torch.Tensor
    orig_con_ub: torch.Tensor
    row_scale: torch.Tensor  # D_r [M]
    col_scale: torch.Tensor  # D_c [N]
    norm_b: torch.Tensor  # scalar: norm of finite combined constraint bounds
    norm_c: torch.Tensor  # scalar: norm of objective vector


class PdhgState(NamedTuple):
    x: torch.Tensor  # scaled primal [N]
    y: torch.Tensor  # scaled dual [M]
    ax: torch.Tensor  # A'x' [M]
    aty: torch.Tensor  # A'^T y' [N]
    step_size: torch.Tensor  # eta (scalar)
    primal_weight: torch.Tensor  # omega (scalar)
    x_sum: torch.Tensor  # step-size-weighted sum for the average
    y_sum: torch.Tensor
    sum_weights: torch.Tensor
    x_restart: torch.Tensor  # iterate at last restart
    y_restart: torch.Tensor
    num_steps: torch.Tensor  # int32: total step attempts
    num_accepted: torch.Tensor  # int32
    kkt_passes: torch.Tensor  # cumulative KKT matrix passes (1 = A and A^T)
    step_ratio: torch.Tensor  # Malitsky-Pock state; 1.0 under the adaptive rule


@dataclasses.dataclass
class SolveResult:
    termination_reason: TerminationReason
    primal_solution: np.ndarray  # original space, length n
    dual_solution: np.ndarray  # original space, length m
    reduced_costs: np.ndarray  # original space, length n
    primal_objective: float
    dual_objective: float
    primal_residual: float  # norm per params.optimality_norm, original space
    dual_residual: float
    relative_gap: float
    iterations: int
    kkt_matrix_passes: float
    solve_time_sec: float
    iteration_stats: List[dict]

    @property
    def objective_value(self) -> float:
        return self.primal_objective


# ---------------------------------------------------------------------------
# Host-side preprocessing: rescaling (Ruiz + L2) and device upload
# ---------------------------------------------------------------------------


def _ruiz_and_l2_rescale(
    a: sp.csr_matrix, ruiz_iters: int, l2: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute D_r, D_c such that D_r A D_c is well scaled.

    Ruiz L-inf equilibration (reference sharded_optimization_utils.h:94):
    repeatedly divide each row/col by sqrt of its max |entry|.  Then one
    pass of L2 scaling (divide by sqrt of the row/col L2 norm, :103).
    """
    m, n = a.shape
    d_r = np.ones(m)
    d_c = np.ones(n)
    if m == 0 or n == 0 or a.nnz == 0:
        return d_r, d_c
    work = sp.csr_matrix(a, copy=True).astype(np.float64)
    work.eliminate_zeros()
    for _ in range(ruiz_iters):
        abs_w = abs(work)
        row_max = abs_w.max(axis=1).toarray().ravel()
        col_max = abs_w.max(axis=0).toarray().ravel()
        r = np.sqrt(np.where(row_max > 0, row_max, 1.0))
        c = np.sqrt(np.where(col_max > 0, col_max, 1.0))
        d_r /= r
        d_c /= c
        work = sp.diags(1.0 / r) @ work @ sp.diags(1.0 / c)
    if l2:
        sq = work.multiply(work)
        row_norm = np.sqrt(np.asarray(sq.sum(axis=1)).ravel())
        col_norm = np.sqrt(np.asarray(sq.sum(axis=0)).ravel())
        r = np.sqrt(np.where(row_norm > 0, row_norm, 1.0))
        c = np.sqrt(np.where(col_norm > 0, col_norm, 1.0))
        d_r /= r
        d_c /= c
    return d_r, d_c


def build_device_problem(
    qp: QuadraticProgram, params: PdhgParams, device="cuda",
) -> DeviceProblem:
    device = resolve_device(device)
    qp = qp.as_minimization()
    m, n = qp.num_constraints, qp.num_variables
    a = sp.csr_matrix(qp.constraint_matrix).astype(np.float64)
    if params.l_inf_ruiz_iterations > 0 or params.l2_norm_rescaling:
        d_r, d_c = _ruiz_and_l2_rescale(
            a, params.l_inf_ruiz_iterations, params.l2_norm_rescaling
        )
    else:
        d_r, d_c = np.ones(m), np.ones(n)
    a_scaled = sp.diags(d_r) @ a @ sp.diags(d_c)

    block = params.block_shape or auto_block_shape(m, n, a.nnz)
    dtype = params.dtype
    # Both logical dims padded to multiples of 128, so A (M, N) and its
    # block transpose (N, M) agree on padded vector lengths.
    mm = -(-max(m, 1) // 128) * 128
    nn = -(-max(n, 1) // 128) * 128
    dev_a = BlockSparseMatrix.from_scipy(
        a_scaled, block_shape=block, dtype=dtype, padded_shape=(mm, nn),
        device=device,
    )
    # Aᵀ as the per-block transpose of A at block shape (bn, bm): the same
    # block count as A, so both SpMV passes stream the same bytes.
    dev_at = dev_a.block_transpose()
    # The block-row kernel layout: always on a card (the kernels are the
    # only SpMV there), on request on the CPU (plain versions).  The bf16
    # copy serves the f32 fast stream only.
    use_tiled = params.use_tiled_spmv
    if device.type != "cpu" or use_tiled:
        want_hi = (use_tiled is not False and dtype == torch.float32
                   and params.stream_precision in ("auto", "mixed"))
        dev_a = dev_a.with_tiled(hi=want_hi)
        dev_at = dev_at.with_tiled(hi=want_hi)

    def padv(v, fill, size):
        out = np.full(size, fill, dtype=np.float64)
        out[: len(v)] = v
        return torch.as_tensor(out, dtype=dtype, device=device)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    q = qp.objective_matrix_diagonal
    q = np.zeros(n) if q is None else np.asarray(q, dtype=np.float64)

    # Padded variables are fixed at 0 with zero cost; padded constraints are
    # free ([-inf, inf]) so they never generate duals or residuals.
    return DeviceProblem(
        a=dev_a,
        at=dev_at,
        c=padv(qp.objective_vector * d_c, 0.0, nn),
        q=padv(q * d_c * d_c, 0.0, nn),
        var_lb=padv(qp.variable_lower / d_c, 0.0, nn),
        var_ub=padv(qp.variable_upper / d_c, 0.0, nn),
        con_lb=padv(qp.constraint_lower * d_r, -np.inf, mm),
        con_ub=padv(qp.constraint_upper * d_r, np.inf, mm),
        orig_c=padv(qp.objective_vector, 0.0, nn),
        orig_q=padv(q, 0.0, nn),
        orig_var_lb=padv(qp.variable_lower, 0.0, nn),
        orig_var_ub=padv(qp.variable_upper, 0.0, nn),
        orig_con_lb=padv(qp.constraint_lower, -np.inf, mm),
        orig_con_ub=padv(qp.constraint_upper, np.inf, mm),
        row_scale=padv(d_r, 1.0, mm),
        col_scale=padv(d_c, 1.0, nn),
        norm_b=scalar(_combined_bounds_norm(qp.constraint_lower,
                                            qp.constraint_upper)),
        norm_c=scalar(float(np.linalg.norm(qp.objective_vector))),
    )


def _combined_bounds_norm(lo: np.ndarray, hi: np.ndarray) -> float:
    bv = np.maximum(
        np.where(np.isfinite(lo), np.abs(lo), 0.0),
        np.where(np.isfinite(hi), np.abs(hi), 0.0),
    )
    return float(np.linalg.norm(bv))


# ---------------------------------------------------------------------------
# Device functions: power iteration, PDHG step, stats
# ---------------------------------------------------------------------------


class _Matvecs(NamedTuple):
    matvec: Callable[[torch.Tensor], torch.Tensor]
    rmatvec: Callable[[torch.Tensor], torch.Tensor]


def _make_matvecs(a: BlockSparseMatrix, at: BlockSparseMatrix,
                  fast: bool = False) -> _Matvecs:
    """SpMV closures of one device; ``fast`` selects the bf16 stream
    (exact ``matvec`` where no bf16 copy is attached)."""
    if fast:
        return _Matvecs(a.matvec_fast, at.matvec_fast)
    return _Matvecs(a.matvec, at.matvec)


def _make_power_iter(params: PdhgParams):
    """sigma_max(A) by power iteration on A^T A (reference
    sharded_optimization_utils.h:179)."""
    steps = params.power_iteration_steps

    def power_iter(prob: DeviceProblem, v0: torch.Tensor) -> torch.Tensor:
        mv = _make_matvecs(prob.a, prob.at)
        v = v0 / torch.linalg.vector_norm(v0)
        for _ in range(steps):
            w = mv.rmatvec(mv.matvec(v))
            # in place: w is the product's fresh output
            v = w.div_(torch.clamp(torch.linalg.vector_norm(w), min=1e-30))
        return torch.sqrt(torch.linalg.vector_norm(mv.rmatvec(mv.matvec(v))))

    return power_iter


def _dual_prox(y_hat, sigma, con_lb, con_ub):
    """y' for two-sided constraints: y' = y_hat + sigma*l on the positive
    branch, y_hat + sigma*u on the negative branch, else 0."""
    pos = y_hat + sigma * con_lb  # -inf when l = -inf -> branch disabled
    neg = y_hat + sigma * con_ub  # +inf when u = +inf -> branch disabled
    return torch.where(pos > 0, pos, torch.where(neg < 0, neg, 0.0))


def _make_iteration(params: PdhgParams, fast: bool = False):
    """One adaptive PDHG step (reference TakeAdaptiveStep).  The attempt
    loop runs on the host and reads the acceptance flag once per attempt;
    everything else stays on the device."""
    if params.linesearch_rule == "malitsky_pock":
        raise NotImplementedError(_DEFERRED["malitsky_pock"])
    reduction_exp = params.step_size_reduction_exponent
    growth_exp = params.step_size_growth_exponent
    max_attempts = params.max_step_attempts

    def iteration(prob: DeviceProblem, state: PdhgState) -> PdhgState:
        global host_syncs, host_sync_seconds
        mv = _make_matvecs(prob.a, prob.at, fast)
        dtype = prob.c.dtype
        tiny = torch.finfo(dtype).tiny
        grad = prob.c + prob.q * state.x - state.aty
        omega = state.primal_weight
        step = state.step_size
        num_steps = state.num_steps
        x_new, y_new, ax_mid = state.x, state.y, state.ax
        attempts = 0
        # Temporaries are updated in place where that saves a vector; the
        # state's own tensors never are, so a fast major can be rewound.
        while attempts < max_attempts:
            tau = step / omega
            sigma = step * omega
            x_cand = (state.x - tau * grad).clamp_(prob.var_lb, prob.var_ub)
            ax_mid = mv.matvec(2.0 * x_cand - state.x)  # SpMV
            y_hat = state.y - sigma * ax_mid
            y_cand = _dual_prox(y_hat, sigma, prob.con_lb, prob.con_ub)
            dx = x_cand - state.x
            dy = y_cand - state.y
            movement = 0.5 * (
                omega * torch.dot(dx, dx) + torch.dot(dy, dy) / omega
            )
            interaction = torch.abs(
                torch.dot(dy, ax_mid - state.ax)
            ) * 0.5 + 0.5 * torch.dot(dx, prob.q * dx)
            limit = torch.where(
                interaction > 0,
                movement / torch.clamp(interaction, min=tiny), math.inf)
            accepted = step <= limit
            k = (num_steps + 1).to(dtype)
            first = (1.0 - k ** (-reduction_exp)) * limit
            second = (1.0 + k ** (-growth_exp)) * step
            new_step = torch.minimum(first, second)
            # Guard against a zero/NaN step killing the solve.
            step = torch.where(
                torch.isfinite(new_step) & (new_step > 0), new_step,
                step * 0.5)
            num_steps = num_steps + 1
            attempts += 1
            x_new, y_new = x_cand, y_cand
            host_syncs += 1
            t0 = time.perf_counter()
            done = bool(accepted)
            host_sync_seconds += time.perf_counter() - t0
            if done:
                break
        # On acceptance: A x_new = (A(2x'-x) + A x)/2; fresh A^T y (SpMV).
        ax_new = 0.5 * (ax_mid + state.ax)
        aty_new = mv.rmatvec(y_new)  # SpMV
        weight = state.step_size
        return PdhgState(
            x=x_new,
            y=y_new,
            ax=ax_new,
            aty=aty_new,
            step_size=step,
            primal_weight=state.primal_weight,
            x_sum=state.x_sum + weight * x_new,
            y_sum=state.y_sum + weight * y_new,
            sum_weights=state.sum_weights + weight,
            x_restart=state.x_restart,
            y_restart=state.y_restart,
            num_steps=num_steps,
            num_accepted=state.num_accepted + 1,
            kkt_passes=state.kkt_passes + 0.5 * (attempts + 1.0),
            step_ratio=state.step_ratio,
        )

    return iteration


def _make_run_major(params: PdhgParams, fast: bool = False):
    iteration = _make_iteration(params, fast)
    freq = params.termination_check_frequency

    def run_major(prob: DeviceProblem, state: PdhgState) -> PdhgState:
        for _ in range(freq):
            state = iteration(prob, state)
        return state

    return run_major


def _norm(v: torch.Tensor, norm: OptimalityNorm) -> torch.Tensor:
    if norm == OptimalityNorm.L_INF:
        return torch.max(torch.abs(v))
    return torch.sqrt(torch.dot(v, v))


def _iterate_stats(prob: DeviceProblem, x, y, ax, aty,
                   norm: OptimalityNorm) -> dict:
    """Residuals/objectives of one (scaled-space) iterate, computed in the
    ORIGINAL problem space (reference iteration_stats.cc:180-316)."""
    inv_row = 1.0 / prob.row_scale
    inv_col = 1.0 / prob.col_scale
    x_o = prob.col_scale * x
    y_o = prob.row_scale * y
    ax_o = ax * inv_row
    aty_o = aty * inv_col

    primal_viol = torch.clamp(prob.orig_con_lb - ax_o, min=0.0) + torch.clamp(
        ax_o - prob.orig_con_ub, min=0.0
    )
    r = prob.orig_c + prob.orig_q * x_o - aty_o  # primal gradient
    lb_finite = torch.isfinite(prob.orig_var_lb)
    ub_finite = torch.isfinite(prob.orig_var_ub)
    reduced_costs = torch.where(
        r > 0,
        torch.where(lb_finite, r, 0.0),
        torch.where(ub_finite, r, 0.0),
    )
    dual_viol = r - reduced_costs

    # Objective-gap reductions accumulate in f64 when the iterate is f32:
    # the gap criterion at 1e-6 relative sits at f32 summation noise for
    # large n (ops/df32.py).
    if x_o.dtype == torch.float32:
        _vd, _sm = vdot_df32, sum_df32
    else:
        _vd, _sm = torch.dot, torch.sum
    primal_obj = _vd(prob.orig_c, x_o) + 0.5 * _vd(prob.orig_q, x_o * x_o)
    # Dual objective: l^T[y]+ - u^T[y]- plus the variable-bound term of the
    # absorbed reduced costs, minus the quadratic correction; sign-split
    # with `where` so 0*inf never appears.
    con_term = _sm(
        torch.where(y_o > 0, prob.orig_con_lb * y_o, 0.0)
        + torch.where(y_o < 0, prob.orig_con_ub * y_o, 0.0)
    )
    var_term = _sm(
        torch.where(reduced_costs > 0, prob.orig_var_lb * reduced_costs, 0.0)
        + torch.where(reduced_costs < 0, prob.orig_var_ub * reduced_costs,
                      0.0)
    )
    dual_obj = con_term + var_term - 0.5 * _vd(prob.orig_q, x_o * x_o)

    # A valid lower bound on the optimum from y alone: the exact Lagrangian
    # dual value con_term(y) + sum_i min_{x_i in [lb,ub]} (r0_i x_i +
    # q_i x_i^2 / 2) with r0 = c - A^T y.
    r0 = prob.orig_c - aty_o
    q = prob.orig_q
    lin_term = torch.where(r0 > 0, r0 * prob.orig_var_lb, 0.0) + torch.where(
        r0 < 0, r0 * prob.orig_var_ub, 0.0
    )
    xq = torch.clamp(-r0 / torch.where(q > 0, q, 1.0), prob.orig_var_lb,
                     prob.orig_var_ub)
    quad_term = r0 * xq + 0.5 * q * xq * xq
    dual_bound = con_term + torch.sum(torch.where(q > 0, quad_term, lin_term))

    return dict(
        primal_objective=primal_obj,
        dual_objective=dual_obj,
        dual_bound=dual_bound,
        primal_residual=_norm(primal_viol, norm),
        dual_residual=_norm(dual_viol, norm),
        reduced_costs=reduced_costs,
    )


def _infeasibility_stats(prob: DeviceProblem, x_r, y_r,
                         mv: _Matvecs) -> dict:
    """Certificate quality of candidate rays (reference
    iteration_stats.h:68 ComputeInfeasibilityInformation).

    Primal ray x_r proves DUAL infeasibility when it is a recession
    direction with negative objective; dual ray y_r proves PRIMAL
    infeasibility when its residual vanishes and its objective is
    positive.  Rays are given in scaled space and unscaled here.
    """
    x_o = prob.col_scale * x_r
    y_o = prob.row_scale * y_r
    ax_o = mv.matvec(x_r) / prob.row_scale
    aty_o = mv.rmatvec(y_r) / prob.col_scale

    # -- primal ray: recession cone of constraints and variable bounds
    lb_fin_row = torch.isfinite(prob.orig_con_lb)
    ub_fin_row = torch.isfinite(prob.orig_con_ub)
    row_viol = torch.clamp(torch.where(lb_fin_row, -ax_o, 0.0), min=0.0) + \
        torch.clamp(torch.where(ub_fin_row, ax_o, 0.0), min=0.0)
    lb_fin = torch.isfinite(prob.orig_var_lb)
    ub_fin = torch.isfinite(prob.orig_var_ub)
    var_viol = torch.clamp(torch.where(lb_fin, -x_o, 0.0), min=0.0) + \
        torch.clamp(torch.where(ub_fin, x_o, 0.0), min=0.0)
    max_primal_ray_infeas = torch.maximum(torch.max(row_viol),
                                          torch.max(var_viol))
    primal_ray_objective = torch.dot(prob.orig_c, x_o)
    ray_norm_x = torch.max(torch.abs(x_o))
    # a valid unboundedness ray of a convex QP needs Q x_r = 0
    max_quadratic_ray = torch.max(torch.abs(prob.orig_q * x_o))

    # -- dual ray: -A^T y absorbed on finite variable bounds
    r = -aty_o
    rc = torch.where(r > 0, torch.where(lb_fin, r, 0.0),
                     torch.where(ub_fin, r, 0.0))
    dual_res = torch.abs(r - rc)
    # wrong-sign duals at one-sided rows are residuals too
    wrong_sign = torch.clamp(torch.where(~lb_fin_row, y_o, 0.0), min=0.0) + \
        torch.clamp(torch.where(~ub_fin_row, -y_o, 0.0), min=0.0)
    max_dual_ray_infeas = torch.maximum(torch.max(dual_res),
                                        torch.max(wrong_sign))
    dual_ray_objective = (
        torch.sum(torch.where((y_o > 0) & lb_fin_row,
                              prob.orig_con_lb * y_o, 0.0))
        + torch.sum(torch.where((y_o < 0) & ub_fin_row,
                                prob.orig_con_ub * y_o, 0.0))
        + torch.sum(torch.where(rc > 0, prob.orig_var_lb * rc, 0.0))
        + torch.sum(torch.where(rc < 0, prob.orig_var_ub * rc, 0.0))
    )
    ray_norm_y = torch.max(torch.abs(y_o))
    return dict(
        max_primal_ray_infeasibility=max_primal_ray_infeas,
        primal_ray_objective=primal_ray_objective,
        ray_norm_x=ray_norm_x,
        max_quadratic_ray=max_quadratic_ray,
        max_dual_ray_infeasibility=max_dual_ray_infeas,
        dual_ray_objective=dual_ray_objective,
        ray_norm_y=ray_norm_y,
    )


def _make_compute_stats(params: PdhgParams, exact_refresh: bool = False):
    """``exact_refresh`` recomputes A x / Aᵀ y for the CURRENT iterate with
    the exact kernel — required while the major loop runs the bf16 fast
    stream, where state.ax/state.aty carry ~2^-9 matrix rounding.  Every
    termination decision therefore rests on exact residuals."""
    if params.restart_strategy == RestartStrategy.ADAPTIVE_HEURISTIC:
        raise NotImplementedError(_DEFERRED["adaptive_heuristic"])
    if params.random_projection_seeds:
        raise NotImplementedError(_DEFERRED["random_projections"])
    norm = params.optimality_norm

    def compute_stats(prob: DeviceProblem, state: PdhgState) -> dict:
        mv = _make_matvecs(prob.a, prob.at)
        if exact_refresh:
            ax_c = mv.matvec(state.x)
            aty_c = mv.rmatvec(state.y)
        else:
            ax_c, aty_c = state.ax, state.aty
        cur = _iterate_stats(prob, state.x, state.y, ax_c, aty_c, norm)
        w = torch.clamp(state.sum_weights, min=1e-30)
        has_avg = state.sum_weights > 0
        x_avg = torch.where(has_avg, state.x_sum / w, state.x)
        y_avg = torch.where(has_avg, state.y_sum / w, state.y)
        ax_avg = mv.matvec(x_avg)
        aty_avg = mv.rmatvec(y_avg)
        avg = _iterate_stats(prob, x_avg, y_avg, ax_avg, aty_avg, norm)
        omega = state.primal_weight

        def kkt(s):
            gap = s["primal_objective"] - s["dual_objective"]
            return torch.sqrt(
                omega**2 * s["primal_residual"] ** 2
                + s["dual_residual"] ** 2 / omega**2
                + gap**2
            )

        return dict(
            current={k: v for k, v in cur.items() if k != "reduced_costs"},
            average={k: v for k, v in avg.items() if k != "reduced_costs"},
            projections={},
            kkt_current=kkt(cur),
            kkt_average=kkt(avg),
            x_avg=x_avg,
            y_avg=y_avg,
            num_steps=state.num_steps,
            num_accepted=state.num_accepted,
            kkt_passes=state.kkt_passes + 1.0,  # this stats pass
            step_size=state.step_size,
            primal_weight=state.primal_weight,
            # infeasibility certificate candidates (reference uses the
            # iterate difference and the current iterate as rays)
            infeas_diff=_infeasibility_stats(
                prob, state.x - state.x_restart,
                state.y - state.y_restart, mv,
            ),
            infeas_current=_infeasibility_stats(prob, state.x, state.y, mv),
        )

    return compute_stats


_SCALAR_GROUPS = ("current", "average", "infeas_diff", "infeas_current")
_SCALAR_KEYS = ("kkt_current", "kkt_average", "kkt_passes", "step_size",
                "primal_weight")


def _stats_to_host(stats: dict) -> dict:
    """The scalars of ``compute_stats`` as Python floats, brought to the
    host in ONE device-to-host copy: {group: {name: float}} for the
    grouped scalars and {name: float} for the others."""
    global host_syncs, host_sync_seconds
    names, vals = [], []
    for g in _SCALAR_GROUPS:
        for k, v in stats[g].items():
            names.append((g, k))
            vals.append(v)
    for k in _SCALAR_KEYS:
        names.append((None, k))
        vals.append(stats[k])
    host_syncs += 1
    t0 = time.perf_counter()
    flat = torch.stack(vals).cpu().tolist()
    host_sync_seconds += time.perf_counter() - t0
    out = {g: {} for g in _SCALAR_GROUPS}
    for (g, k), v in zip(names, flat):
        if g is None:
            out[k] = v
        else:
            out[g][k] = v
    return out


def _make_apply_restart(params: PdhgParams):
    smoothing = params.primal_weight_update_smoothing

    def apply_restart(prob: DeviceProblem, state: PdhgState, use_avg: bool,
                      x_avg: torch.Tensor, y_avg: torch.Tensor) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at)
        x_new = x_avg if use_avg else state.x
        y_new = y_avg if use_avg else state.y
        ax = mv.matvec(x_new)
        aty = mv.rmatvec(y_new)
        # Primal weight update from distance traveled since last restart
        # (reference ComputeNewPrimalWeight, :1983-2011).
        dp = torch.linalg.vector_norm(x_new - state.x_restart)
        dd = torch.linalg.vector_norm(y_new - state.y_restart)
        valid = ((dp > 1e-30) & (dd > 1e-30) & torch.isfinite(dp)
                 & torch.isfinite(dd))
        new_w = torch.exp(
            smoothing * torch.log(torch.clamp(dd, min=1e-30)
                                  / torch.clamp(dp, min=1e-30))
            + (1.0 - smoothing) * torch.log(state.primal_weight)
        )
        omega = torch.where(valid, new_w, state.primal_weight)
        return PdhgState(
            x=x_new, y=y_new, ax=ax, aty=aty,
            step_size=state.step_size,
            primal_weight=omega,
            x_sum=torch.zeros_like(state.x), y_sum=torch.zeros_like(state.y),
            sum_weights=torch.zeros_like(state.sum_weights),
            x_restart=x_new, y_restart=y_new,
            num_steps=state.num_steps,
            num_accepted=state.num_accepted,
            kkt_passes=state.kkt_passes + 1.0,
            step_ratio=state.step_ratio,
        )

    return apply_restart


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


def _make_initial_state(params: PdhgParams):
    def initial_state(prob: DeviceProblem,
                      sigma_max: torch.Tensor) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at)
        dtype, device = prob.c.dtype, prob.c.device
        n = prob.c.shape[0]
        m = prob.con_lb.shape[0]

        def scalar(v, dt=dtype):
            return torch.tensor(v, dtype=dt, device=device)

        x0 = torch.clamp(torch.zeros(n, dtype=dtype, device=device),
                         prob.var_lb, prob.var_ub)
        y0 = torch.zeros(m, dtype=dtype, device=device)
        # For QPs the curvature of Q also bounds the step; without
        # constraints sigma_max(A) can be 0.
        curvature = torch.maximum(sigma_max, torch.max(prob.q))
        step0 = scalar(params.initial_step_size_scaling) / torch.clamp(
            curvature, min=1e-30)
        if params.initial_primal_weight is not None:
            w0 = scalar(params.initial_primal_weight)
        else:
            # ||c|| / ||b|| when both positive else 1 (reference :1268).
            w0 = torch.where(
                (prob.norm_c > 0) & (prob.norm_b > 0),
                prob.norm_c / torch.clamp(prob.norm_b, min=1e-30),
                scalar(1.0),
            )
        return PdhgState(
            x=x0,
            y=y0,
            ax=mv.matvec(x0),
            aty=mv.rmatvec(y0),
            step_size=step0,
            primal_weight=w0,
            x_sum=torch.zeros(n, dtype=dtype, device=device),
            y_sum=torch.zeros(m, dtype=dtype, device=device),
            sum_weights=scalar(0.0),
            x_restart=x0,
            y_restart=y0,
            num_steps=scalar(0, torch.int32),
            num_accepted=scalar(0, torch.int32),
            kkt_passes=scalar(1.0),
            step_ratio=scalar(1.0),
        )

    return initial_state


def _make_final_iterate(norm: OptimalityNorm):
    def final_iterate(prob: DeviceProblem, x, y) -> dict:
        mv = _make_matvecs(prob.a, prob.at)
        s = _iterate_stats(prob, x, y, mv.matvec(x), mv.rmatvec(y), norm)
        return dict(
            x=prob.col_scale * x,
            y=prob.row_scale * y,
            reduced_costs=s["reduced_costs"],
        )

    return final_iterate


def _check_optimality(stats: dict, prob_consts: dict, params: PdhgParams,
                      require: Tuple[str, ...] = ("gap", "primal", "dual"),
                      ) -> bool:
    """Optimality per the reference detailed criteria; ``require`` masks
    which parts must hold."""
    eps_a = params.eps_optimal_absolute
    eps_r = params.eps_optimal_relative
    nb, nc = prob_consts["norm_b"], prob_consts["norm_c"]
    p, d = stats["primal_objective"], stats["dual_objective"]
    ok = True
    if "gap" in require:
        ok &= abs(p - d) <= eps_a + eps_r * (abs(p) + abs(d))
    if "primal" in require:
        ok &= stats["primal_residual"] <= eps_a + eps_r * nb
    if "dual" in require:
        ok &= stats["dual_residual"] <= eps_a + eps_r * nc
    return bool(ok)


def _invalid_result(qp: QuadraticProgram,
                    reason: TerminationReason) -> SolveResult:
    n, m = qp.num_variables, qp.num_constraints
    return SolveResult(
        termination_reason=reason,
        primal_solution=np.zeros(n),
        dual_solution=np.zeros(m),
        reduced_costs=np.zeros(n),
        primal_objective=math.nan,
        dual_objective=math.nan,
        primal_residual=math.nan,
        dual_residual=math.nan,
        relative_gap=math.nan,
        iterations=0,
        kkt_matrix_passes=0.0,
        solve_time_sec=0.0,
        iteration_stats=[],
    )


# Features of the JAX solver that later slices of the port bring.
_DEFERRED = {
    "adaptive_heuristic": (
        "restart_strategy=ADAPTIVE_HEURISTIC needs pdlp/trust_region.py, "
        "which a later slice of the port brings"),
    "malitsky_pock": (
        "linesearch_rule='malitsky_pock' is not ported yet (a later slice)"),
    "polishing": (
        "use_feasibility_polishing (with _make_warm_state) is not ported "
        "yet (a later slice)"),
    "presolve": (
        "presolve=True needs the port's copy of glop/presolve.py, which a "
        "later slice brings"),
    "random_projections": (
        "random_projection_seeds are not ported yet (a later slice)"),
    "mesh": (
        "multi-device solves (a mesh) come with the multi-device slice of "
        "the port"),
}


def _check_deferred(params: PdhgParams, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(_DEFERRED["mesh"])
    if params.restart_strategy == RestartStrategy.ADAPTIVE_HEURISTIC:
        raise NotImplementedError(_DEFERRED["adaptive_heuristic"])
    if params.linesearch_rule == "malitsky_pock":
        raise NotImplementedError(_DEFERRED["malitsky_pock"])
    if params.use_feasibility_polishing:
        raise NotImplementedError(_DEFERRED["polishing"])
    if params.presolve:
        raise NotImplementedError(_DEFERRED["presolve"])
    if params.random_projection_seeds:
        raise NotImplementedError(_DEFERRED["random_projections"])


def solve(
    qp: QuadraticProgram,
    params: Optional[PdhgParams] = None,
    device="cuda",
    v0=None,
    mesh=None,
) -> SolveResult:
    """Solve an LP/QP with restarted adaptive PDHG on one device.

    ``device`` defaults to the card and raises where there is none;
    ``device="cpu"`` runs the same solve with the kernels' plain versions.
    ``v0`` (length of the padded variable vector) is the power-iteration
    start; by default it is drawn from a ``torch.Generator`` seeded with 0.
    """
    params = params or PdhgParams()
    device = resolve_device(device)
    _check_deferred(params, mesh)
    perrs = params.validate()
    if perrs:
        return _invalid_result(qp, TerminationReason.INVALID_PARAMETER)
    errs = qp.validate()
    if errs:
        return _invalid_result(qp, TerminationReason.INVALID_PROBLEM)
    start = time.perf_counter()
    qp_min = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0

    prob = build_device_problem(qp_min, params, device)
    run_major = _make_run_major(params)
    run_major_fast = _make_run_major(params, fast=True)
    compute_stats = _make_compute_stats(params)
    compute_stats_fast = _make_compute_stats(params, exact_refresh=True)
    apply_restart = _make_apply_restart(params)
    power_iter = _make_power_iter(params)
    initial_state = _make_initial_state(params)
    final_iterate = _make_final_iterate(params.optimality_norm)

    def refresh_products(st: PdhgState) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at)
        return st._replace(ax=mv.matvec(st.x), aty=mv.rmatvec(st.y))

    # Mixed-precision majors (bf16 stream) where the bf16 copy is attached.
    # Stats for fast majors recompute the current iterate's products with
    # the exact kernel, so termination always rests on exact residuals.
    fast_ready = (
        params.stream_precision in ("auto", "mixed")
        and prob.a.has_fast_stream and prob.at.has_fast_stream
    )

    nn = prob.c.shape[0]
    if v0 is None:
        gen = torch.Generator(device="cpu").manual_seed(0)
        v0 = torch.randn(nn, generator=gen, dtype=torch.float64)
    if not isinstance(v0, torch.Tensor):
        v0 = torch.tensor(np.asarray(v0, dtype=np.float64))
    v0 = v0.to(dtype=prob.c.dtype, device=device)
    if v0.shape != (nn,):
        raise ValueError(f"v0 must have length {nn}, got {tuple(v0.shape)}")
    sigma_max = power_iter(prob, v0)
    state = initial_state(prob, sigma_max)
    prob_consts = dict(
        norm_b=float(prob.norm_b), norm_c=float(prob.norm_c)
    )

    log: List[dict] = []
    reason = TerminationReason.ITERATION_LIMIT
    best = None  # (which, stats_dict, x, y) chosen at termination
    kkt_at_last_restart = math.inf
    last_candidate_kkt = math.inf
    iters_at_last_restart = 0
    iterations = 0

    fast_mode = fast_ready
    fast_best_kkt = math.inf
    fast_stall = 0

    while True:
        if iterations >= params.iteration_limit:
            reason = TerminationReason.ITERATION_LIMIT
            break
        if time.perf_counter() - start > params.time_sec_limit:
            reason = TerminationReason.TIME_LIMIT
            break
        was_fast = fast_mode
        # Fast majors keep the pre-major state (tensors no step updates in
        # place) so a non-finite bf16 major can be REWOUND: the corrupted
        # iterate must never leak into the exact retry.
        state_before = state if fast_mode else None
        state = (run_major_fast if fast_mode else run_major)(prob, state)
        iterations += params.termination_check_frequency
        stats = (compute_stats_fast if fast_mode else compute_stats)(
            prob, state)
        host = _stats_to_host(stats)
        cur, avg = host["current"], host["average"]
        kkt_cur = host["kkt_current"]
        kkt_avg = host["kkt_average"]
        kkt_passes = host["kkt_passes"]
        if fast_mode:
            # Switch to the exact stream once the exactly-measured KKT
            # stops improving — the bf16 rounding noise floor.
            cand_fast = min(kkt_cur, kkt_avg)
            if math.isfinite(cand_fast) and cand_fast < 0.9 * fast_best_kkt:
                fast_best_kkt = cand_fast
                fast_stall = 0
            else:
                fast_stall += 1
                if not math.isfinite(kkt_cur):
                    # numerical blowup in the bf16 stream: rewind to the
                    # pre-major state and retry the major exactly
                    fast_mode = False
                    state = refresh_products(state_before)
                    iterations -= params.termination_check_frequency
                    continue
                if fast_stall >= 3 or not math.isfinite(cand_fast):
                    fast_mode = False
                    state = refresh_products(state)
        if params.record_iteration_stats or params.verbosity >= 2:
            log.append(dict(iteration=iterations, current=cur, average=avg,
                            kkt_current=kkt_cur, kkt_average=kkt_avg,
                            step_size=host["step_size"],
                            primal_weight=host["primal_weight"],
                            kkt_passes=kkt_passes,
                            stream="fast" if was_fast else "exact"))
        if params.verbosity >= 2:
            print(
                f"iter={iterations} kkt_cur={kkt_cur:.3e} kkt_avg={kkt_avg:.3e}"
                f" pobj={cur['primal_objective']:.8e}"
                f" pres={cur['primal_residual']:.2e}"
                f" dres={cur['dual_residual']:.2e}"
                f" w={host['primal_weight']:.2e}"
            )
        if not math.isfinite(kkt_cur):
            reason = TerminationReason.NUMERICAL_ERROR
            best = ("average", avg, stats["x_avg"], stats["y_avg"])
            break
        # Termination: check both current and average.
        if _check_optimality(cur, prob_consts, params):
            reason = TerminationReason.OPTIMAL
            best = ("current", cur, state.x, state.y)
            break
        if _check_optimality(avg, prob_consts, params):
            reason = TerminationReason.OPTIMAL
            best = ("average", avg, stats["x_avg"], stats["y_avg"])
            break
        if kkt_passes >= params.kkt_matrix_pass_limit:
            reason = TerminationReason.KKT_MATRIX_PASS_LIMIT
            break

        # Infeasibility certificates from candidate rays (reference
        # termination.h:74 kIterateTermination infeasibility branch).
        infeas_reason = None
        for key in ("infeas_diff", "infeas_current"):
            inf = host[key]
            ny, nx = inf["ray_norm_y"], inf["ray_norm_x"]
            if (ny > 0
                    and inf["max_dual_ray_infeasibility"]
                    <= params.eps_primal_infeasible * ny
                    and inf["dual_ray_objective"] > 0):
                infeas_reason = TerminationReason.PRIMAL_INFEASIBLE
                break
            if (nx > 0
                    and inf["max_primal_ray_infeasibility"]
                    <= params.eps_dual_infeasible * nx
                    and inf["max_quadratic_ray"]
                    <= params.eps_dual_infeasible * nx
                    and inf["primal_ray_objective"] < 0):
                infeas_reason = TerminationReason.DUAL_INFEASIBLE
                break
        if infeas_reason is not None:
            reason = infeas_reason
            best = ("current", cur, state.x, state.y)
            break

        # Restart decision (host scalars only).
        do_restart = False
        use_avg = kkt_avg <= kkt_cur
        cand_kkt = min(kkt_avg, kkt_cur)
        strat = params.restart_strategy
        if strat == RestartStrategy.EVERY_MAJOR_ITERATION:
            do_restart = True
        elif strat == RestartStrategy.ADAPTIVE_KKT:
            if math.isinf(kkt_at_last_restart):
                kkt_at_last_restart = cand_kkt
            else:
                suff = cand_kkt <= (
                    params.sufficient_reduction_for_restart * kkt_at_last_restart
                )
                nec = cand_kkt <= (
                    params.necessary_reduction_for_restart * kkt_at_last_restart
                ) and cand_kkt > last_candidate_kkt
                long_interval = (
                    iterations - iters_at_last_restart
                    >= params.artificial_restart_threshold * iterations
                )
                do_restart = suff or nec or long_interval
        last_candidate_kkt = cand_kkt
        if do_restart:
            state = apply_restart(prob, state, use_avg,
                                  stats["x_avg"], stats["y_avg"])
            kkt_at_last_restart = cand_kkt
            last_candidate_kkt = math.inf
            iters_at_last_restart = iterations
            if params.verbosity >= 2:
                print(f"  restart(to_{'avg' if use_avg else 'cur'}) "
                      f"w={float(state.primal_weight):.3e}")

    if best is None:
        # Terminated by a limit: report the better of current/average.
        stats = (compute_stats_fast if fast_mode else compute_stats)(
            prob, state)
        host = _stats_to_host(stats)
        if host["kkt_average"] < host["kkt_current"]:
            best = ("average", host["average"], stats["x_avg"],
                    stats["y_avg"])
        else:
            best = ("current", host["current"], state.x, state.y)

    which, bstats, x_dev, y_dev = best
    # Unscale and unpad; recompute reduced costs for the reported iterate.
    final = final_iterate(prob, x_dev, y_dev)
    n, m = qp.num_variables, qp.num_constraints

    def to_np(v, k):
        return v.to(torch.float64).cpu().numpy()[:k]

    x = to_np(final["x"], n)
    y = to_np(final["y"], m)
    rc = to_np(final["reduced_costs"], n)

    pobj = sign * (bstats["primal_objective"] + qp_min.objective_constant)
    dobj = sign * (bstats["dual_objective"] + qp_min.objective_constant)
    denom = abs(pobj) + abs(dobj)
    rel_gap = abs(pobj - dobj) / (1.0 + denom)
    return SolveResult(
        termination_reason=reason,
        primal_solution=x,
        dual_solution=sign * y,
        reduced_costs=sign * rc,
        primal_objective=pobj,
        dual_objective=dobj,
        primal_residual=bstats["primal_residual"],
        dual_residual=bstats["dual_residual"],
        relative_gap=rel_gap,
        iterations=iterations,
        kkt_matrix_passes=float(state.kkt_passes),
        solve_time_sec=time.perf_counter() - start,
        iteration_stats=log,
    )
