"""Restarted adaptive primal-dual hybrid gradient (PDLP) in PyTorch (port
of ``ortools_tpu/pdlp/solver.py``).

Function for function the JAX module, so that each function can be held
against its twin on one shared problem and state:
host rescaling and upload (``_ruiz_and_l2_rescale``,
``build_device_problem``), power iteration, the adaptive and the
Malitsky-Pock PDHG steps, majors of ``termination_check_frequency`` steps,
device-side statistics (with the trust-region localized gaps of the
ADAPTIVE_HEURISTIC restart rule and random projections), restarts,
feasibility polishing, presolve, and the ``solve()`` host loop with the
mixed-precision (bf16 stream) controller.

What differs from the JAX module:

- The step-acceptance ``while_loop`` and the major's ``fori_loop`` become
  a sequence of *attempt slots* (``_make_iteration``,
  ``_make_mp_iteration``).  A slot runs one step attempt from the open
  iteration's start and, where the attempt ends the iteration (accepted,
  or the attempt cap reached), commits it with ``torch.where``; once the
  major has its ``termination_check_frequency`` iterations, further slots
  change nothing.  A selection is exact, so the values are the loop's.
  Slots update static buffers in place (``_Majors``).  On a card a major
  is ``termination_check_frequency`` slots captured in one CUDA graph per
  stream and replayed, and its statistics a second graph; the host reads
  one copy of the statistics and of the major's progress, and replays a
  graph of a few more slots only where rejected attempts left the major
  short.  On the CPU the same slots run eagerly.  The adaptive rule's
  rejected attempt costs one Aᵀy product that the loop did not make.
- Every SpMV on a card launches the block-row CUDA kernels
  (``ops/csrc/block_spmv.cu``); the f32 objective reductions accumulate in
  float64 (``ops/df32.py``).
- The JAX package batches these functions with ``jax.vmap``
  (``pdlp/batched.py``).  Here the device functions take a leading batch
  axis themselves: vectors [B, N], per-instance scalars [B, 1], reductions
  over the last axis (``ops/df32.py``), products of [B, N] inputs through
  the batched products (the block SpMM, or the row layout's batched kernel
  on a low-fill matrix); a 1-D call makes the same torch calls as before.
- Random vectors come from ``torch.Generator`` (other numbers than
  ``jax.random`` for the same seed): the power-iteration start ``v0``
  (seed 0; it may be passed in) and the projection vectors of
  ``random_projection_seeds`` (seeds ``s`` and ``s + 1``, as the JAX
  module keys them).
- A mesh (``parallel.make_mesh``) is a group of ``torch.distributed``
  ranks, each one device, and every rank runs this whole host program
  (JAX runs one program under ``shard_map``).  Each rank holds its part
  of the constraint matrix: a contiguous slice of the block list (1-D,
  ``_place_problem``) or one cell of a row x col partition (2-D,
  ``build_2d_problem``, ``Comm2D``); vectors are replicated, and the
  products combine their partials with collectives (``_make_matvecs``).
  So every device function takes the JAX module's ``psum`` argument.  The
  host's decisions (restarts, termination, tail slots, polishing) read
  only scalars that the collectives made bit-identical on every rank, and
  ``v0`` and the projection vectors are drawn alike on every rank: a rank
  that decided differently would leave the others waiting in a
  collective.  The one input that differs between ranks, the clock, is
  agreed on (``Mesh.any``) where a time limit is set.  With NCCL the
  collectives are captured in the majors' CUDA graphs; gloo collectives
  cannot be captured, so under gloo the slots run eagerly, on either
  device.
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
from ortools_tpu_torch.ops import tiled_spmv
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix, auto_block_shape
from ortools_tpu_torch.ops.df32 import dot, sum_df32, vdot_df32, vmax, vnorm, vsum
from ortools_tpu_torch.parallel.mesh import Mesh
from ortools_tpu_torch.pdlp import trust_region
from ortools_tpu_torch.pdlp.params import OptimalityNorm, PdhgParams, RestartStrategy
from ortools_tpu_torch.utils.device import resolve_device
from ortools_tpu_torch.utils.status import TerminationReason
from ortools_tpu_torch.utils.tracing import count, span

# Device-to-host reads made by the majors (one per major and its
# statistics, one more for each round of extra slots a major needs) and
# the host time spent blocked in them; the seconds spent capturing CUDA
# graphs.  Plain counters that callers may reset and read; the others are
# in ``utils/tracing.py``.
host_syncs = 0
host_sync_seconds = 0.0
capture_seconds = 0.0


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


def _attach_layout(mat: BlockSparseMatrix, params: PdhgParams, fast: bool,
                   csr: Optional[sp.spmatrix] = None) -> BlockSparseMatrix:
    """The kernel layouts: always on a card (the kernels are the only SpMV
    there), on request on the CPU (plain versions).  The block-row layout
    always, since the batched product reads it; beside it the row layout
    of the nonzeros, which then takes the 1-D products, where it reads at
    most half the bytes of the stored blocks (``tiled_spmv.prefer_rows``).
    That layout is built from ``csr``, the matrix the blocks hold (read
    back from the blocks where it is not given), and counted as
    ``row_layouts``.  With ``fast`` the bf16 copy of the blocks for the
    f32 fast stream, where the blocks take the 1-D products."""
    if mat.device.type == "cpu" and not params.use_tiled_spmv:
        return mat
    nnz = (int(torch.count_nonzero(mat.data)) if csr is None
           else int(np.count_nonzero(csr.data)))
    rows = tiled_spmv.prefer_rows(nnz, mat.padded_shape[0], mat.num_blocks,
                                  mat.block_shape, mat.data.element_size())
    want_hi = (fast and not rows and params.use_tiled_spmv is not False
               and mat.dtype == torch.float32
               and params.stream_precision in ("auto", "mixed"))
    mat = mat.with_tiled(hi=want_hi)
    if rows:
        count("row_layouts")
        mat = mat.with_rows(csr)
    return mat


def build_device_problem(
    qp: QuadraticProgram, params: PdhgParams, device="cuda",
    pad_blocks_to_multiple_of: int = 1,
    row_pad_multiple: int = 128, col_pad_multiple: int = 128,
) -> DeviceProblem:
    """The scaled, padded problem on ``device``.  The mesh paths ask for
    the block count padded to a multiple of the shards
    (``pad_blocks_to_multiple_of``; such a matrix gets no kernel layout
    here, its shards do) and for the padded lengths to be multiples of
    ``row_pad_multiple`` and ``col_pad_multiple`` as well as of 128."""
    device = resolve_device(device)
    with span("host_prep"):
        count("problems_built")
        qp = qp.as_minimization()
        m, n = qp.num_constraints, qp.num_variables
        a = sp.csr_matrix(qp.constraint_matrix).astype(np.float64)
        t0 = time.perf_counter()
        with span("rescale"):
            if params.l_inf_ruiz_iterations > 0 or params.l2_norm_rescaling:
                d_r, d_c = _ruiz_and_l2_rescale(
                    a, params.l_inf_ruiz_iterations, params.l2_norm_rescaling
                )
            else:
                d_r, d_c = np.ones(m), np.ones(n)
            a_scaled = sp.diags(d_r) @ a @ sp.diags(d_c)
        count("rescale_seconds", time.perf_counter() - t0)

        block = params.block_shape or auto_block_shape(m, n, a.nnz)
        dtype = params.dtype
        # Both logical dims padded to multiples of 128 (and of the mesh's
        # multiples), so A (M, N) and its block transpose (N, M) agree on
        # padded vector lengths.
        mm = -(-max(m, 1) // math.lcm(128, row_pad_multiple)) * math.lcm(
            128, row_pad_multiple)
        nn = -(-max(n, 1) // math.lcm(128, col_pad_multiple)) * math.lcm(
            128, col_pad_multiple)
        with span("layout"):
            dev_a = BlockSparseMatrix.from_scipy(
                a_scaled, block_shape=block, dtype=dtype,
                pad_blocks_to_multiple_of=pad_blocks_to_multiple_of,
                padded_shape=(mm, nn), device=device,
            )
            # Aᵀ as the per-block transpose of A at block shape (bn, bm): the
            # same block count as A, so both SpMV passes stream the same bytes.
            dev_at = dev_a.block_transpose()
            if pad_blocks_to_multiple_of == 1:
                dev_a = _attach_layout(dev_a, params, fast=True,
                                       csr=a_scaled)
                dev_at = _attach_layout(dev_at, params, fast=True,
                                        csr=a_scaled.T)

        def padv(v, fill, size):
            out = np.full(size, fill, dtype=np.float64)
            out[: len(v)] = v
            return torch.as_tensor(out, dtype=dtype, device=device)

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=device)

        q = qp.objective_matrix_diagonal
        q = np.zeros(n) if q is None else np.asarray(q, dtype=np.float64)

        # Padded variables are fixed at 0 with zero cost; padded constraints
        # are free ([-inf, inf]) so they never generate duals or residuals.
        with span("upload"):
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


class _Psum(NamedTuple):
    """The 1-D mode's combine: the sum over the mesh axis ``axis`` of the
    ranks' full-length partial products, in place (JAX's
    ``partial(jax.lax.psum, axis_name=axis)``)."""

    mesh: Mesh
    axis: str

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(t, self.axis)


class Comm2D(NamedTuple):
    """2-D (row x col) mesh communication spec for the SpMV pair.

    Rank (r, c) holds the blocks of A whose rows fall in row-range r and
    cols in col-range c (equal contiguous ranges).  Iterate vectors stay
    full-length and replicated (all elementwise math and dots are then
    mesh-oblivious); the products communicate only segments:

        y = all_gather_row( psum_col( A_rc @ x[c-range] ) )
        x = all_gather_col( psum_row( A_rc^T @ y[r-range] ) )
    """

    row_axis: str
    col_axis: str
    seg_m: int  # padded rows per row range
    seg_n: int  # padded cols per col range
    mesh: Mesh


def _capturable(psum) -> bool:
    """Whether the products' collectives may go into a CUDA graph: none,
    or NCCL's (gloo's run on the host)."""
    return psum is None or psum.mesh.backend == "nccl"


def _make_matvecs(a: BlockSparseMatrix, at: BlockSparseMatrix,
                  psum=None, fast: bool = False) -> _Matvecs:
    """SpMV closures.  ``psum`` selects the parallel mode: None (one
    device), a ``_Psum`` (1-D block sharding: each rank holds a slice of
    the block list, full-length partials summed over the axis) or a
    ``Comm2D`` (row x col partition).  ``fast`` selects the bf16 stream
    on one device (exact ``matvec`` where no bf16 copy is attached); under
    a mesh the products are exact, as in the JAX module."""
    if psum is None:
        if fast:
            return _Matvecs(a.matvec_fast, at.matvec_fast)
        return _Matvecs(a.matvec, at.matvec)
    if isinstance(psum, Comm2D):
        comm, mesh = psum, psum.mesh
        c = mesh.axis_index(comm.col_axis)
        r = mesh.axis_index(comm.row_axis)

        def mv(x):
            x_c = x[c * comm.seg_n:(c + 1) * comm.seg_n]
            y_r = mesh.psum(a.matvec(x_c), comm.col_axis)
            return mesh.all_gather(y_r, comm.row_axis)

        def rmv(y):
            y_r = y[r * comm.seg_m:(r + 1) * comm.seg_m]
            x_c = mesh.psum(at.matvec(y_r), comm.row_axis)
            return mesh.all_gather(x_c, comm.col_axis)

        return _Matvecs(mv, rmv)
    return _Matvecs(lambda x: psum(a.matvec(x)),
                    lambda y: psum(at.matvec(y)))


def _make_power_iter(params: PdhgParams, psum=None):
    """sigma_max(A) by power iteration on A^T A (reference
    sharded_optimization_utils.h:179)."""
    steps = params.power_iteration_steps

    def power_iter(prob: DeviceProblem, v0: torch.Tensor) -> torch.Tensor:
        mv = _make_matvecs(prob.a, prob.at, psum)
        with span("power_iteration"):
            v = v0 / vnorm(v0)
            for _ in range(steps):
                w = mv.rmatvec(mv.matvec(v))
                # in place: w is the product's fresh output
                v = w.div_(torch.clamp(vnorm(w), min=1e-30))
            return torch.sqrt(vnorm(mv.rmatvec(mv.matvec(v))))

    return power_iter


def _dual_prox(y_hat, sigma, con_lb, con_ub):
    """y' for two-sided constraints: y' = y_hat + sigma*l on the positive
    branch, y_hat + sigma*u on the negative branch, else 0."""
    pos = y_hat + sigma * con_lb  # -inf when l = -inf -> branch disabled
    neg = y_hat + sigma * con_ub  # +inf when u = +inf -> branch disabled
    return torch.where(pos > 0, pos, torch.where(neg < 0, neg, 0.0))


class _Slots(NamedTuple):
    """The static buffers a major runs on: the PDHG state and the open
    iteration's attempt state.  Attempt slots update them in place.  For a
    batch the counters are [B, 1], one per instance, like the state's
    scalars."""

    state: PdhgState
    attempts: torch.Tensor  # int32: attempts made in the open iteration
    trial: torch.Tensor  # the open iteration's next trial step (see slots)
    accepted: torch.Tensor  # int32: iterations accepted in this major


def _select_(dst: torch.Tensor, cond: torch.Tensor, new: torch.Tensor):
    """dst = new where cond, in place."""
    torch.where(cond, new, dst, out=dst)


def _commit(s: _Slots, active, ends, attempts, trial, **fields) -> None:
    """Write one attempt's outcome into the buffers: ``fields`` (new
    PdhgState values) where the attempt ends the iteration, the counters
    where the slot is active.  Every value is computed before any buffer
    is written."""
    st = s.state
    for name, v in fields.items():
        _select_(getattr(st, name), ends, v)
    _select_(st.num_steps, active, st.num_steps + 1)
    _select_(st.num_accepted, ends, st.num_accepted + 1)
    _select_(s.trial, active, trial)
    _select_(s.attempts, active, attempts)
    s.attempts.masked_fill_(ends, 0)
    _select_(s.accepted, ends, s.accepted + 1)


def _make_iteration(params: PdhgParams, psum=None, fast: bool = False):
    """One attempt slot of the adaptive PDHG step (reference
    TakeAdaptiveStep), in place on a major's buffers: ``slot(prob, s)``.

    The JAX module's attempt ``while_loop`` retries from the iteration's
    start until ``step <= limit`` or ``max_step_attempts`` attempts, then
    takes the last candidate.  A slot is one pass of that loop's body: it
    tries ``s.trial`` (the iteration's step size on its first attempt),
    and where the attempt ends the iteration it commits the candidate,
    A x', the fresh Aᵀ y' (SpMV; computed on every attempt), the step and
    the sums.  Once ``s.accepted`` reaches ``termination_check_frequency``
    the slot changes nothing.  Nothing in it reads a device value, so a
    sequence of slots can be captured in a CUDA graph."""
    if params.linesearch_rule == "malitsky_pock":
        return _make_mp_iteration(params, psum, fast)
    reduction_exp = params.step_size_reduction_exponent
    growth_exp = params.step_size_growth_exponent
    max_attempts = params.max_step_attempts
    freq = params.termination_check_frequency

    def slot(prob: DeviceProblem, s: _Slots) -> None:
        mv = _make_matvecs(prob.a, prob.at, psum, fast)
        st = s.state
        dtype = prob.c.dtype
        tiny = torch.finfo(dtype).tiny
        active = s.accepted < freq
        grad = prob.c + prob.q * st.x - st.aty
        omega = st.primal_weight
        step = torch.where(s.attempts == 0, st.step_size, s.trial)
        tau = step / omega
        sigma = step * omega
        x_cand = (st.x - tau * grad).clamp_(prob.var_lb, prob.var_ub)
        ax_mid = mv.matvec(2.0 * x_cand - st.x)  # SpMV
        y_hat = st.y - sigma * ax_mid
        y_cand = _dual_prox(y_hat, sigma, prob.con_lb, prob.con_ub)
        dx = x_cand - st.x
        dy = y_cand - st.y
        movement = 0.5 * (
            omega * dot(dx, dx) + dot(dy, dy) / omega
        )
        # A dx = (A(2x'-x) - Ax)/2; for QPs the quadratic objective adds
        # 1/2 dx^T Q dx to the nonlinearity.
        interaction = torch.abs(
            dot(dy, ax_mid - st.ax)
        ) * 0.5 + 0.5 * dot(dx, prob.q * dx)
        limit = torch.where(
            interaction > 0,
            movement / torch.clamp(interaction, min=tiny), math.inf)
        k = (st.num_steps + 1).to(dtype)
        first = (1.0 - k ** (-reduction_exp)) * limit
        second = (1.0 + k ** (-growth_exp)) * step
        new_step = torch.minimum(first, second)
        # Guard against a zero/NaN step killing the solve.
        new_step = torch.where(
            torch.isfinite(new_step) & (new_step > 0), new_step, step * 0.5)
        attempts = s.attempts + 1
        ends = active & ((step <= limit) | (attempts >= max_attempts))
        # On acceptance: A x' = (A(2x'-x) + A x)/2; fresh Aᵀ y' (SpMV).
        aty_new = mv.rmatvec(y_cand)
        weight = st.step_size
        _commit(
            s, active, ends, attempts, new_step,
            x=x_cand, y=y_cand, ax=0.5 * (ax_mid + st.ax), aty=aty_new,
            step_size=new_step,
            x_sum=st.x_sum + weight * x_cand,
            y_sum=st.y_sum + weight * y_cand,
            sum_weights=st.sum_weights + weight,
            kkt_passes=st.kkt_passes + 0.5 * (attempts.to(dtype) + 1.0),
        )

    return slot


def _make_mp_iteration(params: PdhgParams, psum=None, fast: bool = False):
    """One attempt slot of the Malitsky-Pock linesearch (reference
    primal_dual_hybrid_gradient.cc:2211 TakeMalitskyPockStep;
    arXiv:1608.08883), in the slot form of ``_make_iteration``.

    One primal prox per iteration; the dual linesearch scales the trial
    primal step tau (``s.trial``; on the first attempt tau times the
    dilation) by ``mp_step_downscaling`` until
        omega * tau * ||Aᵀ(y+ - y)|| <= mp_contraction * ||y+ - y||,
    at most ``max(max_step_attempts, 60)`` attempts.  A x+ comes from
    A(extrapolated) by linearity.  As in the JAX module, one step-weighted
    average serves primal and dual."""
    downscaling = params.mp_step_downscaling
    contraction = params.mp_contraction
    interpolation = params.mp_interpolation
    max_attempts = max(params.max_step_attempts, 60)
    freq = params.termination_check_frequency

    def slot(prob: DeviceProblem, s: _Slots) -> None:
        mv = _make_matvecs(prob.a, prob.at, psum, fast)
        st = s.state
        dtype = prob.c.dtype
        tiny = torch.finfo(dtype).tiny
        active = s.accepted < freq
        omega = st.primal_weight
        grad = prob.c + prob.q * st.x - st.aty
        tau = st.step_size / omega
        x_cand = (st.x - tau * grad).clamp_(prob.var_lb, prob.var_ub)
        dx = x_cand - st.x
        dilating = 1.0 + interpolation * (
            torch.sqrt(1.0 + st.step_ratio) - 1.0)
        tau_new = torch.where(s.attempts == 0, tau * dilating, s.trial)
        theta = tau_new / torch.clamp(tau, min=tiny)
        sigma = omega * omega * tau_new
        ax_e = mv.matvec(x_cand + theta * dx)  # SpMV
        y_hat = st.y - sigma * ax_e
        y_cand = _dual_prox(y_hat, sigma, prob.con_lb, prob.con_ub)
        aty_cand = mv.rmatvec(y_cand)  # SpMV
        dy = y_cand - st.y
        dp = aty_cand - st.aty
        accepted = (omega * tau_new * torch.sqrt(dot(dp, dp))
                    <= contraction * torch.sqrt(dot(dy, dy)))
        next_tau = torch.where(accepted, tau_new, downscaling * tau_new)
        attempts = s.attempts + 1
        ends = active & (accepted | (attempts >= max_attempts))
        _commit(
            s, active, ends, attempts, next_tau,
            x=x_cand, y=y_cand,
            # A x' from A(x' + theta dx) and A x by linearity.
            ax=(ax_e + theta * st.ax) / (1.0 + theta),
            aty=aty_cand,
            step_size=next_tau * omega,
            x_sum=st.x_sum + next_tau * x_cand,
            y_sum=st.y_sum + next_tau * y_cand,
            sum_weights=st.sum_weights + next_tau,
            kkt_passes=st.kkt_passes + attempts.to(dtype),
            step_ratio=theta,
        )

    return slot


def _make_run_major(params: PdhgParams, psum=None, fast: bool = False):
    """One major as a function of a state: ``run_major(prob, state)``
    returns the state after ``termination_check_frequency`` iterations
    (a fresh ``_Majors`` each call: CUDA graphs on a card, eager slots on
    the CPU)."""

    def run_major(prob: DeviceProblem, state: PdhgState) -> PdhgState:
        majors = _Majors(prob, params, psum)
        majors.load(state)
        majors.major(fast)
        return majors.snapshot()

    return run_major


def _norm(v: torch.Tensor, norm: OptimalityNorm) -> torch.Tensor:
    if norm == OptimalityNorm.L_INF:
        return vmax(torch.abs(v))
    return torch.sqrt(dot(v, v))


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
        _vd, _sm = dot, vsum
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
    dual_bound = con_term + vsum(torch.where(q > 0, quad_term, lin_term))

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
    max_primal_ray_infeas = torch.maximum(vmax(row_viol), vmax(var_viol))
    primal_ray_objective = dot(prob.orig_c, x_o)
    ray_norm_x = vmax(torch.abs(x_o))
    # a valid unboundedness ray of a convex QP needs Q x_r = 0
    max_quadratic_ray = vmax(torch.abs(prob.orig_q * x_o))

    # -- dual ray: -A^T y absorbed on finite variable bounds
    r = -aty_o
    rc = torch.where(r > 0, torch.where(lb_fin, r, 0.0),
                     torch.where(ub_fin, r, 0.0))
    dual_res = torch.abs(r - rc)
    # wrong-sign duals at one-sided rows are residuals too
    wrong_sign = torch.clamp(torch.where(~lb_fin_row, y_o, 0.0), min=0.0) + \
        torch.clamp(torch.where(~ub_fin_row, -y_o, 0.0), min=0.0)
    max_dual_ray_infeas = torch.maximum(vmax(dual_res), vmax(wrong_sign))
    dual_ray_objective = (
        vsum(torch.where((y_o > 0) & lb_fin_row, prob.orig_con_lb * y_o, 0.0))
        + vsum(torch.where((y_o < 0) & ub_fin_row,
                           prob.orig_con_ub * y_o, 0.0))
        + vsum(torch.where(rc > 0, prob.orig_var_lb * rc, 0.0))
        + vsum(torch.where(rc < 0, prob.orig_var_ub * rc, 0.0))
    )
    ray_norm_y = vmax(torch.abs(y_o))
    return dict(
        max_primal_ray_infeasibility=max_primal_ray_infeas,
        primal_ray_objective=primal_ray_objective,
        ray_norm_x=ray_norm_x,
        max_quadratic_ray=max_quadratic_ray,
        max_dual_ray_infeasibility=max_dual_ray_infeas,
        dual_ray_objective=dual_ray_objective,
        ray_norm_y=ray_norm_y,
    )


def _projection_vectors(seed: int, n: int, m: int, dtype: torch.dtype,
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random-projection vectors of one seed: standard normal draws
    in float64 from a ``torch.Generator`` seeded with ``seed`` (primal,
    length n) and ``seed + 1`` (dual, length m), cast to ``dtype``.  The
    JAX module keys ``jax.random.normal`` with the same two seeds, which
    gives other numbers."""
    def draw(s, size):
        g = torch.Generator(device="cpu").manual_seed(s)
        return torch.randn(size, generator=g, dtype=torch.float64).to(
            dtype=dtype, device=device)

    return draw(seed, n), draw(seed + 1, m)


def _make_compute_stats(params: PdhgParams, psum=None,
                        exact_refresh: bool = False):
    """``exact_refresh`` recomputes A x / Aᵀ y for the CURRENT iterate with
    the exact kernel — required while the major loop runs the bf16 fast
    stream, where state.ax/state.aty carry ~2^-9 matrix rounding.  Every
    termination decision therefore rests on exact residuals.  Nothing
    here reads a device value, so the statistics can be captured in a
    CUDA graph; the projection vectors are drawn at the first call."""
    norm = params.optimality_norm
    seeds = tuple(params.random_projection_seeds)
    heuristic = params.restart_strategy == RestartStrategy.ADAPTIVE_HEURISTIC
    projection_vectors: dict = {}

    def compute_stats(prob: DeviceProblem, state: PdhgState) -> dict:
        mv = _make_matvecs(prob.a, prob.at, psum)
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

        # Gaussian random projections of the iterate (reference
        # SetRandomProjections, iteration_stats.cc:321-346).
        projections = {}
        n, m = state.x.shape[-1], state.y.shape[-1]
        for seed in seeds:
            key = (seed, n, m, state.x.dtype, state.x.device)
            if key not in projection_vectors:
                projection_vectors[key] = _projection_vectors(
                    seed, n, m, state.x.dtype, state.x.device)
            kx, ky = projection_vectors[key]
            projections[f"primal_{seed}"] = dot(kx, state.x) / math.sqrt(n)
            projections[f"dual_{seed}"] = dot(ky, state.y) / math.sqrt(m)

        out = dict(
            current={k: v for k, v in cur.items() if k != "reduced_costs"},
            average={k: v for k, v in avg.items() if k != "reduced_costs"},
            projections=projections,
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
        if heuristic:
            out["tr_current"] = trust_region.localized_gap(
                prob, state.x, state.y, ax_c, aty_c,
                state.x_restart, state.y_restart, omega,
            )._asdict()
            out["tr_average"] = trust_region.localized_gap(
                prob, x_avg, y_avg, ax_avg, aty_avg,
                state.x_restart, state.y_restart, omega,
            )._asdict()
        return out

    return compute_stats


def _is_scalar(v: torch.Tensor) -> bool:
    """A per-instance scalar: 0-d for one instance, [B, 1] for a batch."""
    return v.dim() == 0 or (v.dim() == 2 and v.shape[-1] == 1)


def _stats_scalars(stats: dict, extra: Optional[dict] = None):
    """The scalars of ``compute_stats`` (and of ``extra``) stacked in one
    float64 tensor: returns (groups, names, stacked), where ``names`` holds
    (group or None, name) per entry.  ``stacked`` is a length-K vector for
    one instance and a [K, B] matrix for a batch."""
    groups, names, vals = [], [], []
    for k, v in list(stats.items()) + list((extra or {}).items()):
        if isinstance(v, dict):
            groups.append(k)
            for kk, vv in v.items():
                names.append((k, kk))
                vals.append(vv)
        elif _is_scalar(v):
            names.append((None, k))
            vals.append(v)
    return groups, names, torch.stack([v.to(torch.float64).squeeze(-1)
                                       for v in vals])


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: one device-to-host copy, counted in
    ``host_syncs`` and timed in ``host_sync_seconds``."""
    global host_syncs, host_sync_seconds
    with span("read"):
        host_syncs += 1
        t0 = time.perf_counter()
        out = t.cpu()
        host_sync_seconds += time.perf_counter() - t0
    return out


def _read_scalars(groups, names, flat: torch.Tensor) -> dict:
    """``_stats_scalars``' tensor on the host in ONE device-to-host copy:
    {group: {name: value}} for the grouped entries and {name: value} for
    the others, a value being a Python float for one instance and a
    float64 numpy vector of length B for a batch."""
    flat = _to_host(flat)
    values = flat.tolist() if flat.dim() == 1 else list(flat.numpy())
    out = {g: {} for g in groups}
    for (g, k), v in zip(names, values):
        if g is None:
            out[k] = v
        else:
            out[g][k] = v
    return out


def _stats_to_host(stats: dict) -> dict:
    """The scalars of ``compute_stats`` on the host, in one copy."""
    return _read_scalars(*_stats_scalars(stats))


def _make_apply_restart(params: PdhgParams, psum=None):
    smoothing = params.primal_weight_update_smoothing

    def apply_restart(prob: DeviceProblem, state: PdhgState, use_avg,
                      x_avg: torch.Tensor, y_avg: torch.Tensor) -> PdhgState:
        """``use_avg``: a bool, or for a batch a [B, 1] bool tensor (each
        instance restarts to its average or its current iterate)."""
        mv = _make_matvecs(prob.a, prob.at, psum)
        if isinstance(use_avg, torch.Tensor):
            x_new = torch.where(use_avg, x_avg, state.x)
            y_new = torch.where(use_avg, y_avg, state.y)
        else:
            x_new = x_avg if use_avg else state.x
            y_new = y_avg if use_avg else state.y
        ax = mv.matvec(x_new)
        aty = mv.rmatvec(y_new)
        # Primal weight update from distance traveled since last restart
        # (reference ComputeNewPrimalWeight, :1983-2011).
        dp = vnorm(x_new - state.x_restart)
        dd = vnorm(y_new - state.y_restart)
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
# Majors on static buffers: CUDA graphs on a card, eager slots on the CPU
# ---------------------------------------------------------------------------


_PROBLEM_VECTORS = tuple(f for f in DeviceProblem._fields
                         if f not in ("a", "at"))


# One capture stream per card, shared by every solve: cuBLAS keeps a
# workspace (32 MiB on Hopper) for each stream it has run on, for the life
# of the process.
_capture_streams: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _capture_streams:
        _capture_streams[index] = torch.cuda.Stream(device=index)
    return _capture_streams[index]


def _clone_slots(s: _Slots) -> _Slots:
    return _Slots(PdhgState(*[v.clone() for v in s.state]),
                  *[v.clone() for v in s[1:]])


class _Majors:
    """Majors of PDHG iterations on one problem, on static buffers.

    ``load`` copies a state into the buffers; ``major(fast)`` runs one
    major of the exact or the fast (bf16) stream and its statistics, and
    returns them as device tensors (valid until the next call) and as
    scalars on the host; ``stats`` gives the statistics alone; ``state``
    is the live buffers, ``snapshot`` a copy of them; ``set_problem``
    copies another problem's vectors (same matrices) into the problem the
    majors read, which is how polishing runs its subproblems on the same
    graphs.

    On a card each stream is captured once as three CUDA graphs that share
    the buffers and one memory pool: the major (its count reset, then
    ``termination_check_frequency`` attempt slots), a tail of
    ``ceil(frequency / 8)`` slots, and the statistics with their scalars
    stacked in one vector.  A major replays the first and the last and
    reads the scalars and the major's count of accepted iterations in one
    copy.  Where rejected attempts left the major short, it replays enough
    tails for the iterations left at the acceptance rate seen so far, then
    the statistics again.  A failed capture raises.  A capture launches
    nothing, so each replay adds the kernel launches it captured to the
    wrappers' counters.  On the CPU the same functions run eagerly in the
    same order.

    A batch (a state of [B, N] vectors and [B, 1] scalars, a problem with
    [B, N] variable bounds) runs on the same code: each instance's slots
    stop changing anything once it has its iterations, its products go
    through the batched kernels, the statistics come to the host as one
    [K, B] copy, and a major is done when its slowest instance is.
    """

    def __init__(self, prob: DeviceProblem, params: PdhgParams, psum=None):
        self.params = params
        self.psum = psum
        self.freq = params.termination_check_frequency
        self.tail_slots = -(-self.freq // 8)
        self.max_attempts = params.max_step_attempts
        if params.linesearch_rule == "malitsky_pock":
            self.max_attempts = max(params.max_step_attempts, 60)
        self.use_graphs = (prob.c.device.type == "cuda"
                           and _capturable(psum))
        self.prob = prob._replace(**{f: getattr(prob, f).clone()
                                     for f in _PROBLEM_VECTORS})
        self.slots: Optional[_Slots] = None
        self._fns: dict = {}
        self._graphs: dict = {}
        self._pool = None
        # when the last major returned, in the caller's current call
        self.returned: Optional[float] = None

    # -- buffers ----------------------------------------------------------
    @property
    def state(self) -> PdhgState:
        return self.slots.state

    def load(self, state: PdhgState) -> None:
        """Copy ``state`` into the buffers (allocated at the first call).
        A field that is another field's buffer is cloned first."""
        if self.slots is None:
            st = PdhgState(*[v.clone() for v in state])
            count = torch.zeros_like(st.num_steps)
            self.slots = _Slots(st, count, torch.zeros_like(st.step_size),
                                count.clone())
            return
        bufs = self.slots.state
        where = {id(b): i for i, b in enumerate(bufs)}
        srcs = []
        for i, v in enumerate(state):
            j = where.get(id(v))
            srcs.append(v if j is None else None if j == i else v.clone())
        for b, v in zip(bufs, srcs):
            if v is not None:
                b.copy_(v)
        self.slots.attempts.zero_()

    def snapshot(self) -> PdhgState:
        return PdhgState(*[v.clone() for v in self.slots.state])

    def set_problem(self, prob: DeviceProblem) -> None:
        if prob.a is not self.prob.a or prob.at is not self.prob.at:
            raise ValueError("set_problem takes a problem with the same "
                             "matrices")
        for f in _PROBLEM_VECTORS:
            getattr(self.prob, f).copy_(getattr(prob, f))

    # -- what a graph holds ------------------------------------------------
    def _functions(self, fast: bool):
        if fast not in self._fns:
            self._fns[fast] = (
                _make_iteration(self.params, self.psum, fast),
                _make_compute_stats(self.params, self.psum,
                                    exact_refresh=fast))
        return self._fns[fast]

    def _main(self, fast: bool) -> None:
        slot, _ = self._functions(fast)
        self.slots.accepted.zero_()
        for _ in range(self.freq):
            slot(self.prob, self.slots)

    def _tail(self, fast: bool) -> None:
        slot, _ = self._functions(fast)
        for _ in range(self.tail_slots):
            slot(self.prob, self.slots)

    def _stats(self, fast: bool):
        _, compute_stats = self._functions(fast)
        stats = compute_stats(self.prob, self.slots.state)
        return stats, _stats_scalars(
            stats, dict(major_accepted=self.slots.accepted))

    def _run(self, kind: str, fast: bool):
        fn = getattr(self, "_" + kind)
        if not self.use_graphs:
            return fn(fast)
        if (kind, fast) not in self._graphs:
            self._capture(fast)
        graph, out, launches = self._graphs[(kind, fast)]
        t0 = time.perf_counter()
        with span("replay"):
            graph.replay()
        count("replay_seconds", time.perf_counter() - t0)
        tiled_spmv.count_launches(*launches)
        return out

    def _capture(self, fast: bool) -> None:
        """Capture the stream's three graphs, after one warm-up of the
        slot and the statistics on scratch buffers on the capture stream
        (kernel modules load, cuBLAS takes its workspace, the projection
        vectors are drawn: nothing of that may happen inside a capture)."""
        global capture_seconds
        with span("capture"):
            t0 = time.perf_counter()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            stream = _capture_stream(self.prob.c.device)
            slot, compute_stats = self._functions(fast)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                scratch = _clone_slots(self.slots)
                slot(self.prob, scratch)
                compute_stats(self.prob, scratch.state)
                del scratch
            torch.cuda.current_stream().wait_stream(stream)
            for kind in ("main", "tail", "stats"):
                before = tiled_spmv.launch_counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                    out = getattr(self, "_" + kind)(fast)
                launches = tuple(a - b for a, b in
                                 zip(tiled_spmv.launch_counts(), before))
                tiled_spmv.count_launches(*(-n for n in launches))
                self._graphs[(kind, fast)] = (graph, out, launches)
            capture_seconds += time.perf_counter() - t0

    # -- majors -------------------------------------------------------------
    def major(self, fast: bool = False) -> Tuple[dict, dict]:
        """One major (``termination_check_frequency`` accepted iterations)
        and its statistics: (device stats, host scalars).  Counts the
        major, its slots, its accepted iterations (each instance's, for a
        batch) and the host's time since the last major returned in the
        same call (``returned``; the caller clears it at a call's
        start)."""
        if self.returned is not None:
            count("host_loop_seconds", time.perf_counter() - self.returned)
        with span("major"):
            self._run("main", fast)
            slots_run = self.freq
            while True:
                stats, scalars = self._run("stats", fast)
                host = _read_scalars(*scalars)
                # a batch is done when its slowest instance is
                done = int(np.min(host.pop("major_accepted")))
                left = self.freq - done
                if left <= 0:
                    break
                need = min(left * self.max_attempts,
                           -(-left * slots_run // max(done, 1)))
                for _ in range(-(-need // self.tail_slots)):
                    self._run("tail", fast)
                    slots_run += self.tail_slots
        x = self.slots.state.x
        count("majors")
        count("slots", slots_run)
        count("accepted", self.freq * (x.shape[0] if x.dim() == 2 else 1))
        self.returned = time.perf_counter()
        return stats, host

    def stats(self, fast: bool = False) -> Tuple[dict, dict]:
        """The statistics of the state in the buffers."""
        with span("major"):
            stats, scalars = self._run("stats", fast)
            host = _read_scalars(*scalars)
        host.pop("major_accepted")
        return stats, host


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


def _make_initial_state(params: PdhgParams, psum=None):
    """``initial_state(prob, sigma_max)``.  A problem with [B, N] variable
    bounds gives a batch of B states; ``sigma_max`` is shared, as under
    the JAX module's ``vmap(in_axes=(axes, None))``."""

    def initial_state(prob: DeviceProblem,
                      sigma_max: torch.Tensor) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        dtype, device = prob.c.dtype, prob.c.device
        batch = tuple(prob.var_lb.shape[:-1])
        n = prob.c.shape[0]
        m = prob.con_lb.shape[0]

        def scalar(v, dt=dtype):
            if batch:
                return torch.full(batch + (1,), v, dtype=dt, device=device)
            return torch.tensor(v, dtype=dt, device=device)

        def per_instance(v):
            return v.expand(batch + (1,)).clone() if batch else v

        x0 = torch.clamp(torch.zeros(n, dtype=dtype, device=device),
                         prob.var_lb, prob.var_ub)
        y0 = torch.zeros(batch + (m,), dtype=dtype, device=device)
        # For QPs the curvature of Q also bounds the step; without
        # constraints sigma_max(A) can be 0.
        curvature = torch.maximum(sigma_max, torch.max(prob.q))
        step0 = torch.tensor(params.initial_step_size_scaling, dtype=dtype,
                             device=device) / torch.clamp(curvature,
                                                          min=1e-30)
        if params.initial_primal_weight is not None:
            w0 = torch.tensor(params.initial_primal_weight, dtype=dtype,
                              device=device)
        else:
            # ||c|| / ||b|| when both positive else 1 (reference :1268).
            w0 = torch.where(
                (prob.norm_c > 0) & (prob.norm_b > 0),
                prob.norm_c / torch.clamp(prob.norm_b, min=1e-30),
                torch.tensor(1.0, dtype=dtype, device=device),
            )
        return PdhgState(
            x=x0,
            y=y0,
            ax=mv.matvec(x0),
            aty=mv.rmatvec(y0),
            step_size=per_instance(step0),
            primal_weight=per_instance(w0),
            x_sum=torch.zeros(batch + (n,), dtype=dtype, device=device),
            y_sum=torch.zeros(batch + (m,), dtype=dtype, device=device),
            sum_weights=scalar(0.0),
            x_restart=x0,
            y_restart=y0,
            num_steps=scalar(0, torch.int32),
            num_accepted=scalar(0, torch.int32),
            kkt_passes=scalar(1.0),
            step_ratio=scalar(1.0),
        )

    return initial_state


def _make_warm_state(params: PdhgParams, psum=None):
    """State from a given (x0, y0) start with inherited step and weight:
    the feasibility-polishing entry point (reference Solver ctor with
    starting solutions, primal_dual_hybrid_gradient.cc:2594-2599)."""

    def warm_state(prob: DeviceProblem, x0, y0, step,
                   weight) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        dtype, device = prob.c.dtype, prob.c.device

        def scalar(v, dt=dtype):
            return torch.tensor(v, dtype=dt, device=device)

        x0 = torch.clamp(x0.to(dtype), prob.var_lb, prob.var_ub)
        y0 = y0.to(dtype)
        return PdhgState(
            x=x0,
            y=y0,
            ax=mv.matvec(x0),
            aty=mv.rmatvec(y0),
            step_size=step.to(dtype),
            primal_weight=weight.to(dtype),
            x_sum=torch.zeros_like(x0),
            y_sum=torch.zeros_like(y0),
            sum_weights=scalar(0.0),
            x_restart=x0,
            y_restart=y0,
            num_steps=scalar(0, torch.int32),
            num_accepted=scalar(0, torch.int32),
            kkt_passes=scalar(1.0),
            step_ratio=scalar(1.0),
        )

    return warm_state


def _make_final_iterate(norm: OptimalityNorm, psum=None):
    def final_iterate(prob: DeviceProblem, x, y) -> dict:
        mv = _make_matvecs(prob.a, prob.at, psum)
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


def params_cache_key(params: PdhgParams) -> tuple:
    """Hashable identity of a PdhgParams: its fields by name, lists as
    tuples."""
    vals = []
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, list):
            v = tuple(v)
        vals.append((f.name, v))
    return tuple(vals)


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


def _block_slice(a: BlockSparseMatrix, lo: int, hi: int, device
                 ) -> BlockSparseMatrix:
    """Blocks ``lo:hi`` of ``a``'s block list, copied to ``device``, at
    ``a``'s shape."""
    def part(t):
        return t[lo:hi].to(device, copy=True)

    return BlockSparseMatrix(
        data=part(a.data), block_rows=part(a.block_rows),
        block_cols=part(a.block_cols), shape=a.shape,
        padded_shape=a.padded_shape,
        num_real_blocks=max(0, min(hi, a.num_real_blocks) - lo))


def _vectors_to(prob: DeviceProblem, device) -> DeviceProblem:
    """``prob`` with its vectors and scalars on ``device`` (A and Aᵀ as
    they are)."""
    return prob._replace(**{f: getattr(prob, f).to(device)
                            for f in prob._fields if f not in ("a", "at")})


def _place_problem(prob: DeviceProblem, mesh: Mesh, axis: str,
                   params: PdhgParams, device) -> DeviceProblem:
    """This rank's part of a 1-D block-sharded problem, from the whole
    problem on the host: the contiguous slice ``[k nb/S, (k+1) nb/S)`` of
    A's block list at coordinate k of ``axis`` (S ranks), and the
    transposes of the same blocks for Aᵀ, which is what ``P(axis)`` on the
    block arrays' leading dim gives each device in the JAX module.  Only
    the slice and the (replicated) vectors go to ``device``.  Each shard
    gets its kernel layout, without the bf16 copy: the products are exact
    under a mesh."""
    size, k = mesh.axis_size(axis), mesh.axis_index(axis)
    a = prob.a.without_tiled()
    nb = a.num_blocks
    if nb % size:
        raise ValueError(f"{nb} blocks do not split over {size} shards")
    a_k = _block_slice(a, k * nb // size, (k + 1) * nb // size, device)
    return _vectors_to(prob, device)._replace(
        a=_attach_layout(a_k, params, fast=False),
        at=_attach_layout(a_k.block_transpose(), params, fast=False))


def _partition_blocks(data: np.ndarray, block_rows: np.ndarray,
                      block_cols: np.ndarray, padded_shape: Tuple[int, int],
                      nr: int, nc: int) -> dict:
    """The row x col partition of a block list, every cell at once: rows
    and cols split into ``nr`` and ``nc`` equal contiguous ranges; cell
    k = r * nc + c holds the blocks of row-range r and col-range c, in
    their list order, with indices local to the cell, zero-padded (zero
    blocks at (0, 0)) to the largest cell's count ``nbmax``.  Returns the
    stacked arrays (cell k is ``[k nbmax, (k+1) nbmax)``) and the segment
    lengths (the JAX module's solver.py:1576-1600)."""
    bm, bn = int(data.shape[1]), int(data.shape[2])
    mm, nn = padded_shape
    if mm % (nr * bm) or nn % (nc * bn):
        raise ValueError(f"padded shape {padded_shape} does not split into "
                         f"{nr} x {nc} cells of whole blocks")
    seg_m, seg_n = mm // nr, nn // nc
    rows_per_seg, cols_per_seg = seg_m // bm, seg_n // bn
    cell = (block_rows // rows_per_seg) * nc + block_cols // cols_per_seg
    counts = np.bincount(cell, minlength=nr * nc)
    nbmax = max(1, int(counts.max()))
    stacked = np.zeros((nr * nc * nbmax, bm, bn), dtype=data.dtype)
    srows = np.zeros(nr * nc * nbmax, dtype=np.int32)
    scols = np.zeros(nr * nc * nbmax, dtype=np.int32)
    order = np.argsort(cell, kind="stable")
    pos = 0
    for k in range(nr * nc):
        sel = order[pos: pos + counts[k]]
        pos += counts[k]
        off = k * nbmax
        stacked[off: off + len(sel)] = data[sel]
        srows[off: off + len(sel)] = block_rows[sel] % rows_per_seg
        scols[off: off + len(sel)] = block_cols[sel] % cols_per_seg
    return dict(data=stacked, block_rows=srows, block_cols=scols,
                seg_m=seg_m, seg_n=seg_n, nbmax=nbmax)


def partition_2d(qp: QuadraticProgram, params: PdhgParams,
                 shape: Tuple[int, int]):
    """The host partition of a 2-D (row x col) mesh of ``shape``, every
    cell, on the CPU: returns (base, cells), ``base`` the whole problem
    with both padded lengths rounded so that each range holds whole blocks
    (the JAX module's lcm rounding) and ``cells`` the stacked cell arrays
    (``_partition_blocks``)."""
    nr, nc = shape
    qpm = qp.as_minimization()
    bm, bn = params.block_shape or auto_block_shape(
        qpm.num_constraints, qpm.num_variables, qpm.num_nonzeros)
    base = build_device_problem(
        qpm, dataclasses.replace(params, use_tiled_spmv=None), "cpu",
        row_pad_multiple=nr * bm * (128 // math.gcd(128, bm)),
        col_pad_multiple=nc * bn * (128 // math.gcd(128, bn)),
    )
    a = base.a
    nreal = a.num_real_blocks
    return base, _partition_blocks(
        a.data[:nreal].numpy(), a.block_rows[:nreal].numpy(),
        a.block_cols[:nreal].numpy(), a.padded_shape, nr, nc)


def build_2d_problem(qp: QuadraticProgram, params: PdhgParams, mesh: Mesh,
                     device="cuda") -> Tuple[DeviceProblem, Comm2D]:
    """Partition A over a 2-D (row x col) mesh: this rank's cell of
    ``partition_2d`` (made on the host) as its A (seg_m x seg_n) and the
    cell's block transpose as its Aᵀ, each with its kernel layout, on
    ``device`` with the whole vectors; nothing else of A leaves the
    host."""
    device = resolve_device(device)
    row_axis, col_axis = mesh.axis_names
    nc = mesh.shape[1]
    base, cells = partition_2d(qp, params, mesh.shape)
    seg_m, seg_n, nbmax = cells["seg_m"], cells["seg_n"], cells["nbmax"]
    k = mesh.axis_index(row_axis) * nc + mesh.axis_index(col_axis)
    part = slice(k * nbmax, (k + 1) * nbmax)
    a_cell = BlockSparseMatrix(
        data=torch.as_tensor(cells["data"][part], device=device),
        block_rows=torch.as_tensor(cells["block_rows"][part], device=device),
        block_cols=torch.as_tensor(cells["block_cols"][part], device=device),
        shape=(seg_m, seg_n), padded_shape=(seg_m, seg_n),
        num_real_blocks=nbmax)
    prob = _vectors_to(base, device)._replace(
        a=_attach_layout(a_cell, params, fast=False),
        at=_attach_layout(a_cell.block_transpose(), params, fast=False))
    return prob, Comm2D(row_axis, col_axis, seg_m, seg_n, mesh)


def build_mesh_problem(qp: QuadraticProgram, params: PdhgParams, mesh: Mesh,
                       device="cuda"):
    """This rank's problem on ``mesh`` and the products' mode
    (``_make_matvecs``' ``psum``): the 2-D partition on a 2-D mesh, else
    the block list split over ``params.mesh_axis``.  The problem is scaled
    and split on the host; only this rank's part of A goes to
    ``device``."""
    device = resolve_device(device)
    if len(mesh.shape) == 2:
        return build_2d_problem(qp, params, mesh, device)
    axis = params.mesh_axis
    mesh.axis_index(axis)  # raises on an axis the mesh lacks
    prob = build_device_problem(qp, params, "cpu",
                                pad_blocks_to_multiple_of=mesh.size)
    return (_place_problem(prob, mesh, axis, params, device),
            _Psum(mesh, axis))


def solve(
    qp: QuadraticProgram,
    params: Optional[PdhgParams] = None,
    device="cuda",
    v0=None,
    mesh: Optional[Mesh] = None,
) -> SolveResult:
    """Solve an LP/QP with restarted adaptive PDHG.

    ``device`` defaults to the card and raises where there is none;
    ``device="cpu"`` runs the same solve with the kernels' plain versions.
    ``v0`` is the power-iteration start, of the length of the padded
    variable vector of the problem the PDHG runs on (the reduced one under
    ``presolve``, the 2-D padding's under a 2-D mesh); by default it is
    drawn from a ``torch.Generator`` seeded with 0.

    With ``mesh`` (``parallel.make_mesh``) every rank of the mesh calls
    ``solve`` with the same arguments; the constraint matrix is split over
    the ranks (see the module's docstring) on the mesh's device, and every
    rank returns the same result.
    """
    with span("solve"):
        return _solve(qp, params, device, v0, mesh)


def _solve(qp, params, device, v0, mesh) -> SolveResult:
    params = params or PdhgParams()
    device = resolve_device(device)
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh is on {mesh.device}, the solve asks "
                             f"for {device}")
        device = mesh.device
    shards = 1 if mesh is None else mesh.size
    if params.num_shards not in (1, shards):
        raise ValueError(f"num_shards={params.num_shards}, but the mesh has "
                         f"{shards} devices (the mesh alone sets the shards)")
    perrs = params.validate()
    if perrs:
        return _invalid_result(qp, TerminationReason.INVALID_PARAMETER)
    errs = qp.validate()
    if errs:
        return _invalid_result(qp, TerminationReason.INVALID_PROBLEM)
    start = time.perf_counter()
    if params.presolve:
        return _solve_with_presolve(qp, params, device, v0, start, mesh)
    qp_min = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0

    if mesh is None:
        psum = None
        prob = build_device_problem(qp_min, params, device)
    else:
        prob, psum = build_mesh_problem(qp_min, params, mesh, device)
    compute_stats = _make_compute_stats(params, psum)
    apply_restart = _make_apply_restart(params, psum)
    power_iter = _make_power_iter(params, psum)
    initial_state = _make_initial_state(params, psum)
    warm_state = _make_warm_state(params, psum)
    final_iterate = _make_final_iterate(params.optimality_norm, psum)
    freq = params.termination_check_frequency

    def refresh_products(st: PdhgState) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        return st._replace(ax=mv.matvec(st.x), aty=mv.rmatvec(st.y))

    def time_up() -> bool:
        global host_syncs
        over = time.perf_counter() - start > params.time_sec_limit
        if mesh is not None and math.isfinite(params.time_sec_limit):
            # the ranks' clocks differ: agree, through the card under NCCL
            # (one more host read a major)
            over = mesh.any(over)
            host_syncs += mesh.backend == "nccl"
        return over

    # Mixed-precision majors (bf16 stream) where the bf16 copy is attached
    # (one device only).  Stats for fast majors recompute the current
    # iterate's products with the exact kernel, so termination always
    # rests on exact residuals.
    fast_ready = (
        psum is None
        and params.stream_precision in ("auto", "mixed")
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
    majors = _Majors(prob, params, psum)
    majors.load(initial_state(prob, sigma_max))
    prob_consts = dict(
        norm_b=float(prob.norm_b), norm_c=float(prob.norm_c)
    )

    log: List[dict] = []
    reason = TerminationReason.ITERATION_LIMIT
    best = None  # (which, stats_dict, x, y) chosen at termination
    kkt_at_last_restart = math.inf
    last_candidate_kkt = math.inf
    normalized_gap_at_last_restart = math.inf
    normalized_gap_at_last_trial = math.inf
    iters_at_last_restart = 0
    iterations = 0
    next_polish = 16 * freq

    def _zero_finite(v):
        return torch.where(torch.isfinite(v), torch.zeros_like(v), v)

    def _polish_phase(pprob, pconsts, state0, budget, require):
        """Run exact majors on a modified problem (its vectors copied into
        the majors' problem) until the masked criteria hold; returns
        (x, y, iters) or None on budget/numerical failure."""
        majors.set_problem(pprob)
        majors.load(state0)
        it = 0
        kkt_last = math.inf
        while it < budget:
            stats_p, host_p = majors.major(False)
            it += freq
            curp, avgp = host_p["current"], host_p["average"]
            kkt_c, kkt_a = host_p["kkt_current"], host_p["kkt_average"]
            if not math.isfinite(kkt_c):
                return None
            if _check_optimality(curp, pconsts, params, require):
                return majors.state.x.clone(), majors.state.y.clone(), it
            if _check_optimality(avgp, pconsts, params, require):
                return stats_p["x_avg"].clone(), stats_p["y_avg"].clone(), it
            cand = min(kkt_a, kkt_c)
            if math.isinf(kkt_last):
                kkt_last = cand
            elif cand <= params.sufficient_reduction_for_restart * kkt_last:
                with span("restart"):
                    majors.load(apply_restart(
                        majors.prob, majors.state, kkt_a <= kkt_c,
                        stats_p["x_avg"], stats_p["y_avg"]))
                kkt_last = cand
        return None

    def _try_feasibility_polishing(x_avg, y_avg, avg_stats):
        """Reference TryFeasibilityPolishing (:2442): gate on the
        objective gap, then primal polishing (zero objective) and dual
        polishing (finite bounds zeroed), both warm-started; accept only
        when the combined point passes the FULL criteria.  The main
        state is put back in the buffers either way."""
        if not _check_optimality(avg_stats, prob_consts, params, ("gap",)):
            return None
        budget = max(iterations // 8, freq)
        saved = majors.snapshot()
        try:
            prob_p = prob._replace(
                c=torch.zeros_like(prob.c), q=torch.zeros_like(prob.q),
                orig_c=torch.zeros_like(prob.orig_c),
                orig_q=torch.zeros_like(prob.orig_q),
                norm_c=torch.zeros_like(prob.norm_c))
            consts_p = dict(norm_b=prob_consts["norm_b"], norm_c=0.0)
            st_p = warm_state(prob_p, x_avg, torch.zeros_like(saved.y),
                              saved.step_size, saved.primal_weight)
            rp = _polish_phase(prob_p, consts_p, st_p, budget, ("primal",))
            if rp is None:
                return None
            prob_d = prob._replace(
                con_lb=_zero_finite(prob.con_lb),
                con_ub=_zero_finite(prob.con_ub),
                var_lb=_zero_finite(prob.var_lb),
                var_ub=_zero_finite(prob.var_ub),
                orig_con_lb=_zero_finite(prob.orig_con_lb),
                orig_con_ub=_zero_finite(prob.orig_con_ub),
                orig_var_lb=_zero_finite(prob.orig_var_lb),
                orig_var_ub=_zero_finite(prob.orig_var_ub),
                norm_b=torch.zeros_like(prob.norm_b),
            )
            consts_d = dict(norm_b=0.0, norm_c=prob_consts["norm_c"])
            st_d = warm_state(prob_d, torch.zeros_like(saved.x), y_avg,
                              saved.step_size, saved.primal_weight)
            rd = _polish_phase(prob_d, consts_d, st_d, budget, ("dual",))
            if rd is None:
                return None
        finally:
            majors.set_problem(prob)
            majors.load(saved)
        st_f = warm_state(prob, rp[0], rd[1], saved.step_size,
                          saved.primal_weight)
        curf = _stats_to_host(compute_stats(prob, st_f))["current"]
        if _check_optimality(curf, prob_consts, params):
            return ("polished", curf, st_f.x, st_f.y)
        return None

    fast_mode = fast_ready
    fast_best_kkt = math.inf
    fast_stall = 0

    while True:
        if iterations >= params.iteration_limit:
            reason = TerminationReason.ITERATION_LIMIT
            break
        if time_up():
            reason = TerminationReason.TIME_LIMIT
            break
        was_fast = fast_mode
        # A fast major keeps a copy of the pre-major state so that a
        # non-finite bf16 major can be REWOUND: the corrupted iterate must
        # never leak into the exact retry.
        state_before = majors.snapshot() if fast_mode else None
        stats, host = majors.major(fast_mode)
        iterations += freq
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
                    majors.load(refresh_products(state_before))
                    iterations -= freq
                    continue
                if fast_stall >= 3 or not math.isfinite(cand_fast):
                    fast_mode = False
                    majors.load(refresh_products(majors.state))
        if params.record_iteration_stats or params.verbosity >= 2:
            rec = dict(iteration=iterations, current=cur, average=avg,
                       kkt_current=kkt_cur, kkt_average=kkt_avg,
                       step_size=host["step_size"],
                       primal_weight=host["primal_weight"],
                       kkt_passes=kkt_passes,
                       stream="fast" if was_fast else "exact")
            if host["projections"]:
                rec["point_metadata"] = dict(host["projections"])
            log.append(rec)
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
            best = ("average", avg, stats["x_avg"].clone(),
                    stats["y_avg"].clone())
            break
        # Termination: check both current and average.
        if _check_optimality(cur, prob_consts, params):
            reason = TerminationReason.OPTIMAL
            best = ("current", cur, majors.state.x.clone(),
                    majors.state.y.clone())
            break
        if _check_optimality(avg, prob_consts, params):
            reason = TerminationReason.OPTIMAL
            best = ("average", avg, stats["x_avg"].clone(),
                    stats["y_avg"].clone())
            break
        if kkt_passes >= params.kkt_matrix_pass_limit:
            reason = TerminationReason.KKT_MATRIX_PASS_LIMIT
            break

        if (params.use_feasibility_polishing
                and iterations >= next_polish):
            x_avg, y_avg = stats["x_avg"].clone(), stats["y_avg"].clone()
            with span("polish"):
                polished = _try_feasibility_polishing(x_avg, y_avg, avg)
            next_polish *= 2
            if polished is not None:
                reason = TerminationReason.OPTIMAL
                best = polished
                break
            # the polishing majors overwrote the statistics' buffers
            stats = dict(stats, x_avg=x_avg, y_avg=y_avg)

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
            best = ("current", cur, majors.state.x.clone(),
                    majors.state.y.clone())
            break

        # Restart decision (host scalars only).
        do_restart = False
        use_avg = kkt_avg <= kkt_cur
        cand_kkt = min(kkt_avg, kkt_cur)
        cand_norm_gap = None
        strat = params.restart_strategy
        if strat == RestartStrategy.EVERY_MAJOR_ITERATION:
            do_restart = True
        elif strat == RestartStrategy.ADAPTIVE_HEURISTIC:
            # Reference ChooseRestartToApply
            # (primal_dual_hybrid_gradient.cc:1904): candidates compared
            # by gap/radius^2; restart on sufficient reduction of
            # gap/radius vs the last restart, on necessary reduction with
            # the gap worsening since the last trial, or (forced) when
            # the averaging window spans half the iterations so far.
            tr_cur, tr_avg = host["tr_current"], host["tr_average"]
            use_avg = tr_avg["potential"] < tr_cur["potential"]
            cand = tr_avg if use_avg else tr_cur
            cand_norm_gap = cand["normalized_gap"]
            restart_len = iterations - iters_at_last_restart
            if restart_len >= iterations / 2:
                do_restart = True
            elif math.isfinite(normalized_gap_at_last_restart):
                ratio = cand_norm_gap / max(
                    normalized_gap_at_last_restart, 1e-300
                )
                if ratio < params.sufficient_reduction_for_restart:
                    do_restart = True
                elif (ratio < params.necessary_reduction_for_restart
                      and cand_norm_gap > normalized_gap_at_last_trial):
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
            with span("restart"):
                majors.load(apply_restart(prob, majors.state, use_avg,
                                          stats["x_avg"], stats["y_avg"]))
            kkt_at_last_restart = cand_kkt
            last_candidate_kkt = math.inf
            iters_at_last_restart = iterations
            if cand_norm_gap is not None:
                # reference re-evaluates at the new start point with the
                # new primal weight; the candidate's value is the same
                # quantity up to the weight update
                normalized_gap_at_last_restart = cand_norm_gap
                normalized_gap_at_last_trial = math.inf
            if params.verbosity >= 2:
                print(f"  restart(to_{'avg' if use_avg else 'cur'}) "
                      f"w={float(majors.state.primal_weight):.3e}")
        elif cand_norm_gap is not None:
            if not math.isfinite(normalized_gap_at_last_restart):
                normalized_gap_at_last_restart = cand_norm_gap
            else:
                normalized_gap_at_last_trial = cand_norm_gap

    if best is None:
        # Terminated by a limit: report the better of current/average.
        stats, host = majors.stats(fast_mode)
        if host["kkt_average"] < host["kkt_current"]:
            best = ("average", host["average"], stats["x_avg"].clone(),
                    stats["y_avg"].clone())
        else:
            best = ("current", host["current"], majors.state.x.clone(),
                    majors.state.y.clone())

    which, bstats, x_dev, y_dev = best
    n, m = qp.num_variables, qp.num_constraints

    def to_np(v, k):
        return v.to(torch.float64).cpu().numpy()[:k]

    with span("final"):
        # Unscale and unpad; recompute reduced costs for the reported
        # iterate.
        final = final_iterate(prob, x_dev, y_dev)
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
        kkt_matrix_passes=float(majors.state.kkt_passes),
        solve_time_sec=time.perf_counter() - start,
        iteration_stats=log,
    )


def _solve_with_presolve(qp: QuadraticProgram, params: PdhgParams, device,
                         v0, start: float, mesh=None) -> SolveResult:
    """Presolve -> solve reduced -> postsolve (reference
    PreprocessSolver::PreprocessAndSolve with glop presolve, :1145)."""
    from ortools_tpu_torch.glop.presolve import PresolveStatus, presolve

    qp_min = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0
    pres = presolve(qp_min)
    if pres.status in (PresolveStatus.PRIMAL_INFEASIBLE,
                       PresolveStatus.DUAL_INFEASIBLE):
        res = _invalid_result(qp, TerminationReason[pres.status.name])
        res.solve_time_sec = time.perf_counter() - start
        return res
    sub_params = dataclasses.replace(params, presolve=False)
    reduced = pres.reduced
    if reduced.num_variables == 0:
        x = pres.postsolve(np.zeros(0))
        y, rc = pres.postsolve_duals(qp_min, x, np.zeros(0))
        obj = sign * qp_min.objective_value(x)
        return SolveResult(
            termination_reason=TerminationReason.OPTIMAL,
            primal_solution=x, dual_solution=sign * y,
            reduced_costs=sign * rc,
            primal_objective=obj, dual_objective=obj,
            primal_residual=0.0, dual_residual=0.0, relative_gap=0.0,
            iterations=0, kkt_matrix_passes=0.0,
            solve_time_sec=time.perf_counter() - start,
            iteration_stats=[],
        )
    sub = solve(reduced, sub_params, device=device, v0=v0, mesh=mesh)
    if sub.termination_reason not in (
        TerminationReason.OPTIMAL,
        TerminationReason.ITERATION_LIMIT,
        TerminationReason.TIME_LIMIT,
        TerminationReason.KKT_MATRIX_PASS_LIMIT,
    ):
        # infeasibility of the reduced problem implies the original's
        res = _invalid_result(qp, sub.termination_reason)
        res.solve_time_sec = time.perf_counter() - start
        return res
    x = pres.postsolve(sub.primal_solution)
    y, rc = pres.postsolve_duals(qp_min, x, sub.dual_solution)
    return dataclasses.replace(
        sub,
        primal_solution=x,
        dual_solution=sign * y,
        reduced_costs=sign * rc,
        # sub solved the min-sense reduced problem; report original sense
        primal_objective=sign * sub.primal_objective,
        dual_objective=sign * sub.dual_objective,
        solve_time_sec=time.perf_counter() - start,
    )
