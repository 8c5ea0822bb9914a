"""Batched PDHG: B LPs that share one matrix and objective but have their
own variable bounds, solved together (port of
``ortools_tpu/pdlp/batched.py``).

Branch-and-bound nodes differ from the root LP only in variable bounds, so
a batch of B node LPs is a leading axis over the variable bounds and the
state, with the matrix shared: every product becomes a batched product
(on a card the ``block_spmm_exact`` kernel, or ``block_spmm_rows`` over the
row layout of a low-fill matrix), and one major advances all B
solves.  Used by ``mip/node_lp.py::PdhgNodeBackend`` for node bounding and
usable directly for scenario batches.

What differs from the JAX module:

- The JAX module ``jax.vmap``s the single-device functions.  The port runs
  the single-device functions of ``pdlp/solver.py`` themselves on [B, N]
  vectors and [B, 1] scalars, and a major is ``solver._Majors`` on batched
  buffers: a CUDA graph of attempt slots on a card, in which an instance
  that has its iterations changes nothing, as under the vmapped loop.
- The host reads every per-instance scalar of a major in one copy (a
  [K, B] matrix).  The iterates of the instances that finish are kept on
  the device (a selection into a [B, N] buffer), and the final iterates
  come to the host in one copy at the end.
- Power iteration runs once, on the shared (unbatched) problem, through
  the exact SpMV kernel.
- The JAX module memoizes its jitted functions (``_BATCH_FN_CACHE``).  The
  port keeps a ``BatchSolver``: the scaled problem, σ_max and the majors
  with their captured graphs, reused by every call with the same batch
  size (a new batch's bounds are copied into the majors' problem, as
  polishing does).  ``solve_batch`` builds one per call;
  ``PdhgNodeBackend`` keeps one across its calls.
- ``device`` and the power-iteration start ``v0`` are arguments, as in
  ``solver.solve``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.pdlp import solver as S
from ortools_tpu_torch.pdlp.params import PdhgParams, RestartStrategy
from ortools_tpu_torch.utils.device import resolve_device
from ortools_tpu_torch.utils.tracing import count, span


@dataclasses.dataclass
class BatchSolveResult:
    # All arrays have leading batch dim B.
    primal_objective: np.ndarray
    dual_objective: np.ndarray
    # Mathematically valid per-instance lower bound on the LP optimum
    # derived from the dual iterate alone (exact Lagrangian dual value;
    # -inf when the iterate certifies nothing).  Safe for B&B pruning even
    # when `optimal` is False.
    dual_bound: np.ndarray
    primal_residual: np.ndarray
    dual_residual: np.ndarray
    optimal: np.ndarray  # bool
    # Verified infeasibility certificates (reference termination.h:74):
    # primal_infeasible[i] — a dual ray proves instance i's LP infeasible.
    primal_infeasible: np.ndarray  # bool
    dual_infeasible: np.ndarray  # bool (unbounded LP)
    primal_solution: np.ndarray  # [B, n] original space
    dual_solution: np.ndarray  # [B, m]
    iterations: int


# BatchSolvers built so far (each scales its problem, runs power iteration
# and, on a card, captures its own graphs); a plain counter that callers
# may reset and read.
solvers_built = 0


def _select_state(mask: torch.Tensor, a: S.PdhgState,
                  b: S.PdhgState) -> S.PdhgState:
    """Per-instance select between two batched states (mask [B, 1])."""
    return S.PdhgState(*[torch.where(mask, x, y) for x, y in zip(a, b)])


class BatchSolver:
    """The batched solve of one LP at a fixed batch size B, kept for
    repeated calls: the scaled problem on the device, σ_max, and the
    majors with their buffers and (on a card) their captured graphs.  A
    call gives the same result as a fresh solver's."""

    def __init__(self, qp: QuadraticProgram, params: Optional[PdhgParams],
                 batch_size: int, device="cuda", v0=None):
        global solvers_built
        solvers_built += 1
        self.params = params or PdhgParams()
        self.device = resolve_device(device)
        self.qp = qp.as_minimization()
        self.batch_size = batch_size
        # The batched solve has no bf16 stream (the JAX module drops the
        # fused layout): the layout goes without its bf16 copy.
        self.prob = S.build_device_problem(
            self.qp, dataclasses.replace(self.params,
                                         stream_precision="exact"),
            self.device)
        nn = self.prob.c.shape[0]
        if v0 is None:
            gen = torch.Generator(device="cpu").manual_seed(0)
            v0 = torch.randn(nn, generator=gen, dtype=torch.float64)
        if not isinstance(v0, torch.Tensor):
            v0 = torch.tensor(np.asarray(v0, dtype=np.float64))
        v0 = v0.to(dtype=self.prob.c.dtype, device=self.device)
        if v0.shape != (nn,):
            raise ValueError(f"v0 must have length {nn}, got "
                             f"{tuple(v0.shape)}")
        self.sigma = S._make_power_iter(self.params)(self.prob, v0)
        self.col_scale = self.prob.col_scale.double().cpu().numpy()
        self.row_scale = self.prob.row_scale.double().cpu().numpy()
        self.norm_b = float(self.prob.norm_b)
        self.norm_c = float(self.prob.norm_c)
        self.majors: Optional[S._Majors] = None
        self._initial_state = S._make_initial_state(self.params)
        self._apply_restart = S._make_apply_restart(self.params)
        self._final_iterate = S._make_final_iterate(
            self.params.optimality_norm)

    def _batched_problem(self, lbs: np.ndarray,
                         ubs: np.ndarray) -> S.DeviceProblem:
        """The problem with the batch's variable bounds, [B, N]: original
        and scaled (padded variables fixed at 0)."""
        n, nn = self.qp.num_variables, self.prob.c.shape[0]
        dtype = self.prob.c.dtype

        def pad(vb):
            out = np.zeros((self.batch_size, nn))
            out[:, :n] = vb
            return torch.as_tensor(out, dtype=dtype, device=self.device)

        cs = self.col_scale[:n]
        return self.prob._replace(
            var_lb=pad(lbs / cs), var_ub=pad(ubs / cs),
            orig_var_lb=pad(lbs), orig_var_ub=pad(ubs))

    def _start(self, lbs, ubs, warm_start_x, warm_start_y) -> None:
        """Load the batch's bounds into the majors' problem (the majors are
        made at the first call) and its start into their buffers."""
        vprob = self._batched_problem(lbs, ubs)
        if self.majors is None:
            self.majors = S._Majors(vprob, self.params)
        else:
            self.majors.set_problem(vprob)
        prob = self.majors.prob
        state = self._initial_state(prob, self.sigma)
        if warm_start_x is not None:
            n, nn = self.qp.num_variables, prob.c.shape[0]
            dtype = prob.c.dtype
            xw = np.zeros((self.batch_size, nn))
            xw[:, :n] = np.clip(warm_start_x, lbs, ubs)
            xs = torch.as_tensor(xw / self.col_scale[None, :], dtype=dtype,
                                 device=self.device)
            yw = np.zeros((self.batch_size, prob.con_lb.shape[0]))
            if warm_start_y is not None:
                yw[:, : self.qp.num_constraints] = warm_start_y
            ys = torch.as_tensor(yw / self.row_scale[None, :], dtype=dtype,
                                 device=self.device)
            state = state._replace(x=xs, y=ys, ax=prob.a.matvec(xs),
                                   aty=prob.at.matvec(ys), x_restart=xs,
                                   y_restart=ys)
        self.majors.load(state)

    def solve(self, var_lb_batch: np.ndarray, var_ub_batch: np.ndarray,
              warm_start_x: Optional[np.ndarray] = None,
              warm_start_y: Optional[np.ndarray] = None,
              deadline: float = math.inf,
              iteration_limit: Optional[int] = None) -> BatchSolveResult:
        """``solve_batch``'s contract on this solver's problem.  The device
        code does not read the iteration limit, so a call may set its own
        (``iteration_limit``; by default the solver's params').

        Counts, for ``utils/tracing.py``, at the call's end, so that a
        batch's counts fall on one side of a profiler session's marks: the
        instances open at each major (``batch_open`` of
        ``batch_instances``), and every instance (``nodes_finished``) with
        the iteration at which it ended: proven at a major, or at the
        call's limit (``node_iterations``)."""
        with span("batch_solve"):
            return self._solve(var_lb_batch, var_ub_batch, warm_start_x,
                               warm_start_y, deadline, iteration_limit)

    def _solve(self, var_lb_batch, var_ub_batch, warm_start_x, warm_start_y,
               deadline, iteration_limit) -> BatchSolveResult:
        params = self.params
        if iteration_limit is None:
            iteration_limit = params.iteration_limit
        qp = self.qp
        bsz, n = var_lb_batch.shape
        if (bsz != self.batch_size or var_ub_batch.shape != (bsz, n)
                or n != qp.num_variables):
            raise ValueError(
                f"bounds must be [{self.batch_size}, {qp.num_variables}], "
                f"got {var_lb_batch.shape} and {var_ub_batch.shape}")
        with span("batch_start"):
            self._start(var_lb_batch, var_ub_batch, warm_start_x,
                        warm_start_y)
        majors = self.majors
        majors.returned = None  # the host loop is timed within a call
        device = self.device
        freq = params.termination_check_frequency
        norm_b, norm_c = self.norm_b, self.norm_c
        eps_a, eps_r = params.eps_optimal_absolute, params.eps_optimal_relative

        def optimal_mask(st: dict) -> np.ndarray:
            p, d = st["primal_objective"], st["dual_objective"]
            return (
                (np.abs(p - d) <= eps_a + eps_r * (np.abs(p) + np.abs(d)))
                & (st["primal_residual"] <= eps_a + eps_r * norm_b)
                & (st["dual_residual"] <= eps_a + eps_r * norm_c)
            )

        def on_device(mask: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(mask[:, None], device=device)

        # The iterate of each instance at the major where it finished, in
        # scaled space, selected into these buffers on the device.
        best_x = torch.zeros_like(majors.state.x)
        best_y = torch.zeros_like(majors.state.y)

        def snapshot(mask: np.ndarray, x: torch.Tensor, y: torch.Tensor):
            if mask.any():
                m = on_device(mask)
                torch.where(m, x, best_x, out=best_x)
                torch.where(m, y, best_y, out=best_y)

        iterations = 0
        done = np.zeros(bsz, dtype=bool)
        ended_at = np.zeros(bsz, dtype=np.int64)  # iterations, once done
        batch_open = batch_majors = 0  # counted at the end, with the nodes
        optimal = np.zeros(bsz, dtype=bool)
        primal_infeasible = np.zeros(bsz, dtype=bool)
        dual_infeasible = np.zeros(bsz, dtype=bool)
        kkt_at_restart = np.full(bsz, np.inf)
        last_cand_kkt = np.full(bsz, np.inf)
        iters_at_restart = np.zeros(bsz)
        best_stats: List[Optional[dict]] = [None] * bsz

        def record(mask: np.ndarray, src: dict) -> None:
            for i in np.nonzero(mask)[0]:
                best_stats[i] = {k: float(v[i]) for k, v in src.items()}

        while iterations < iteration_limit and not done.all():
            if time.perf_counter() > deadline:
                break
            batch_open += int(bsz - done.sum())
            batch_majors += 1
            stats, host = majors.major(False)
            iterations += freq
            cur, avg = host["current"], host["average"]
            kkt_cur, kkt_avg = host["kkt_current"], host["kkt_average"]
            ok_cur = optimal_mask(cur) & ~done
            ok_avg = optimal_mask(avg) & ~done & ~ok_cur
            snapshot(ok_cur, majors.state.x, majors.state.y)
            snapshot(ok_avg, stats["x_avg"], stats["y_avg"])
            record(ok_cur, cur)
            record(ok_avg, avg)
            done |= ok_cur | ok_avg
            ended_at[ok_cur | ok_avg] = iterations
            optimal |= ok_cur | ok_avg
            if done.all():
                break
            # Verified infeasibility certificates (reference
            # termination.h:74): both candidate rays (iterate difference
            # and current iterate) per instance; a certified instance is
            # done.
            eps_pi = params.eps_primal_infeasible
            eps_di = params.eps_dual_infeasible
            for key in ("infeas_diff", "infeas_current"):
                inf = host[key]
                ny, nx = inf["ray_norm_y"], inf["ray_norm_x"]
                pinf = ((ny > 0)
                        & (inf["max_dual_ray_infeasibility"] <= eps_pi * ny)
                        & (inf["dual_ray_objective"] > 0) & ~done)
                dinf = ((nx > 0)
                        & (inf["max_primal_ray_infeasibility"] <= eps_di * nx)
                        & (inf["max_quadratic_ray"] <= eps_di * nx)
                        & (inf["primal_ray_objective"] < 0) & ~done & ~pinf)
                certified = pinf | dinf
                snapshot(certified, majors.state.x, majors.state.y)
                record(certified, cur)
                primal_infeasible |= pinf
                dual_infeasible |= dinf
                done |= certified
                ended_at[certified] = iterations
            if done.all():
                break
            # restart decision per instance (host numpy)
            use_avg = kkt_avg <= kkt_cur
            cand = np.minimum(kkt_avg, kkt_cur)
            if params.restart_strategy == RestartStrategy.ADAPTIVE_HEURISTIC:
                # the reference's trust-region criterion per instance
                # (primal_dual_hybrid_gradient.cc:1904)
                tr_cur, tr_avg = host["tr_current"], host["tr_average"]
                use_avg = tr_avg["potential"] < tr_cur["potential"]
                cand_ng = np.where(use_avg, tr_avg["normalized_gap"],
                                   tr_cur["normalized_gap"])
                forced = (iterations - iters_at_restart) >= iterations / 2
                fresh = np.isinf(kkt_at_restart)  # reused as ng_at_restart
                ratio = cand_ng / np.maximum(kkt_at_restart, 1e-300)
                nec = (ratio < params.necessary_reduction_for_restart) & (
                    cand_ng > last_cand_kkt  # reused as ng_at_last_trial
                )
                do_restart = (
                    forced
                    | (~fresh
                       & ((ratio < params.sufficient_reduction_for_restart)
                          | nec))
                ) & ~done
                kkt_at_restart = np.where(fresh, cand_ng, kkt_at_restart)
                cand = cand_ng
            elif params.restart_strategy == RestartStrategy.ADAPTIVE_KKT:
                fresh = np.isinf(kkt_at_restart)
                kkt_at_restart = np.where(fresh, cand, kkt_at_restart)
                suff = cand <= (params.sufficient_reduction_for_restart
                                * kkt_at_restart)
                nec = (cand <= params.necessary_reduction_for_restart
                       * kkt_at_restart) & (cand > last_cand_kkt)
                long_i = (iterations - iters_at_restart) >= (
                    params.artificial_restart_threshold * iterations)
                do_restart = (~fresh) & (suff | nec | long_i) & ~done
            elif (params.restart_strategy
                  == RestartStrategy.EVERY_MAJOR_ITERATION):
                do_restart = ~done
            else:
                do_restart = np.zeros(bsz, dtype=bool)
            last_cand_kkt = cand
            if do_restart.any():
                with span("restart"):
                    restarted = self._apply_restart(
                        majors.prob, majors.state, on_device(use_avg),
                        stats["x_avg"], stats["y_avg"])
                    majors.load(_select_state(on_device(do_restart),
                                              restarted, majors.state))
                kkt_at_restart = np.where(do_restart, cand, kkt_at_restart)
                last_cand_kkt = np.where(do_restart, np.inf, last_cand_kkt)
                iters_at_restart = np.where(do_restart, iterations,
                                            iters_at_restart)

        ended_at[~done] = iterations
        count("batch_open", batch_open)
        count("batch_instances", bsz * batch_majors)
        count("nodes_finished", bsz)
        count("node_iterations", int(ended_at.sum()))

        # Fill unfinished instances with their better candidate.
        unfilled = np.array([s is None for s in best_stats])
        if unfilled.any():
            stats, host = majors.stats(False)
            take_avg = (host["kkt_average"] < host["kkt_current"]) & unfilled
            take_cur = unfilled & ~take_avg
            snapshot(take_avg, stats["x_avg"], stats["y_avg"])
            snapshot(take_cur, majors.state.x, majors.state.y)
            record(take_avg, host["average"])
            record(take_cur, host["current"])

        fin = self._final_iterate(majors.prob, best_x, best_y)
        nn = fin["x"].shape[-1]
        both = S._to_host(torch.cat([fin["x"], fin["y"]], dim=-1)).to(
            torch.float64).numpy()
        x_orig = both[:, :n]
        y_orig = both[:, nn: nn + qp.num_constraints]

        const = qp.objective_constant
        return BatchSolveResult(
            primal_objective=np.array(
                [s["primal_objective"] + const for s in best_stats]),
            dual_objective=np.array(
                [s["dual_objective"] + const for s in best_stats]),
            dual_bound=np.array(
                [s.get("dual_bound", -math.inf) + const for s in best_stats]),
            primal_residual=np.array([s["primal_residual"]
                                      for s in best_stats]),
            dual_residual=np.array([s["dual_residual"] for s in best_stats]),
            optimal=optimal,
            primal_infeasible=primal_infeasible,
            dual_infeasible=dual_infeasible,
            primal_solution=x_orig,
            dual_solution=y_orig,
            iterations=iterations,
        )


def solve_batch(
    qp: QuadraticProgram,
    var_lb_batch: np.ndarray,
    var_ub_batch: np.ndarray,
    params: Optional[PdhgParams] = None,
    warm_start_x: Optional[np.ndarray] = None,
    warm_start_y: Optional[np.ndarray] = None,
    deadline: float = math.inf,
    device="cuda",
    v0=None,
) -> BatchSolveResult:
    """Solve B LPs sharing qp's matrix/objective but with per-instance
    variable bounds.  Bounds are in the ORIGINAL problem space.

    Warm starts (e.g. parent-node iterates in B&B) are original-space too.
    ``deadline`` (perf_counter time) is checked before every major; on
    expiry the call returns with whatever each instance has proven so far
    (unproven instances report their safe Lagrangian dual bound and
    optimal=False — callers never prune on those).

    ``device`` defaults to the card and raises where there is none;
    ``device="cpu"`` runs the same solve with the kernels' plain versions.
    ``v0`` is the power-iteration start (length of the padded variable
    vector); by default it is drawn from a ``torch.Generator`` seeded with
    0.  Each call builds its own ``BatchSolver``; keep one to solve many
    batches of the same LP.
    """
    solver = BatchSolver(qp, params, var_lb_batch.shape[0], device=device,
                         v0=v0)
    return solver.solve(var_lb_batch, var_ub_batch, warm_start_x,
                        warm_start_y, deadline)
