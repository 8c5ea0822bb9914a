"""Device-side feasibility jump: multi-seed weighted-violation local search
over binary linear systems, in PyTorch (port of
``ortools_tpu/sat/fj_device.py``).

Capability parity: ``ortools/sat/feasibility_jump.h:48`` +
``constraint_violation.h:33-270`` — the violation-guided jump heuristic
(Luteberget & Sartor 2023) that the reference runs as several portfolio
workers with different seeds.

- S seeds advance together: the JAX module ``vmap``s one seed's scan over
  the seeds; here the seed axis is written out.  x is [S, n], the row
  activities and weights are [S, m];
- each step scores every flip of every seed at once: the score tensor
  ``[S, m, n]`` is ``act[..., :, None] + A * delta[:, None, :]``, then a
  clip and a weighted reduction over m (``flip_gains``); ``argmax`` over n
  picks each seed's flip, and the flip and the random kick go through
  ``gather``/``scatter`` along dim 1 with [S] index tensors;
- a round of ``steps_per_round`` steps runs with no host read
  (``run_round``), as JAX's one jitted dispatch does; the host reads the
  violation totals once per round;
- weights bump additively on plateaus exactly like the reference's
  ``UpdateViolatedConstraintWeights``, and an explicit ``torch.Generator``
  on the solve's device, seeded from ``seed``, drives random plateau
  acceptance and the kicks.  Its numbers are not ``jax.random``'s, so the
  trajectory differs from the JAX module's for the same seed.

Scope: binary variables only.  General-integer models stay on the host
version (sat/feasibility_jump.py); every solution found here is
RE-VERIFIED on the host before anyone calls it an incumbent (A.9
contract).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ortools_tpu_torch.utils.device import resolve_device

_BIG = 1e9


@dataclasses.dataclass
class DeviceFjResult:
    """Feasible 0/1 points found (host-verified), plus step statistics."""

    solutions: List[np.ndarray]
    rounds_run: int
    moves_per_second: float
    wall_time_sec: float


class FjSystem(NamedTuple):
    """The linear system on the device, in f32: A [m, n], its transpose
    (the columns the flips add), and the row bounds with infinities
    replaced by ±1e9."""

    a: torch.Tensor
    at: torch.Tensor
    rlo: torch.Tensor
    rhi: torch.Tensor


class FjState(NamedTuple):
    """The seeds' points x [S, n], row activities [S, m] and row weights
    [S, m], updated in place by ``run_round``."""

    x: torch.Tensor
    act: torch.Tensor
    w: torch.Tensor


def _np_f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def make_system(a_d: np.ndarray, row_lb: np.ndarray, row_ub: np.ndarray,
                device) -> FjSystem:
    """Upload the dense f32 matrix ``a_d`` and its row bounds."""
    rlo = _np_f32(np.where(np.isfinite(row_lb), row_lb, -_BIG))
    rhi = _np_f32(np.where(np.isfinite(row_ub), row_ub, _BIG))
    a = torch.as_tensor(a_d, device=device)
    return FjSystem(a=a, at=a.t().contiguous(),
                    rlo=torch.as_tensor(rlo, device=device),
                    rhi=torch.as_tensor(rhi, device=device))


def violation(sys: FjSystem, act: torch.Tensor) -> torch.Tensor:
    """Per-row violation of activities [..., m]."""
    return (torch.clamp(sys.rlo - act, min=0.0)
            + torch.clamp(act - sys.rhi, min=0.0))


def flip_gains(sys: FjSystem, x: torch.Tensor, act: torch.Tensor,
               w: torch.Tensor, cur_v: torch.Tensor) -> torch.Tensor:
    """Weighted violation decrease of flipping each variable, [S, n]: the
    JAX module's ``one_step`` score (fj_device.py:95-102) for every seed;
    ``cur_v`` is ``violation(sys, act)``."""
    delta = 1.0 - 2.0 * x  # flip direction per variable, [S, n]
    # new activity of every flip, [S, m, n]
    new_act = act.unsqueeze(2) + sys.a * delta.unsqueeze(1)
    new_v = (torch.clamp(sys.rlo[:, None] - new_act, min=0.0)
             + torch.clamp(new_act - sys.rhi[:, None], min=0.0))
    return torch.einsum("sm,smn->sn", w, cur_v.unsqueeze(2) - new_v)


def _flip(sys: FjSystem, x: torch.Tensor, act: torch.Tensor,
          j: torch.Tensor, where: torch.Tensor) -> None:
    """Flip x[s, j[s]] and add its column to act[s] where ``where[s]``."""
    xj = x.gather(1, j[:, None])
    d = torch.where(where[:, None], 1.0 - 2.0 * xj, torch.zeros_like(xj))
    x.scatter_(1, j[:, None], xj + d)
    act.add_(sys.at[j] * d)


def one_step(sys: FjSystem, st: FjState, u: torch.Tensor, jk: torch.Tensor,
             plateau_prob: float) -> None:
    """One move of every seed (fj_device.py:94-122), in place; ``u`` [S]
    are the plateau draws in [0, 1) and ``jk`` [S] the kick variables."""
    x, act, w = st
    cur_v = violation(sys, act)
    gain = flip_gains(sys, x, act, w, cur_v)
    best, j = torch.max(gain, dim=1)
    take_plateau = (best > -1e-6) & (u < plateau_prob)
    do_move = (best > 1e-6) | take_plateau
    # plateau with no move: bump violated-row weights (additive,
    # reference UpdateViolatedConstraintWeights) and kick one random
    # variable to escape
    w.add_((cur_v > 1e-6) & ~do_move[:, None])
    _flip(sys, x, act, j, do_move)
    _flip(sys, x, act, jk, ~do_move)


def run_round(sys: FjSystem, st: FjState, gen: torch.Generator,
              steps: int, plateau_prob: float) -> None:
    """``steps`` moves of every seed with no host read: the round's random
    numbers are drawn on the device up front."""
    n_seeds, n = st.x.shape
    dev = st.x.device
    u = torch.rand((steps, n_seeds), generator=gen, device=dev)
    jk = torch.randint(0, n, (steps, n_seeds), generator=gen, device=dev)
    for k in range(steps):
        one_step(sys, st, u[k], jk[k], plateau_prob)


def initial_state(sys: FjSystem, n_seeds: int, gen: torch.Generator,
                  x0: Optional[np.ndarray] = None) -> FjState:
    """Each seed starts at ``x0`` with a tenth of its bits flipped, or at a
    random point."""
    m, n = sys.a.shape
    dev = sys.a.device
    if x0 is not None:
        base = torch.as_tensor(_np_f32(np.clip(np.round(x0), 0, 1)),
                               device=dev)
        flips = torch.rand((n_seeds, n), generator=gen, device=dev) < 0.1
        x = torch.where(flips, 1.0 - base[None, :], base[None, :])
    else:
        x = (torch.rand((n_seeds, n), generator=gen, device=dev)
             < 0.5).to(torch.float32)
    act = x @ sys.at
    w = torch.ones((n_seeds, m), dtype=torch.float32, device=dev)
    return FjState(x.contiguous(), act, w)


def device_feasibility_jump(
    a,  # scipy sparse or dense [m, n]
    row_lb: np.ndarray,
    row_ub: np.ndarray,
    n_seeds: int = 64,
    steps_per_round: int = 128,
    max_rounds: int = 50,
    seed: int = 0,
    x0: Optional[np.ndarray] = None,
    deadline: float = math.inf,
    stop_after: int = 1,
    plateau_prob: float = 0.3,
    device="cuda",
) -> DeviceFjResult:
    """Run the multi-seed device FJ until `stop_after` verified feasible
    points are found, `max_rounds` rounds elapse, or `deadline`
    (perf_counter time) passes.

    To search for an IMPROVING solution rather than any feasible one,
    append the objective cutoff row ``c.x <= ub - eps`` to (a, row_lb,
    row_ub) before calling — the reference's objective mode does exactly
    this (feasibility_jump.h "decrease the objective of an already
    feasible solution").
    """
    dev = resolve_device(device)
    a_d = _np_f32(np.asarray(a.todense()) if hasattr(a, "todense") else a)
    sys = make_system(a_d, row_lb, row_ub, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = initial_state(sys, n_seeds, gen, x0)

    solutions: List[np.ndarray] = []
    seen: set = set()
    t0 = time.perf_counter()
    rounds = 0
    for _ in range(max_rounds):
        if time.perf_counter() > deadline:
            break
        run_round(sys, st, gen, steps_per_round, plateau_prob)
        # the round's one read: the violation totals
        tot = violation(sys, st.act).sum(dim=1).cpu().numpy()
        rounds += 1
        if (tot <= 1e-4).any():
            xs_h = st.x.cpu().numpy()
            for s in np.nonzero(tot <= 1e-4)[0]:
                x_cand = np.round(xs_h[s]).astype(np.float64)
                # host-side re-verification (A.9 contract)
                act_h = a_d.astype(np.float64) @ x_cand
                if ((act_h >= row_lb - 1e-6).all()
                        and (act_h <= row_ub + 1e-6).all()):
                    key_b = x_cand.tobytes()
                    if key_b not in seen:
                        seen.add(key_b)
                        solutions.append(x_cand)
            if len(solutions) >= stop_after:
                break
    dt = time.perf_counter() - t0
    moves = rounds * steps_per_round * n_seeds
    return DeviceFjResult(
        solutions=solutions,
        rounds_run=rounds,
        moves_per_second=moves / max(dt, 1e-9),
        wall_time_sec=dt,
    )


def objective_descent_system(
    a, row_lb, row_ub, c: np.ndarray, cutoff: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Append the objective cutoff row ``c.x <= cutoff`` (the reference's
    FJ objective mode): any zero-violation point strictly improves."""
    import scipy.sparse as sp

    a_s = sp.csr_matrix(a)
    row = sp.csr_matrix(np.asarray(c, dtype=np.float64)[None, :])
    a2 = sp.vstack([a_s, row], format="csr")
    lb2 = np.concatenate([row_lb, [-np.inf]])
    ub2 = np.concatenate([row_ub, [cutoff]])
    return a2, lb2, ub2
