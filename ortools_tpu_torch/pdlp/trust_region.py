"""Trust-region subproblems for PDLP's adaptive-heuristic restarts (port of
``ortools_tpu/pdlp/trust_region.py``).

``solve_joint_trust_region`` minimizes a linear objective over a
box-constrained Euclidean ball (reference ``trust_region.h:59``), and
``localized_gap`` evaluates the "localized duality gap" that the
ADAPTIVE_HEURISTIC restart rule compares
(``primal_dual_hybrid_gradient.cc:1904``).  The ball multiplier solves the
monotone scalar equation phi(lambda) = r^2 by 60 steps of log-space
bisection over one vector of length n + m, as in the JAX module.

Every function is torch ops with no read of a device value, so that the
per-major statistics that call it can be captured in a CUDA graph.  All
computation is in the solver's scaled space.  For a batch, vectors are
[B, n] (a shared [n] bound broadcasts over them), ``omega`` and ``radius``
[B, 1], and each instance solves its own subproblem.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ortools_tpu_torch.ops.df32 import dot, vsum


class TrustRegionResult(NamedTuple):
    primal_delta_objective: torch.Tensor  # gx . dx  (<= 0)
    dual_delta_objective: torch.Tensor  # gy . dy   (>= 0)
    gap: torch.Tensor  # dual_delta - primal_delta >= 0


def solve_joint_trust_region(gx, gy, x, y, lb, ub, ylb, yub, omega, radius,
                             num_bisections: int = 60) -> TrustRegionResult:
    """min gx.(x'-x) - gy.(y'-y)  s.t.  x' in [lb,ub], y' in [ylb,yub],
    (omega/2)||x'-x||^2 + (1/(2 omega))||y'-y||^2 <= radius^2.

    Solution: d(lambda) = clip(-g / (2 lambda w), box) with lambda >= 0 the
    ball multiplier; phi(lambda) = sum w d^2 is decreasing, solved for
    phi(lambda) = r^2 by bisection (lambda = 0 when the box optimum is
    already inside the ball).  ``omega`` and ``radius`` are 0-d tensors or
    numbers; for a batch, [B, 1]."""
    dtype, device = gx.dtype, gx.device
    omega = torch.as_tensor(omega, dtype=dtype, device=device)
    radius = torch.as_tensor(radius, dtype=dtype, device=device)

    def like(v, ref):  # a shared bound broadcast over the batch
        return v if v.shape == ref.shape else v.expand(ref.shape)

    g = torch.cat([gx, -gy], dim=-1)
    z = torch.cat([x, y], dim=-1)
    # clamp: the center must lie inside the box (guard roundoff)
    lo = torch.clamp(torch.cat([like(lb, x), like(ylb, y)], dim=-1) - z,
                     max=0.0)
    hi = torch.clamp(torch.cat([like(ub, x), like(yub, y)], dim=-1) - z,
                     min=0.0)
    w = torch.cat([(omega / 2.0).expand(gx.shape),
                   (1.0 / (2.0 * omega)).expand(gy.shape)], dim=-1)
    r2 = radius * radius

    def phi(lam):
        d = torch.clamp(-g / (2.0 * lam * w), lo, hi)
        return vsum(w * d * d), d

    # lambda upper bound: |d| <= |g|/(2 lam w) => phi <= q / (4 lam^2)
    # with q = sum g^2 / w; phi(lam_hi) <= r^2.
    q = vsum(g * g / w)
    tiny = torch.finfo(dtype).tiny
    lam_hi = torch.sqrt(q) / (2.0 * torch.clamp(radius, min=tiny)) + tiny
    # box optimum (lambda -> 0): full move toward the favorable bound
    d0 = torch.where(g > 0, lo, torch.where(g < 0, hi, 0.0))
    phi0 = vsum(w * d0 * d0)

    lam_lo = lam_hi * (1e-30 if dtype == torch.float64 else 1e-12)
    lam_up = lam_hi
    for _ in range(num_bisections):
        mid = torch.sqrt(lam_lo * lam_up)  # log-space bisection
        val, _ = phi(mid)
        above = val > r2
        lam_lo, lam_up = (torch.where(above, mid, lam_lo),
                          torch.where(above, lam_up, mid))
    _, d_ball = phi(lam_up)
    d = torch.where(phi0 <= r2, d0, d_ball)

    n = gx.shape[-1]
    primal_delta = dot(gx, d[..., :n])
    dual_delta = dot(gy, d[..., n:])
    return TrustRegionResult(
        primal_delta_objective=primal_delta,
        dual_delta_objective=dual_delta,
        gap=dual_delta - primal_delta,
    )


def dual_bounds(con_lb, con_ub):
    """The dual variable domain per row (PDLP saddle-point formulation):
    [0, inf) when only the lower bound is finite, (-inf, 0] when only the
    upper is, free for ranged rows, {0} when both are infinite."""
    lb_fin = torch.isfinite(con_lb)
    ub_fin = torch.isfinite(con_ub)
    zero = torch.zeros_like(con_lb)
    # finite u forbids nothing below; infinite u forces y >= 0 (and vice
    # versa); both infinite collapses to {0}
    ylb = torch.where(ub_fin, -math.inf, zero)
    yub = torch.where(lb_fin, math.inf, zero)
    return ylb, yub


def dual_subgradient(con_lb, con_ub, y, ax):
    """Reference DualSubgradientCoefficient
    (sharded_optimization_utils.h:149): l when y > 0, u when y < 0; at
    y == 0 the finite bound if only one is finite, clip(ax, l, u) if both
    are, 0 if none."""
    lb_fin = torch.isfinite(con_lb)
    ub_fin = torch.isfinite(con_ub)
    at_zero = torch.where(
        lb_fin & ub_fin, torch.clamp(ax, con_lb, con_ub),
        torch.where(lb_fin, con_lb, torch.where(ub_fin, con_ub, 0.0)),
    )
    return torch.where(y > 0, con_lb, torch.where(y < 0, con_ub, at_zero))


class LocalizedGap(NamedTuple):
    radius: torch.Tensor
    gap: torch.Tensor
    normalized_gap: torch.Tensor  # gap / radius
    potential: torch.Tensor  # gap / radius^2 (candidate comparison)


def localized_gap(prob, x, y, ax, aty, x_start, y_start,
                  omega) -> LocalizedGap:
    """Localized duality gap of iterate (x, y) at radius = its omega-norm
    distance from the restart start point (all scaled space); reference
    ComputeLocalizedBoundsAtCurrent/Average
    (primal_dual_hybrid_gradient.cc:1804-1835)."""
    dx = x - x_start
    dy = y - y_start
    radius = torch.sqrt(
        0.5 * omega * dot(dx, dx) + 0.5 / omega * dot(dy, dy)
    )
    gx = prob.c + prob.q * x - aty
    s = dual_subgradient(prob.con_lb, prob.con_ub, y, ax)
    gy = s - ax
    ylb, yub = dual_bounds(prob.con_lb, prob.con_ub)
    safe_radius = torch.clamp(radius, min=torch.finfo(x.dtype).tiny)
    tr = solve_joint_trust_region(
        gx, gy, x, y, prob.var_lb, prob.var_ub, ylb, yub, omega, safe_radius
    )
    return LocalizedGap(
        radius=radius,
        gap=tr.gap,
        normalized_gap=tr.gap / safe_radius,
        potential=tr.gap / (safe_radius * safe_radius),
    )
