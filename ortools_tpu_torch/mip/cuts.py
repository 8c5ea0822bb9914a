"""Cutting planes for the batched B&B: single-row MIR and knapsack covers.

Capability parity: the reference's cut machinery inside CP-SAT
(``ortools/sat/cuts.cc`` — MIR cuts via ``ComputeCut`` / knapsack cover
cuts) and the root-LP tightening role of
``ortools/sat/linear_programming_constraint.cc``.  Redesigned for the
batched-PDHG B&B: cuts are generated on the host with vectorized numpy
row transforms (no literal/slack machinery), appended as ordinary
constraint rows, and from then on ride the same block-sparse SpMM as every
other row — so a cut strengthens *every* node LP in every batch at zero
marginal device cost.

Mathematical notes
------------------
Each generator works on one row at a time in the complemented space
``x' >= 0`` (shift by the finite lower bound, or reflect through the
finite upper bound).  For a row ``sum a_j x'_j <= b`` with integer set I
and continuous set C, the mixed-integer-rounding inequality is

    sum_{j in I} ( floor(a_j) + (frac(a_j) - f)^+ / (1 - f) ) x'_j
        + (1/(1-f)) * sum_{j in C, a_j < 0} a_j x'_j   <=   floor(b)

with ``f = frac(b)`` (continuous terms with positive coefficient are
relaxed away first, which is valid for a <= row).  Knapsack cover cuts
take binary rows ``sum a_j x'_j <= b`` (a_j > 0 after complementing) and a
greedy minimal cover ``C``: ``sum_{j in C} x'_j <= |C| - 1``.

All returned cuts are in the ORIGINAL variable space as two-sided rows
``-inf <= g.x <= d`` and are globally valid (derived from the original
rows and global bounds only, never from node bounds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

_EPS = 1e-9


@dataclasses.dataclass
class CutPool:
    """Cut rows in original space: rows[k] . x <= rhs[k]."""

    rows: sp.csr_matrix  # [k, n]
    rhs: np.ndarray  # [k]

    @property
    def num_cuts(self) -> int:
        return int(self.rows.shape[0])


def _complement(idx: np.ndarray, val: np.ndarray, rhs: float,
                lb: np.ndarray, ub: np.ndarray
                ) -> Optional[Tuple[np.ndarray, float, np.ndarray]]:
    """Shift/reflect the row's variables to x' >= 0.

    Returns (val', rhs', reflect_mask) in the complemented space, where
    ``reflect_mask[k]`` is True when variable idx[k] was reflected
    (x = ub - x'); otherwise it was shifted (x = lb + x').  None when some
    variable has no finite bound on the needed side.
    """
    l, u = lb[idx], ub[idx]
    # Prefer the bound that keeps the complemented coefficient positive for
    # integers (better MIR fractions) — but correctness only needs *a*
    # finite bound.  Shift when lb finite, else reflect.
    shift_ok = np.isfinite(l)
    reflect = ~shift_ok & np.isfinite(u)
    if not np.all(shift_ok | reflect):
        return None
    val2 = np.where(reflect, -val, val)
    rhs2 = rhs - float(np.sum(np.where(reflect, val * u, val * l)))
    if not np.isfinite(rhs2):
        return None
    return val2, rhs2, reflect


def _uncomplement(idx: np.ndarray, g: np.ndarray, d: float,
                  reflect: np.ndarray, lb: np.ndarray, ub: np.ndarray
                  ) -> Tuple[np.ndarray, float]:
    """Map a cut sum g_j x'_j <= d back to original x space."""
    l, u = lb[idx], ub[idx]
    g_orig = np.where(reflect, -g, g)
    d_orig = d + float(np.sum(np.where(reflect, -g * u, g * l)))
    return g_orig, d_orig


def _mir_on_row(idx: np.ndarray, val: np.ndarray, rhs: float,
                lb: np.ndarray, ub: np.ndarray, is_int: np.ndarray,
                x_lp: np.ndarray, min_violation: float
                ) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """Try MIR on one <= row; returns (idx, coefs, rhs) of the most
    violated scaled variant, or None."""
    comp = _complement(idx, val, rhs, lb, ub)
    if comp is None:
        return None
    val2, rhs2, reflect = comp
    ints = is_int[idx]
    if not np.any(ints):
        return None
    # MIR needs the complemented integer variables to stay integral: the
    # shift (lb or ub) must itself be integral.
    shift_val = np.where(reflect, ub[idx], lb[idx])
    if np.any(ints & (np.abs(shift_val - np.round(shift_val)) > 1e-9)):
        return None
    # x' value of the current LP point (for violation checks).
    xv = np.where(reflect, ub[idx] - x_lp[idx], x_lp[idx] - lb[idx])
    xv = np.maximum(xv, 0.0)

    # Candidate divisors: 1 and |a_j| of integer vars whose LP value is
    # fractional (Marchand-Wolsey style single-row heuristic).
    frac_of = np.abs(x_lp[idx] - np.round(x_lp[idx]))
    cand = [1.0]
    order = np.argsort(-frac_of)
    for k in order[:4]:
        if ints[k] and frac_of[k] > 1e-4 and abs(val2[k]) > _EPS:
            cand.append(abs(float(val2[k])))

    best = None
    best_viol = min_violation
    for delta in cand:
        a = val2 / delta
        b = rhs2 / delta
        f = b - np.floor(b)
        if f < 0.01 or f > 0.99:
            continue
        fj = a - np.floor(a)
        g_int = np.floor(a) + np.maximum(fj - f, 0.0) / (1.0 - f)
        g_cont = np.where(a < 0, a / (1.0 - f), 0.0)
        g = np.where(ints, g_int, g_cont)
        d = float(np.floor(b))
        norm = float(np.linalg.norm(g))
        if norm < _EPS:
            continue
        viol = (float(g @ xv) - d) / norm
        if viol > best_viol:
            best_viol = viol
            best = (g.copy(), d)
    if best is None:
        return None
    g, d = best
    g_orig, d_orig = _uncomplement(idx, g, d, reflect, lb, ub)
    keep = np.abs(g_orig) > _EPS
    if not np.any(keep):
        return None
    return idx[keep], g_orig[keep], d_orig


def _cover_on_row(idx: np.ndarray, val: np.ndarray, rhs: float,
                  lb: np.ndarray, ub: np.ndarray, is_int: np.ndarray,
                  x_lp: np.ndarray, min_violation: float
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """Greedy knapsack cover cut on a binary <= row."""
    binary = is_int[idx] & (lb[idx] >= -_EPS) & (ub[idx] <= 1.0 + _EPS) \
        & (ub[idx] - lb[idx] > 0.5)
    if not np.all(binary):
        return None
    # Complement negatives: x_j -> 1 - x_j so all coefficients positive.
    neg = val < 0
    a = np.abs(val)
    b = rhs - float(np.sum(val[neg]))  # sum val_neg * 1 moved to RHS
    if b < -_EPS:
        return None  # row itself infeasible at binary bounds — not our job
    if np.sum(a) <= b + 1e-7:
        return None  # no cover exists
    xprime = np.where(neg, 1.0 - x_lp[idx], x_lp[idx])
    xprime = np.clip(xprime, 0.0, 1.0)
    # Greedy: take items with large LP value first (most violated cover).
    order = np.argsort((1.0 - xprime) / np.maximum(a, _EPS))
    csum = np.cumsum(a[order])
    k = int(np.searchsorted(csum, b + 1e-9)) + 1
    if k > len(order):
        return None
    cover = order[:k]
    # Minimalize: drop items while still a cover.
    weight = float(csum[k - 1])
    keep = []
    for j in cover[np.argsort(a[cover])]:  # try dropping small items first
        if weight - a[j] > b + 1e-9:
            weight -= a[j]
        else:
            keep.append(j)
    cover = np.array(keep, dtype=int)
    if len(cover) == 0:
        return None
    rhs_cut = float(len(cover) - 1)

    # Sequential lifting of out-of-cover variables (reference cuts.cc
    # lifted cover inequalities).  For candidate j (descending weight),
    # alpha_j = (|C|-1) - z_j with z_j the max cut-LHS achievable among
    # cover + previously-lifted items under budget b - a_j.  We lower-
    # bound alpha_j through the fractional-knapsack UPPER bound on z_j
    # (an integer z* <= frac optimum, so floor(frac + eps) >= z*), which
    # keeps the cut valid while costing O(k log k) per candidate.
    cover_set = set(cover.tolist())
    items_w = [float(a[i]) for i in cover]
    items_p = [1.0] * len(cover)
    wsorted = np.sort(a[cover])
    fit_all_but_one = float(np.sum(wsorted[:-1]))
    outside = [j for j in range(len(idx))
               if j not in cover_set and a[j] > _EPS
               and a[j] > b - fit_all_but_one + 1e-9]
    outside.sort(key=lambda j: -a[j])
    lifted: List[Tuple[int, float]] = []
    for j in outside[:20]:
        budget = b - float(a[j])
        if budget < -1e-9:
            # x_j = 1 already violates the row: any coefficient is valid
            alpha = rhs_cut
        else:
            order2 = sorted(range(len(items_w)),
                            key=lambda t: -items_p[t] / items_w[t])
            rem, frac = budget, 0.0
            for t in order2:
                take = min(1.0, rem / items_w[t])
                frac += items_p[t] * take
                rem -= items_w[t] * take
                if rem <= 1e-12:
                    break
            alpha = rhs_cut - math.floor(frac + 1e-6)
        if alpha > 0.5:
            lifted.append((j, float(alpha)))
            items_w.append(float(a[j]))
            items_p.append(float(alpha))
    sel = np.concatenate([cover,
                          np.array([j for j, _ in lifted], dtype=int)]) \
        if lifted else cover
    coef = np.concatenate([np.ones(len(cover)),
                           np.array([al for _, al in lifted])]) \
        if lifted else np.ones(len(cover))
    viol = (float(coef @ xprime[sel]) - rhs_cut) / np.sqrt(
        float(coef @ coef))
    if viol <= min_violation:
        return None
    # sum coef_j x'_j <= |C|-1  ->  original space (x' = 1-x on neg)
    g = np.where(neg[sel], -coef, coef)
    d = rhs_cut - float(np.sum(coef[neg[sel]]))
    return idx[sel], g, d


_DP_CELL_BUDGET = 5_000_000  # items x capacity guard for the exact DP


def _knap_profile(ws: List[int], ps: List[float], cap: int) -> np.ndarray:
    """max-profit knapsack profile: out[c] = max profit with weight <= c
    (vectorized 0/1 DP, O(items * cap))."""
    dp = np.zeros(cap + 1)
    for w, p in zip(ws, ps):
        if w <= cap:
            np.maximum(dp[w:], dp[:-w] + p, out=dp[w:])
        # w > cap: item never fits; contributes nothing
    return dp


def _exact_cover_on_row(idx: np.ndarray, val: np.ndarray, rhs: float,
                        lb: np.ndarray, ub: np.ndarray, is_int: np.ndarray,
                        x_lp: np.ndarray, min_violation: float
                        ) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """Exact lifted cover cut on an integer-weight binary <= row.

    Reference: ``ortools/sat/cuts.cc`` lifted knapsack covers.  For rows
    whose coefficients are (after complementation) small nonnegative
    integers, both steps are solved EXACTLY by 0/1-knapsack DP:

    - separation: the most-violated cover minimizes sum (1-x*_j) z_j
      s.t. sum w_j z_j >= b+1 — equivalently its complement is a
      max-profit knapsack with capacity sum(w) - b - 1;
    - sequential lifting: alpha_j = (|C|-1) - z*_j with z*_j the exact
      knapsack optimum over cover + previously-lifted items at capacity
      b - w_j (one DP profile per accepted lift serves ALL candidates).

    Falls back (returns None) on fractional weights or when the DP would
    exceed the cell budget; the greedy ``_cover_on_row`` covers those.
    """
    binary = is_int[idx] & (lb[idx] >= -_EPS) & (ub[idx] <= 1.0 + _EPS) \
        & (ub[idx] - lb[idx] > 0.5)
    if not np.all(binary):
        return None
    neg = val < 0
    a = np.abs(val)
    w_int = np.round(a)
    scale = max(1.0, float(a.max(initial=0.0)))
    if not np.all(np.abs(a - w_int) <= 1e-9 * scale):
        return None  # fractional weights: greedy path handles
    w_int = w_int.astype(np.int64)
    b = rhs - float(np.sum(val[neg]))
    if b < -_EPS:
        return None
    b_int = int(math.floor(b + 1e-9))  # integral weights: <= b == <= floor
    total_w = int(w_int.sum())
    if total_w <= b_int:
        return None  # no cover exists
    n_row = len(idx)
    comp_cap = total_w - b_int - 1
    if n_row * max(comp_cap, b_int) > _DP_CELL_BUDGET or b_int < 0:
        return None
    xprime = np.clip(np.where(neg, 1.0 - x_lp[idx], x_lp[idx]), 0.0, 1.0)

    # --- exact separation: complement-set knapsack -----------------------
    cost = 1.0 - xprime  # violation price of putting j in the cover
    dp = np.zeros(comp_cap + 1)
    in_comp = np.zeros(n_row, dtype=bool)
    # recompute with per-item traceback (store decisions compactly)
    takes = []
    for j in range(n_row):
        w = int(w_int[j])
        new = dp.copy()
        if w <= comp_cap:
            cand = dp[:-w] + cost[j] if w > 0 else dp + cost[j]
            if w > 0:
                better = cand > new[w:] + 1e-15
                new[w:] = np.where(better, cand, new[w:])
                takes.append(better)
            else:
                takes.append(np.ones(comp_cap + 1, dtype=bool))
                new = np.maximum(new, dp + cost[j])
        else:
            takes.append(None)
        dp = new
    c = int(np.argmax(dp))
    for j in range(n_row - 1, -1, -1):
        t = takes[j]
        w = int(w_int[j])
        if t is None or w > c:
            continue
        if w > 0 and t[c - w]:
            in_comp[j] = True
            c -= w
        elif w == 0 and t[c]:
            in_comp[j] = True
    cover = np.nonzero(~in_comp)[0]
    if len(cover) == 0:
        return None
    # minimalize (exact separation can leave slack): drop smallest first
    weight = int(w_int[cover].sum())
    keep = []
    for j in cover[np.argsort(w_int[cover])]:
        if weight - int(w_int[j]) > b_int:
            weight -= int(w_int[j])
        else:
            keep.append(int(j))
    cover = np.array(sorted(keep), dtype=int)
    if len(cover) == 0:
        return None
    rhs_cut = float(len(cover) - 1)

    # --- exact sequential lifting ----------------------------------------
    items_w = [int(w_int[j]) for j in cover]
    items_p = [1.0] * len(cover)
    cover_set = set(cover.tolist())
    outside = [j for j in range(n_row)
               if j not in cover_set and int(w_int[j]) > 0]
    # strongest-first: heavy items get the large coefficients
    outside.sort(key=lambda j: (-int(w_int[j]), -xprime[j]))
    lifted: List[Tuple[int, float]] = []
    profile = _knap_profile(items_w, items_p, b_int)
    for j in outside[:40]:
        wj = int(w_int[j])
        if wj > b_int:
            alpha = rhs_cut  # x_j = 1 alone violates the row
        else:
            alpha = rhs_cut - float(profile[b_int - wj])
        if alpha > 0.5:
            lifted.append((j, alpha))
            items_w.append(wj)
            items_p.append(alpha)
            profile = _knap_profile(items_w, items_p, b_int)
    sel = np.concatenate([cover,
                          np.array([j for j, _ in lifted], dtype=int)]) \
        if lifted else cover
    coef = np.concatenate([np.ones(len(cover)),
                           np.array([al for _, al in lifted])]) \
        if lifted else np.ones(len(cover))
    viol = (float(coef @ xprime[sel]) - rhs_cut) / np.sqrt(
        float(coef @ coef))
    if viol <= min_violation:
        return None
    g = np.where(neg[sel], -coef, coef)
    d = rhs_cut - float(np.sum(coef[neg[sel]]))
    return idx[sel], g, d


def _find_vubs(a: sp.csr_matrix, con_lb, con_ub, var_lb, var_ub, is_int):
    """Detect implied variable bounds from two-nonzero rows mixing one
    continuous f and one binary y (reference role: implied_bounds.h —
    implied-bound substitution is how fixed-charge / indicator structure
    strengthens MIR and flow-cover cuts).

    Any row ``alpha f + beta y <= c`` (alpha > 0) gives the implied
    UPPER bound  f <= u0 + du * y  with u0 = c/alpha, du = -beta/alpha;
    the mirrored direction (alpha < 0, or the >= side) gives the implied
    LOWER bound  f >= l0 + dl * y.  The classic VUB ``f <= cap * y`` is
    the u0 = 0 special case the flow-cover separator requires.

    Returns (u0, du, uy, l0, dl, ly) arrays indexed by variable;
    uy/ly = -1 where no implied bound was found.  When several rows give
    bounds for the same f, the one with the smallest y=1 value (upper) /
    largest y=1 value (lower) wins — the strongest at the fractional
    points cuts care about."""
    n = a.shape[1]
    u0 = np.zeros(n)
    du = np.zeros(n)
    uy = np.full(n, -1, dtype=np.int64)
    l0 = np.zeros(n)
    dl = np.zeros(n)
    ly = np.full(n, -1, dtype=np.int64)
    u_at1 = np.full(n, np.inf)   # implied upper at y=1 (selection key)
    l_at1 = np.full(n, -np.inf)
    indptr, indices, data = a.indptr, a.indices, a.data
    nnz_per_row = np.diff(indptr)
    binary = is_int & (var_lb >= 0) & (var_ub <= 1)
    for i in np.nonzero(nnz_per_row == 2)[0]:
        lo = indptr[i]
        j1, j2 = indices[lo], indices[lo + 1]
        v1, v2 = data[lo], data[lo + 1]
        for (f, af), (y, ay) in (((j1, v1), (j2, v2)),
                                 ((j2, v2), (j1, v1))):
            if is_int[f] or not binary[y] or af == 0:
                continue
            for rhs, sign in ((con_ub[i], 1.0), (con_lb[i], -1.0)):
                if not np.isfinite(rhs):
                    continue
                # sign*(af f + ay y) <= sign*rhs
                aa, bb, cc = sign * af, sign * ay, sign * rhs
                if aa > 0:  # f <= cc/aa + (-bb/aa) y
                    nu0 = cc / aa
                    ndu = -bb / aa
                    # only useful when it tightens below the global box
                    # somewhere; keep the strongest at y=1
                    if nu0 + ndu < u_at1[f] - 1e-12:
                        u_at1[f] = nu0 + ndu
                        u0[f], du[f], uy[f] = nu0, ndu, y
                else:  # f >= cc/aa + (-bb/aa) y
                    nl0 = cc / aa
                    ndl = -bb / aa
                    if nl0 + ndl > l_at1[f] + 1e-12:
                        l_at1[f] = nl0 + ndl
                        l0[f], dl[f], ly[f] = nl0, ndl, y
    return u0, du, uy, l0, dl, ly


def _vub_substitute(idx: np.ndarray, val: np.ndarray, is_int: np.ndarray,
                    vubs) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """Implied-bound substitution on a <=-row (reference
    implied_bounds.h): continuous terms ``a_j f_j`` are replaced by
    their implied-bound EXPRESSIONS —

      a_j < 0:  f_j <= u0 + du*y  ->  a_j f_j >= a_j u0 + a_j du y
      a_j > 0:  f_j >= l0 + dl*y  ->  a_j f_j >= a_j l0 + a_j dl y

    either way the substituted left side is <= the original, so the
    rewritten row is implied.  The binary carries the integer structure
    MIR/cover generators need.  Returns (idx, val, rhs_delta) with
    merged duplicates (rhs_delta accounts for the moved constants), or
    None when nothing substitutes or no integer term remains."""
    u0, du, uy, l0, dl, ly = vubs
    subst_u = (~is_int[idx]) & (val < 0) & (uy[idx] >= 0)
    subst_l = (~is_int[idx]) & (val > 0) & (ly[idx] >= 0)
    if not (np.any(subst_u) or np.any(subst_l)):
        return None
    new_idx: List[int] = []
    new_val: List[float] = []
    rhs_delta = 0.0
    for j, v in zip(idx, val):
        if not is_int[j] and v < 0 and uy[j] >= 0:
            rhs_delta -= float(v * u0[j])
            new_idx.append(int(uy[j]))
            new_val.append(float(v * du[j]))
        elif not is_int[j] and v > 0 and ly[j] >= 0:
            rhs_delta -= float(v * l0[j])
            new_idx.append(int(ly[j]))
            new_val.append(float(v * dl[j]))
        else:
            new_idx.append(int(j))
            new_val.append(float(v))
    order = np.argsort(new_idx, kind="stable")
    ui: List[int] = []
    uv: List[float] = []
    for k in order:
        if ui and ui[-1] == new_idx[k]:
            uv[-1] += new_val[k]
        else:
            ui.append(new_idx[k])
            uv.append(new_val[k])
    uidx = np.array(ui, dtype=np.int64)
    uval = np.array(uv)
    keep = uval != 0.0
    uidx, uval = uidx[keep], uval[keep]
    if len(uidx) == 0 or not np.any(is_int[uidx]):
        return None
    return uidx, uval, rhs_delta


def _implied_bound_cuts(a: sp.csr_matrix, con_lb, con_ub,
                        var_lb, var_ub, is_int: np.ndarray,
                        x_lp: np.ndarray, min_violation: float
                        ) -> List[Tuple[float, np.ndarray, np.ndarray,
                                        float]]:
    """Implied-bound cuts (reference implied_bounds.h:30): for a
    continuous f and binary y, every 2-var row linking them implies an
    upper bound on f at y=0 and at y=1; the hull of those two boxes is
    ``f <= u0 + (u1 - u0) y`` (and symmetrically ``f >= l0 +
    (l1 - l0) y``), which can dominate every single row — e.g.
    f <= 2 + 5y and f + 3y <= 6 merge to f <= 2 + y."""
    n = a.shape[1]
    indptr, indices, data = a.indptr, a.indices, a.data
    nnz_per_row = np.diff(indptr)
    binary = is_int & (var_lb >= 0) & (var_ub <= 1)
    # (f, y) -> [u_at0, u_at1, l_at0, l_at1]
    pair: dict = {}
    for i in np.nonzero(nnz_per_row == 2)[0]:
        lo = indptr[i]
        j1, j2 = indices[lo], indices[lo + 1]
        v1, v2 = data[lo], data[lo + 1]
        for (f, af), (y, ay) in (((j1, v1), (j2, v2)),
                                 ((j2, v2), (j1, v1))):
            if is_int[f] or not binary[y] or af == 0:
                continue
            key = (int(f), int(y))
            if key not in pair:
                pair[key] = [var_ub[f], var_ub[f], var_lb[f], var_lb[f]]
            box = pair[key]
            for rhs, sign in ((con_ub[i], 1.0), (con_lb[i], -1.0)):
                if not np.isfinite(rhs):
                    continue
                aa, bb, cc = sign * af, sign * ay, sign * rhs
                if aa > 0:  # f <= (cc - bb*y)/aa
                    box[0] = min(box[0], cc / aa)
                    box[1] = min(box[1], (cc - bb) / aa)
                else:  # f >= (cc - bb*y)/aa
                    box[2] = max(box[2], cc / aa)
                    box[3] = max(box[3], (cc - bb) / aa)
    out: List[Tuple[float, np.ndarray, np.ndarray, float]] = []
    for (f, y), (ub0, ub1, lb0, lb1) in pair.items():
        fx, yx = float(x_lp[f]), float(np.clip(x_lp[y], 0.0, 1.0))
        if np.isfinite(ub0) and np.isfinite(ub1):
            # f - (ub1-ub0) y <= ub0
            g = np.array([1.0, -(ub1 - ub0)])
            viol = (fx - (ub1 - ub0) * yx - ub0) / max(
                float(np.linalg.norm(g)), _EPS)
            if viol > min_violation:
                norm = max(float(np.linalg.norm(g)), _EPS)
                out.append((viol, np.array([f, y], dtype=np.int64),
                            g / norm, ub0 / norm))
        if np.isfinite(lb0) and np.isfinite(lb1):
            # f >= lb0 + (lb1-lb0) y  ->  -f + (lb1-lb0) y <= -lb0
            g = np.array([-1.0, (lb1 - lb0)])
            viol = (-fx + (lb1 - lb0) * yx + lb0) / max(
                float(np.linalg.norm(g)), _EPS)
            if viol > min_violation:
                norm = max(float(np.linalg.norm(g)), _EPS)
                out.append((viol, np.array([f, y], dtype=np.int64),
                            g / norm, -lb0 / norm))
    return out


def _flow_cover_on_row(idx: np.ndarray, val: np.ndarray,
                       rhs: float,
                       var_lb: np.ndarray,
                       is_int: np.ndarray,
                       x_lp: np.ndarray,
                       vub_cap: np.ndarray, vub_y: np.ndarray,
                       min_violation: float
                       ) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """Simple flow-cover cut on a single-node flow row (reference role:
    flow covers in ``ortools/sat/cuts.cc`` and the fixed-charge
    strengthening of ``implied_bounds.h``; inequality per
    Padberg--Van Roy--Wolsey 1985).

    The row must read ``sum_j a_j f_j <= b`` with every ``f_j``
    continuous, ``a_j > 0``, ``lb(f_j) = 0`` and a variable upper bound
    ``f_j <= cap_j y_j`` (binary ``y_j``).  Scaling ``f'_j = a_j f_j``
    gives capacities ``C_j = a_j cap_j``.  For a cover ``S`` with
    ``lambda = sum_S C_j - b > 0`` the simple flow-cover inequality is

        sum_S f'_j + sum_S (C_j - lambda)^+ (1 - y_j) <= b

    returned in original space as
    ``sum_S a_j f_j - sum_S (C_j-lambda)^+ y_j <= b - sum_S (C_j-lambda)^+``.

    Separation is greedy over two orders with exact violation
    re-evaluation per prefix (heuristic per Gu-Nemhauser-Savelsbergh).
    """
    k = len(idx)
    if k < 2 or not math.isfinite(rhs):
        return None
    # every term: continuous, positive coefficient, lb 0, has a VUB
    if np.any(is_int[idx]):
        return None
    if np.any(val <= _EPS) or np.any(var_lb[idx] < -1e-9):
        return None
    yv = vub_y[idx]
    if np.any(yv < 0):
        return None
    cap_s = val * vub_cap[idx]  # C_j (scaled capacities)
    if not np.all(np.isfinite(cap_s)):
        return None
    f_s = val * x_lp[idx]  # f'_j at the LP point
    y_s = np.clip(x_lp[yv], 0.0, 1.0)

    def eval_cover(sel: np.ndarray):
        lam = float(cap_s[sel].sum()) - rhs
        if lam <= _EPS:
            return None
        bonus = np.maximum(cap_s[sel] - lam, 0.0)
        viol = float(f_s[sel].sum() + (bonus * (1.0 - y_s[sel])).sum()) - rhs
        norm = math.sqrt(float((val[sel] ** 2).sum())
                         + float((bonus ** 2).sum()))
        return viol / max(norm, _EPS), lam, bonus

    best = None  # (scaled_viol, sel, lam, bonus)
    orders = [
        np.argsort(-(f_s - (1.0 - y_s) * cap_s), kind="stable"),
        np.argsort(-np.where(f_s > _EPS, cap_s, -np.inf), kind="stable"),
    ]
    for order in orders:
        csum = 0.0
        for t in range(k):
            csum += cap_s[order[t]]
            if csum <= rhs + _EPS:
                continue
            sel = order[: t + 1]
            out = eval_cover(sel)
            if out is not None and (best is None or out[0] > best[0]):
                best = (out[0], sel, out[1], out[2])
    if best is None or best[0] <= min_violation:
        return None
    _, sel, lam, bonus = best
    # assemble in original space, merging duplicate y columns
    cols: List[int] = []
    coefs: List[float] = []
    for t, j in enumerate(idx[sel]):
        cols.append(int(j))
        coefs.append(float(val[sel][t]))
    d = rhs
    for t, j in enumerate(yv[sel]):
        if bonus[t] > _EPS:
            cols.append(int(j))
            coefs.append(-float(bonus[t]))
            d -= float(bonus[t])
    order2 = np.argsort(cols, kind="stable")
    ui: List[int] = []
    uv: List[float] = []
    for t in order2:
        if ui and ui[-1] == cols[t]:
            uv[-1] += coefs[t]
        else:
            ui.append(cols[t])
            uv.append(coefs[t])
    gidx = np.array(ui, dtype=np.int64)
    gval = np.array(uv)
    keep = gval != 0.0
    return gidx[keep], gval[keep], float(d)


def _clique_cuts(a: sp.csr_matrix, con_ub: np.ndarray, var_lb, var_ub,
                 is_int: np.ndarray, x_lp: np.ndarray,
                 min_violation: float,
                 max_cliques: int = 200
                 ) -> List[Tuple[float, np.ndarray, np.ndarray, float]]:
    """Clique cuts from pairwise set-packing rows (reference role:
    sat/cuts.cc at-most-one strengthening + TransformIntoMaxCliques):
    rows ``x_i + x_j <= 1`` over binaries define a conflict graph; each
    violated edge is greedily extended to a maximal clique C and emitted
    as ``sum_{j in C} x_j <= 1``."""
    indptr, indices, data = a.indptr, a.indices, a.data
    n = a.shape[1]
    binary = is_int & (var_lb >= 0) & (var_ub <= 1)
    nnz_per_row = np.diff(indptr)
    pair_rows = np.nonzero((nnz_per_row == 2) & (con_ub == 1.0))[0]
    edges: List[Tuple[int, int]] = []
    for i in pair_rows:
        lo = indptr[i]
        j1, j2 = indices[lo], indices[lo + 1]
        if (data[lo] == 1.0 and data[lo + 1] == 1.0
                and binary[j1] and binary[j2]):
            edges.append((int(j1), int(j2)))
    if len(edges) < 3:
        return []
    adj: dict = {}
    for u, v in edges:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    # candidates ordered by LP value: extend the most fractional edges
    order = sorted(edges, key=lambda e: -(x_lp[e[0]] + x_lp[e[1]]))
    out: List[Tuple[float, np.ndarray, np.ndarray, float]] = []
    seen: set = set()
    for u, v in order[: 4 * max_cliques]:
        clique = [u, v]
        common = adj[u] & adj[v]
        for w in sorted(common, key=lambda j: -x_lp[j]):
            if all(w in adj[c] for c in clique):
                clique.append(w)
                common &= adj[w]
                if not common:
                    break
        if len(clique) < 3:
            continue
        key = tuple(sorted(clique))
        if key in seen:
            continue
        seen.add(key)
        cidx = np.array(key, dtype=np.int64)
        viol = float(x_lp[cidx].sum()) - 1.0
        norm = math.sqrt(len(cidx))
        if viol / norm > min_violation:
            out.append((viol / norm, cidx,
                        np.full(len(cidx), 1.0 / norm), 1.0 / norm))
        if len(out) >= max_cliques:
            break
    return out


def _odd_cycle_cuts(a: sp.csr_matrix, con_ub: np.ndarray, var_lb, var_ub,
                    is_int: np.ndarray, x_lp: np.ndarray,
                    min_violation: float, max_cuts: int = 100,
                    max_seeds: int = 30
                    ) -> List[Tuple[float, np.ndarray, np.ndarray, float]]:
    """Odd-cycle cuts on the conflict graph (reference zero_half_cuts.cc
    role on packing structures): an odd cycle C of pairwise conflicts
    gives ``sum_{v in C} x_v <= (|C|-1)/2``.  Separation: weight each
    conflict edge (u,v) by ``max(0, 1 - x_u - x_v)``; an odd cycle is
    violated iff its weight is < 1.  Minimum-weight odd closed walks are
    shortest paths (u,parity 0) -> (u,parity 1) in the bipartite double
    cover (Dijkstra from the most fractional seeds)."""
    import heapq

    indptr, indices, data = a.indptr, a.indices, a.data
    binary = is_int & (var_lb >= 0) & (var_ub <= 1)
    nnz_per_row = np.diff(indptr)
    pair_rows = np.nonzero((nnz_per_row == 2) & (con_ub == 1.0))[0]
    adj: dict = {}
    for i in pair_rows:
        lo = indptr[i]
        j1, j2 = int(indices[lo]), int(indices[lo + 1])
        if (data[lo] == 1.0 and data[lo + 1] == 1.0
                and binary[j1] and binary[j2]):
            w = max(0.0, 1.0 - float(x_lp[j1]) - float(x_lp[j2]))
            adj.setdefault(j1, []).append((j2, w))
            adj.setdefault(j2, []).append((j1, w))
    if len(adj) < 3:
        return []
    seeds = sorted(adj, key=lambda v: abs(float(x_lp[v]) - 0.5))
    out: List[Tuple[float, np.ndarray, np.ndarray, float]] = []
    seen: set = set()
    inf = math.inf
    for s in seeds[:max_seeds]:
        dist = {(s, 0): 0.0}
        prev: dict = {}
        pq = [(0.0, s, 0)]
        target = (s, 1)
        while pq:
            d, u, p = heapq.heappop(pq)
            if d > dist.get((u, p), inf) + 1e-15:
                continue
            if (u, p) == target:
                break
            for v, w in adj[u]:
                key = (v, 1 - p)
                nd = d + w
                if nd < dist.get(key, inf) - 1e-15:
                    dist[key] = nd
                    prev[key] = (u, p)
                    heapq.heappush(pq, (nd, v, 1 - p))
        if dist.get(target, inf) >= 1.0 - 1e-9:
            continue
        walk: List[int] = []
        cur = target
        while cur != (s, 0):
            walk.append(cur[0])
            cur = prev.get(cur)
            if cur is None:
                break
        if cur is None:
            continue
        cyc = walk  # closed odd walk: s ... s, with the final s implicit
        if len(cyc) % 2 == 0 or len(set(cyc)) != len(cyc):
            continue  # keep only simple odd cycles
        key2 = tuple(sorted(cyc))
        if key2 in seen:
            continue
        seen.add(key2)
        cidx = np.array(sorted(cyc), dtype=np.int64)
        rhs = (len(cyc) - 1) / 2.0
        norm = math.sqrt(float(len(cyc)))
        viol = (float(x_lp[cidx].sum()) - rhs) / norm
        if viol > min_violation:
            out.append((viol, cidx, np.full(len(cidx), 1.0 / norm),
                        rhs / norm))
        if len(out) >= max_cuts:
            break
    return out


def _zero_half_cuts(a: sp.csr_matrix, con_lb, con_ub, var_lb, var_ub,
                    is_int, x_lp, min_violation,
                    max_rows: int = 400, slack_cap: float = 0.45):
    """Proper {0,1/2}-Chvátal-Gomory separation (reference
    ``ortools/sat/zero_half_cuts.h:40``; the odd-cycle generator is the
    2-nonzero special case).

    Candidate rows: integer-coefficient all-integer-variable row
    directions with LP slack < ``slack_cap``, plus near-tight variable
    bound rows (x_j <= u_j and -x_j <= -l_j).  Each row is reduced mod 2;
    Gaussian elimination over GF(2) (pivoting on minimum accumulated
    slack, the Koster-Zymolka-Kutschka heuristic) looks for combinations
    that vanish mod 2 on every column with odd right-hand side — each
    gives the cut (sum rows)/2, floor'd, with LP violation
    (1 - sum slack)/2."""
    m, n = a.shape
    indptr, indices, data = a.indptr, a.indices, a.data
    rows = []  # (slack, idx, val(int), rhs(int))
    for i in range(m):
        lo, hi = indptr[i], indptr[i + 1]
        if hi == lo or hi - lo > 200:
            continue
        idx = indices[lo:hi]
        if not np.all(is_int[idx]):
            continue
        val = data[lo:hi]
        iv = np.rint(val)
        if np.max(np.abs(val - iv)) > 1e-9 or np.max(np.abs(iv)) > 1e6:
            continue
        act = float(val @ x_lp[idx])
        for sgn, rhs in ((1.0, con_ub[i]), (-1.0, -con_lb[i])):
            if not np.isfinite(rhs):
                continue
            irhs = math.floor(rhs + 1e-9)
            slack = irhs - sgn * act
            if 0.0 - 1e-7 <= slack < slack_cap:
                rows.append((max(slack, 0.0), idx,
                             (sgn * iv).astype(np.int64), irhs))
    # near-tight bound rows (they fix column parities cheaply)
    frac = np.abs(x_lp - np.rint(x_lp)) > 1e-6
    for j in np.nonzero(is_int & np.isfinite(var_ub))[0]:
        s = var_ub[j] - x_lp[j]
        if 0 <= s < slack_cap and abs(var_ub[j]) < 1e6:
            rows.append((s, np.array([j]), np.array([1], dtype=np.int64),
                         int(round(var_ub[j]))))
    for j in np.nonzero(is_int & np.isfinite(var_lb))[0]:
        s = x_lp[j] - var_lb[j]
        if 0 <= s < slack_cap and abs(var_lb[j]) < 1e6:
            rows.append((s, np.array([j]), np.array([-1], dtype=np.int64),
                         -int(round(var_lb[j]))))
    if len(rows) < 2:
        return []
    rows.sort(key=lambda r: r[0])
    rows = rows[:max_rows]
    nr = len(rows)
    # columns that matter mod 2: restrict to columns appearing with odd
    # coefficient in some candidate row
    col_set = {}
    for _, idx, iv, _ in rows:
        for j, v in zip(idx, iv):
            if v & 1:
                col_set.setdefault(int(j), len(col_set))
    nc = len(col_set)
    if nc == 0:
        return []
    # GF(2) system [A | b]; combo tracks which original rows were xor'd
    mat = np.zeros((nr, nc), dtype=bool)
    parity = np.zeros(nr, dtype=bool)
    slacks = np.array([r[0] for r in rows])
    combos: List[set] = [{k} for k in range(nr)]
    for k, (_, idx, iv, irhs) in enumerate(rows):
        for j, v in zip(idx, iv):
            if v & 1:
                mat[k, col_set[int(j)]] = True
        parity[k] = bool(irhs & 1)
    alive = np.ones(nr, dtype=bool)
    # eliminate columns, min-slack pivot first (prefer fractional columns
    # last so their parity rows stay available)
    col_order = sorted(
        range(nc), key=lambda c: -int(np.count_nonzero(mat[:, c])))
    for c in col_order:
        cand = np.nonzero(alive & mat[:, c])[0]
        if len(cand) == 0:
            continue
        p = cand[np.argmin(slacks[cand])]
        for r in cand:
            if r == p:
                continue
            mat[r] ^= mat[p]
            parity[r] ^= parity[p]
            slacks[r] += slacks[p]
            combos[r] = combos[r] ^ combos[p]
        alive[p] = False  # pivot row consumed
    out = []
    for r in range(nr):
        if not alive[r] or not parity[r] or np.any(mat[r]):
            continue
        if slacks[r] >= 1.0 - 2 * min_violation:
            continue
        # rebuild the combined row exactly
        acc = {}
        rhs_sum = 0
        for k in combos[r]:
            _, idx, iv, irhs = rows[k]
            rhs_sum += irhs
            for j, v in zip(idx, iv):
                acc[int(j)] = acc.get(int(j), 0) + int(v)
        gidx = np.array(sorted(acc), dtype=np.int64)
        gval = np.array([acc[int(j)] for j in gidx], dtype=np.float64)
        keep = gval != 0
        gidx, gval = gidx[keep], gval[keep]
        if len(gidx) == 0:
            continue
        if np.any(np.rint(gval).astype(np.int64) & 1):
            continue  # parity bookkeeping surprise: not a valid /2 row
        cval = gval / 2.0
        crhs = float((rhs_sum - 1) // 2)
        norm = float(np.linalg.norm(cval))
        viol = (float(cval @ x_lp[gidx]) - crhs) / max(norm, _EPS)
        if viol > min_violation:
            out.append((viol, gidx, cval / max(norm, _EPS),
                        crhs / max(norm, _EPS)))
    _ = frac  # (documentational: fractional columns drive the violation)
    return out


def generate_cuts(
    a: sp.csr_matrix,
    con_lb: np.ndarray,
    con_ub: np.ndarray,
    var_lb: np.ndarray,
    var_ub: np.ndarray,
    integrality: np.ndarray,
    x_lp: np.ndarray,
    max_cuts: int = 200,
    min_violation: float = 1e-4,
    enable_zero_half: bool = False,
) -> Optional[CutPool]:
    """Generate violated MIR + cover cuts at the LP point ``x_lp``.

    Both row directions are tried: ``a.x <= cu`` and ``-a.x <= -cl``.
    Returns None when nothing sufficiently violated is found.
    """
    a = sp.csr_matrix(a)
    m, n = a.shape
    is_int = np.asarray(integrality, dtype=bool)
    if not np.any(is_int):
        return None
    vubs = _find_vubs(a, con_lb, con_ub, var_lb, var_ub, is_int)
    u0_v, du_v, uy_v, _l0_v, _dl_v, _ly_v = vubs
    # the flow-cover separator needs the classic zero-offset VUB form
    fc_cap = np.where((uy_v >= 0) & (np.abs(u0_v) <= 1e-9) & (du_v > 0),
                      du_v, np.inf)
    fc_y = np.where((uy_v >= 0) & (np.abs(u0_v) <= 1e-9) & (du_v > 0),
                    uy_v, -1)
    found: List[Tuple[float, np.ndarray, np.ndarray, float]] = []
    found.extend(_clique_cuts(a, con_ub, var_lb, var_ub, is_int, x_lp,
                              min_violation))
    found.extend(_implied_bound_cuts(a, con_lb, con_ub, var_lb, var_ub,
                                     is_int, x_lp, min_violation))
    found.extend(_odd_cycle_cuts(a, con_ub, var_lb, var_ub, is_int, x_lp,
                                 min_violation))
    if enable_zero_half:
        # {0,1/2}-CG cuts are exact half-sums of existing rows: valid and
        # tightening, but the parallel/dependent rows they add make the
        # node LPs highly degenerate.  Enabled at the B&B root now that
        # glop/simplex.py carries bound-shift / cost-perturbation
        # anti-cycling; off by default for other callers.
        found.extend(_zero_half_cuts(a, con_lb, con_ub, var_lb, var_ub,
                                     is_int, x_lp, min_violation))
    indptr, indices, data = a.indptr, a.indices, a.data
    for i in range(m):
        lo, hi = indptr[i], indptr[i + 1]
        if hi == lo:
            continue
        idx = indices[lo:hi]
        val = data[lo:hi]
        row_has_int = bool(np.any(is_int[idx]))
        for row_val, row_rhs in (
            (val, con_ub[i]),
            (-val, -con_lb[i]),
        ):
            if not np.isfinite(row_rhs):
                continue
            if not row_has_int:
                # single-node flow row candidate (continuous + VUBs)
                fc = _flow_cover_on_row(idx, row_val, float(row_rhs),
                                        var_lb, is_int, x_lp,
                                        fc_cap, fc_y, min_violation)
                if fc is not None:
                    cidx, cval, crhs = fc
                    norm = max(float(np.linalg.norm(cval)), _EPS)
                    viol = (float(cval @ x_lp[cidx]) - crhs) / norm
                    if viol > min_violation:
                        found.append((viol, cidx, cval / norm, crhs / norm))
            variants = [(idx, row_val, 0.0)] if row_has_int else []
            sub = _vub_substitute(idx, row_val, is_int, vubs)
            if sub is not None:
                variants.append(sub)
            for vidx, vval, vdelta in variants:
                for gen in (_exact_cover_on_row, _cover_on_row,
                            _mir_on_row):
                    out = gen(vidx, vval, float(row_rhs) + vdelta,
                              var_lb, var_ub,
                              is_int, x_lp, min_violation)
                    if out is None:
                        continue
                    cidx, cval, crhs = out
                    norm = float(np.linalg.norm(cval))
                    viol = (float(cval @ x_lp[cidx]) - crhs) / max(norm,
                                                                   _EPS)
                    if viol > min_violation:
                        found.append((viol, cidx, cval / max(norm, _EPS),
                                      crhs / max(norm, _EPS)))
    if not found:
        return None
    found.sort(key=lambda t: -t[0])
    found = found[:4 * max_cuts]
    # Parallelism filter (reference linear_constraint_manager.cc cut
    # orthogonality): near-parallel cuts produce (near-)singular simplex
    # bases downstream; keep the most-violated representative only.
    selected: List[Tuple[float, np.ndarray, np.ndarray, float]] = []
    for cand in found:
        _, cidx, cval, _ = cand
        dup = False
        for _, sidx, sval, _ in selected:
            # sparse cosine of two unit-norm rows
            common, ia, ib = np.intersect1d(
                cidx, sidx, return_indices=True)
            if len(common) == 0:
                continue
            if abs(float(cval[ia] @ sval[ib])) > 0.98:
                dup = True
                break
        if not dup:
            selected.append(cand)
        if len(selected) >= max_cuts:
            break
    found = selected
    rows_i, cols_i, vals = [], [], []
    rhs = np.zeros(len(found))
    for k, (_, cidx, cval, crhs) in enumerate(found):
        rows_i.extend([k] * len(cidx))
        cols_i.extend(cidx.tolist())
        vals.extend(cval.tolist())
        rhs[k] = crhs
    rows = sp.csr_matrix(
        (vals, (rows_i, cols_i)), shape=(len(found), n)
    )
    return CutPool(rows=rows, rhs=rhs)


def append_cuts(qp, pool: CutPool):
    """Return a new QuadraticProgram with the pool's rows appended as
    -inf <= g.x <= d constraints.  ``qp`` must be in minimization form."""
    a_new = sp.vstack([sp.csr_matrix(qp.constraint_matrix), pool.rows],
                      format="csr")
    cl_new = np.concatenate([qp.constraint_lower,
                             np.full(pool.num_cuts, -np.inf)])
    cu_new = np.concatenate([qp.constraint_upper, pool.rhs])
    return dataclasses.replace(
        qp,
        constraint_matrix=a_new,
        constraint_lower=cl_new,
        constraint_upper=cu_new,
        constraint_names=None,
    )
