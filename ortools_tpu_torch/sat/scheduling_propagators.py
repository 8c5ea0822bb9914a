"""Vectorized scheduling propagation: disjunctive edge finding + timetable.

Capability parity: the reference's Θ-tree machinery
(``ortools/sat/theta_tree.h:26-90``), disjunctive overload checking /
edge finding (``ortools/sat/disjunctive.h:135-232``) and cumulative
timetable propagation (``ortools/sat/timetable.h``) — recast from
incremental balanced-tree updates to whole-task-set numpy prefix/suffix
scans (SURVEY A.8: the Θ-tree envelope is an associative scan).  The
engine calls these once per propagation round on the full task arrays,
instead of maintaining a tree under single-task updates.

Conventions: per task i, ``est`` = earliest start, ``lct`` = latest
completion, ``p`` = minimum duration.  All int64.  Functions return
tightened bounds and never weaken.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_NEG = np.iinfo(np.int64).min // 4
_POS = np.iinfo(np.int64).max // 4


def _ect_terms(est_s: np.ndarray, p_s: np.ndarray, mask: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """For est-sorted tasks and a member mask, return per-position
    ``sufP[k] = sum of p over members at positions >= k`` and
    ``term[k] = est_k + sufP[k]`` (only meaningful where mask)."""
    pm = np.where(mask, p_s, 0)
    suf = np.cumsum(pm[::-1])[::-1]
    term = np.where(mask, est_s + suf, _NEG)
    return suf, term


def disjunctive_edge_finding(
    est: np.ndarray, lct: np.ndarray, p: np.ndarray
) -> Tuple[np.ndarray, bool]:
    """Overload check + edge finding for one disjunctive resource.

    Returns (new_est, feasible).  Implements, for every j in lct order
    with S_j = {k : lct_k <= lct_j}:

    - overload: ect(S_j) > lct_j  =>  infeasible
      (the Θ-tree envelope rule, theta_tree.h:26)
    - edge finding: for i not in S_j with ect(S_j ∪ {i}) > lct_j, task i
      must end after all of S_j  =>  est_i >= ect(S_j)
      (disjunctive.h:232 EdgeFinding)

    ect of a set is computed by suffix scans over the est-sorted order —
    the scan formulation of the Θ-tree envelope.
    """
    n = len(est)
    new_est = est.astype(np.int64).copy()
    if n <= 1:
        return new_est, True
    est = est.astype(np.int64)
    lct = lct.astype(np.int64)
    p = p.astype(np.int64)
    order = np.argsort(est, kind="stable")
    est_s, lct_s, p_s = est[order], lct[order], p[order]

    # Iterate distinct lct thresholds ascending (small task sets: O(n^2)
    # with vectorized inner scans).
    for thr in np.unique(lct_s):
        mask = lct_s <= thr  # S = tasks that must finish by thr
        if not mask.any():
            continue
        suf, term = _ect_terms(est_s, p_s, mask)
        ect_s = term.max()
        if ect_s > thr:
            return new_est, False
        out = ~mask
        if not out.any():
            continue
        # ect(S ∪ {i}) for every outside task i, via prefix/suffix maxes:
        #   cand1 = est_i + p_i + sufP(members with est >= est_i)
        #   cand2 = max_{k in S, est_k <= est_i} term_k + p_i
        #   cand3 = max_{k in S, est_k >  est_i} term_k
        # Positions are est-sorted, so "est >= est_i" is a suffix.
        pm = np.where(mask, p_s, 0)
        # suffix sum of member p strictly AFTER position k, plus members
        # at the same position handled by suf (suf includes position k
        # when k is a member; i itself is not a member).
        suf_at = suf  # sum over members at positions >= k
        cand1 = est_s + p_s + suf_at
        run_max_incl = np.maximum.accumulate(term)  # members at pos <= k
        suf_max_excl = np.concatenate([
            np.maximum.accumulate(term[::-1])[::-1][1:], [_NEG]])
        cand2 = np.where(run_max_incl > _NEG, run_max_incl + p_s, _NEG)
        ect_with = np.maximum(np.maximum(cand1, cand2), suf_max_excl)
        trigger = out & (ect_with > thr)
        if trigger.any():
            upd = np.where(trigger, ect_s, new_est[order])
            new_order_est = np.maximum(new_est[order], upd)
            new_est[order] = new_order_est
    return new_est, True


def disjunctive_bounds(
    est: np.ndarray, lct: np.ndarray, p: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Edge finding in both time directions.

    Returns (new_est, new_lct, feasible): forward pass tightens starts,
    mirrored pass (t -> -t) tightens ends.
    """
    new_est, ok = disjunctive_edge_finding(est, lct, p)
    if not ok:
        return est, lct, False
    mir_est, ok = disjunctive_edge_finding(-lct, -new_est, p)
    if not ok:
        return est, lct, False
    new_lct = -mir_est
    return new_est, new_lct, True


def energetic_reasoning_bounds(
    est: np.ndarray, lct: np.ndarray, p: np.ndarray,
    dem: np.ndarray, cap: int,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Energetic reasoning for one cumulative resource (reference
    sat/cumulative_energy.{h,cc}; rule per Baptiste, Le Pape & Nuijten,
    *Constraint-Based Scheduling*, the left-shift/right-shift energy
    test), vectorized over ALL O(n^2) candidate windows at once.

    For a window [t1, t2): the minimal energy of task i inside it is
    ``dem_i * max(0, min(p_i, t2-t1, ect_i-t1, t2-lst_i))``.

    - overload: sum over tasks > cap*(t2-t1)  =>  infeasible;
    - adjustment: with A = (cap*(t2-t1) - W_rest_i) / dem_i, if the
      LEFT-SHIFTED overlap of i exceeds A (the overlap-vs-start function
      is unimodal, so est_i then sits strictly inside the forbidden
      plateau), every remaining start satisfies s_i >= t2 - floor(A);
      mirrored in reversed time for the end bound.

    Returns (new_est, new_lct, feasible).
    """
    est = est.astype(np.int64)
    lct = lct.astype(np.int64)
    p = p.astype(np.int64)
    dem = dem.astype(np.int64)
    new_est, ok = _er_forward(est, lct, p, dem, cap)
    if not ok:
        return est, lct, False
    mir, ok = _er_forward(-lct, -new_est, p, dem, cap)
    if not ok:
        return est, lct, False
    return new_est, -mir, True


def _er_forward(est: np.ndarray, lct: np.ndarray, p: np.ndarray,
                dem: np.ndarray, cap: int) -> Tuple[np.ndarray, bool]:
    n = len(est)
    new_est = est.copy()
    if n <= 1:
        return new_est, True
    ect = est + p
    lst = lct - p
    t1s = np.unique(est)
    t2s = np.unique(lct)
    T1, T2 = np.meshgrid(t1s, t2s, indexing="ij")
    sel = T1 < T2
    t1 = T1[sel][:, None]  # [W, 1]
    t2 = T2[sel][:, None]
    if t1.size == 0:
        return new_est, True
    length = t2 - t1
    inter = np.minimum(np.minimum(p[None, :], length),
                       np.minimum(ect[None, :] - t1, t2 - lst[None, :]))
    min_e = dem[None, :] * np.maximum(inter, 0)        # [W, n]
    tot = min_e.sum(axis=1, keepdims=True)             # [W, 1]
    cap_e = cap * length
    if (tot > cap_e).any():
        return new_est, False
    # left-shift overlap of i (start pinned at est_i)
    ls = np.maximum(
        np.minimum(t2, ect[None, :]) - np.maximum(t1, est[None, :]), 0)
    rest = tot - min_e                                  # [W, n]
    avail = cap_e - rest                                # >= 0 given no overload
    trigger = (dem[None, :] > 0) & (dem[None, :] * ls > avail)
    if not trigger.any():
        return new_est, True
    cand = t2 - avail // np.maximum(dem[None, :], 1)
    cand = np.where(trigger, cand, _NEG)
    np.maximum(new_est, cand.max(axis=0), out=new_est)
    # a push past the latest start is a conflict
    if (new_est > lst).any():
        return new_est, False
    return new_est, True


def timetable_bounds(
    est: np.ndarray, lst: np.ndarray, ect: np.ndarray, lct: np.ndarray,
    p: np.ndarray, dem: np.ndarray, cap: int,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Cumulative timetable propagation (reference sat/timetable.h).

    Builds the mandatory-part profile (task i occupies [lst_i, ect_i) when
    lst_i < ect_i) and

    - conflicts when the profile exceeds ``cap``;
    - pushes each task's est past profile segments where its demand no
      longer fits (excluding its own mandatory contribution), and
      symmetrically pulls lct.

    Returns (new_est, new_lct, feasible, profile_max) — profile_max is the
    peak mandatory-part load (a valid lower bound on the capacity).
    """
    n = len(est)
    est = est.astype(np.int64).copy()
    lct = lct.astype(np.int64).copy()
    lst = lst.astype(np.int64)
    ect = ect.astype(np.int64)
    p = p.astype(np.int64)
    dem = dem.astype(np.int64)

    has_mand = (lst < ect) & (dem > 0)
    if not has_mand.any():
        return est, lct, True, 0
    # Profile as step function over breakpoints.
    starts = lst[has_mand]
    ends = ect[has_mand]
    times = np.unique(np.concatenate([starts, ends]))
    # height[t] for segment [times[k], times[k+1])
    inc = np.zeros(len(times), dtype=np.int64)
    si = np.searchsorted(times, starts)
    ei = np.searchsorted(times, ends)
    np.add.at(inc, si, dem[has_mand])
    np.add.at(inc, ei, -dem[has_mand])
    height = np.cumsum(inc)  # height of segment starting at times[k]
    prof_max = int(height.max(initial=0))
    if prof_max > cap:
        return est, lct, False, prof_max

    own_mand = np.where(has_mand, dem, 0)
    nseg = len(times) - 1
    if nseg <= 0:
        return est, lct, True, prof_max
    seg_lo = times[:-1]
    seg_hi = times[1:]
    seg_h = height[:-1]

    for i in range(n):
        if dem[i] <= 0 or p[i] <= 0:
            continue
        # own contribution to a segment: dem[i] where [lst_i, ect_i)
        # covers the segment
        own = np.where(
            (own_mand[i] > 0) & (seg_lo >= lst[i]) & (seg_hi <= ect[i]),
            dem[i], 0)
        blocked = (seg_h - own) > cap - dem[i]
        if not blocked.any():
            continue
        # Sweep est forward past blocked segments intersecting the task's
        # window [s, s+p).  A jump to seg_hi proves every start in
        # [old_s, seg_hi) overlaps the blocked segment, so if the sweep
        # exceeds the latest start, no placement exists.
        s = int(est[i])
        for k in range(nseg):
            if seg_hi[k] <= s:
                continue
            if seg_lo[k] >= s + p[i]:
                break
            if blocked[k]:
                s = int(seg_hi[k])
                if s > lst[i]:
                    return est, lct, False, prof_max
        if s > est[i]:
            est[i] = s
        # Mirrored sweep for the end bound.
        e = int(lct[i])
        for k in range(nseg - 1, -1, -1):
            if seg_lo[k] >= e:
                continue
            if seg_hi[k] <= e - p[i]:
                break
            if blocked[k]:
                e = int(seg_lo[k])
                if e < ect[i]:
                    return est, lct, False, prof_max
        if e < lct[i]:
            lct[i] = e
    return est, lct, True, prof_max
