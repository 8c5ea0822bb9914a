"""Jobshop scheduling: parser + CP model.

Capability parity: ``ortools/scheduling/jobshop_scheduling_parser.{h,cc}``
(standard JSSP format) and the reference's ``examples/cpp/jobshop_sat.cc``
model: one interval per operation, no_overlap per machine, job precedence
chains, makespan minimization (BASELINE config 4).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class JobshopInstance:
    name: str
    jobs: List[List[Tuple[int, int]]]  # per job: [(machine, duration), ...]

    @property
    def num_jobs(self) -> int:
        return len(self.jobs)

    @property
    def num_machines(self) -> int:
        return 1 + max(m for job in self.jobs for m, _ in job)

    @property
    def horizon(self) -> int:
        return sum(d for job in self.jobs for _, d in job)


def parse_jobshop(path_or_text: str, is_text: bool = False,
                  name: str = "") -> JobshopInstance:
    """Standard JSSP format: first non-comment line `num_jobs num_machines`,
    then one line per job with (machine, duration) pairs.  Lines starting
    with '#' and instance-bank headers ('+++', 'instance ...') are skipped.
    """
    text = path_or_text if is_text else open(path_or_text).read()
    rows = []
    for ln in text.splitlines():
        s = ln.strip()
        if not s or s.startswith(("#", "+", "instance", "Times", "Machines")):
            continue
        parts = s.split()
        try:
            rows.append([int(float(x)) for x in parts])
        except ValueError:
            continue
    assert rows, "no numeric data found"
    nj, nm = rows[0][0], rows[0][1]
    jobs = []
    for r in rows[1:1 + nj]:
        job = [(r[i], r[i + 1]) for i in range(0, 2 * nm, 2)]
        jobs.append(job)
    assert len(jobs) == nj
    return JobshopInstance(name=name, jobs=jobs)


@dataclasses.dataclass
class JobshopSolution:
    makespan: int
    starts: List[List[int]]  # per job, per operation
    optimal: bool


def _greedy_schedule(instance: "JobshopInstance") -> Tuple[int, List[List[int]]]:
    """Non-delay list schedule (most-work-remaining priority) — the upper
    bound that seeds the CDCL makespan search."""
    nj = instance.num_jobs
    job_next = [0] * nj
    job_avail = [0] * nj
    mach_avail = [0] * instance.num_machines
    remaining = [sum(d for _, d in job) for job in instance.jobs]
    starts: List[List[int]] = [[0] * len(job) for job in instance.jobs]
    ops_left = sum(len(job) for job in instance.jobs)
    while ops_left:
        best = None
        for j in range(nj):
            o = job_next[j]
            if o >= len(instance.jobs[j]):
                continue
            mach, dur = instance.jobs[j][o]
            t = max(job_avail[j], mach_avail[mach])
            key = (t, -remaining[j])
            if best is None or key < best[0]:
                best = (key, j, o, mach, dur, t)
        _, j, o, mach, dur, t = best
        starts[j][o] = t
        job_avail[j] = t + dur
        mach_avail[mach] = t + dur
        remaining[j] -= dur
        job_next[j] += 1
        ops_left -= 1
    makespan = max(job_avail)
    return makespan, starts


def solve_jobshop_cdcl(instance: "JobshopInstance",
                       max_time_in_seconds: float = 60.0,
                       upper_bound: Optional[int] = None
                       ) -> Optional[JobshopSolution]:
    """Exact jobshop via the native CDCL core and an order encoding.

    Encoding (per classic SAT scheduling, the lazy-clause-generation
    heritage of the reference's CP-SAT, sat/README.md):
      q_{k,t}  <=>  start_k <= t   (ladder over each op's time window)
    with job-precedence and machine-disjunction implications expressed
    over the ladders, order booleans per machine pair, and the makespan
    queried *incrementally* through assumptions on the job-end ladders —
    one solver instance keeps its learnt clauses across the whole binary
    search (reference parity: objective probing in cp_model_solver).
    """
    import time as _time

    import numpy as np

    from ortools_tpu_torch.sat.cdcl import CdclSolver, SAT, UNSAT

    deadline = _time.monotonic() + max_time_in_seconds
    ub, greedy_starts = _greedy_schedule(instance)
    if upper_bound is not None:
        ub = min(ub, upper_bound)
    jobs = instance.jobs
    nm = instance.num_machines
    # flatten ops
    ops = []  # (job, idx, machine, dur)
    job_of = []
    for j, job in enumerate(jobs):
        for o, (mach, dur) in enumerate(job):
            ops.append((j, o, mach, dur))
            job_of.append(j)
    nops = len(ops)
    dur = np.array([d for _, _, _, d in ops], dtype=np.int64)
    # heads (earliest starts) and tails (work after op start, incl. itself)
    est = np.zeros(nops, dtype=np.int64)
    tail = np.zeros(nops, dtype=np.int64)
    k = 0
    for j, job in enumerate(jobs):
        acc = 0
        for o, (mach, d) in enumerate(job):
            est[k + o] = acc
            acc += d
        acc = 0
        for o in range(len(job) - 1, -1, -1):
            acc += job[o][1]
            tail[k + o] = acc
        k += len(job)
    lb = max(
        max(int(est[i] + tail[i]) for i in range(nops)),
        max(
            (sum(d for j2 in jobs for m2, d in j2 if m2 == mach)
             for mach in range(nm)),
            default=0,
        ),
    )
    if ub < lb:
        ub = lb
    lst = ub - tail  # latest start at makespan = ub
    if np.any(lst < est):
        return None  # ub infeasible -> greedy bound inconsistent (no-op)

    # q-variable layout: var(k, t) for t in [est_k, lst_k - 1], 1-based.
    win = np.maximum(lst - est, 0)
    qbase = np.zeros(nops + 1, dtype=np.int64)
    np.cumsum(win, out=qbase[1:])
    num_q = int(qbase[-1])

    TRUE, FALSE = 0x7fffffff, -0x7fffffff  # sentinels, filtered on emit

    def lit(k: int, t: np.ndarray) -> np.ndarray:
        """Vectorized literal for [start_k <= t]."""
        t = np.asarray(t, dtype=np.int64)
        out = np.where(
            t < est[k], np.int64(FALSE),
            np.where(t >= lst[k], np.int64(TRUE),
                     qbase[k] + (t - est[k]) + 1),
        )
        return out

    chunks: List[np.ndarray] = []

    def _rows(cols: List[np.ndarray]) -> None:
        """Append fixed-width clauses [c1..ck 0] for kept rows."""
        n = len(cols[0])
        if n == 0:
            return
        out = np.zeros((n, len(cols) + 1), dtype=np.int64)
        for i, c in enumerate(cols):
            out[:, i] = c
        chunks.append(out.reshape(-1))

    def emit2(a: np.ndarray, b: np.ndarray) -> None:
        """(a | b); a TRUE/FALSE-free by construction, b may be either."""
        keep = b != TRUE
        a, b = a[keep], b[keep]
        fb = b == FALSE
        _rows([a[~fb], b[~fb]])
        _rows([a[fb]])  # b dropped: unit clause

    def emit3(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> None:
        """(a | b | c); a sentinel-free, b and c may be TRUE/FALSE."""
        keep = (b != TRUE) & (c != TRUE)
        a, b, c = a[keep], b[keep], c[keep]
        fb, fc = b == FALSE, c == FALSE
        g0 = ~fb & ~fc
        _rows([a[g0], b[g0], c[g0]])
        g1 = fb & ~fc
        _rows([a[g1], c[g1]])
        g2 = ~fb & fc
        _rows([a[g2], b[g2]])
        g3 = fb & fc
        _rows([a[g3]])

    # 1. ladders: q_{k,t} -> q_{k,t+1}
    for k in range(nops):
        if win[k] >= 2:
            ts = np.arange(est[k], lst[k] - 1)
            emit2(-(qbase[k] + (ts - est[k]) + 1),
                  qbase[k] + (ts - est[k]) + 2)

    # 2. job precedences: start_next >= start_k + dur_k
    idx = 0
    for j, job in enumerate(jobs):
        for o in range(len(job) - 1):
            k0, k1 = idx + o, idx + o + 1
            ts = np.arange(est[k1], lst[k1])
            emit2(-lit(k1, ts), lit(k0, ts - dur[k0]))
        idx += len(job)

    # 3. machine disjunctions with order booleans
    by_machine: dict = {m: [] for m in range(nm)}
    for k, (j, o, mach, d) in enumerate(ops):
        by_machine[mach].append(k)
    order_var = {}
    next_var = num_q + 1
    for mach, ks in by_machine.items():
        for i in range(len(ks)):
            for j2 in range(i + 1, len(ks)):
                a, b = ks[i], ks[j2]
                p = next_var
                next_var += 1
                order_var[a, b] = p
                # p -> a before b: [s_b <= t] -> [s_a <= t - d_a]
                ts = np.arange(est[b], lst[b] + 1)
                emit3(np.full(len(ts), -p, dtype=np.int64),
                      -lit(b, ts), lit(a, ts - dur[a]))
                # !p -> b before a
                ts = np.arange(est[a], lst[a] + 1)
                emit3(np.full(len(ts), p, dtype=np.int64),
                      -lit(a, ts), lit(b, ts - dur[b]))

    solver = CdclSolver(next_var - 1)
    flat = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
    if not solver.add_clauses_flat(flat.astype(np.int32)):
        return None

    # job-end literals for the makespan query
    last_ops = []
    idx = 0
    for j, job in enumerate(jobs):
        last_ops.append(idx + len(job) - 1)
        idx += len(job)

    def makespan_assumptions(t_val: int) -> Optional[List[int]]:
        out = []
        for k in last_ops:
            lt = int(lit(k, np.array([t_val - dur[k]]))[0])
            if lt == FALSE:
                return None  # t_val below a job's critical path
            if lt != TRUE:
                out.append(lt)
        return out

    def extract(model: np.ndarray) -> Tuple[int, List[List[int]]]:
        starts: List[List[int]] = []
        idx2 = 0
        mk = 0
        for j, job in enumerate(jobs):
            row = []
            for o in range(len(job)):
                k2 = idx2 + o
                s = int(lst[k2])
                if win[k2] > 0:
                    qs = model[qbase[k2]: qbase[k2] + win[k2]]
                    nz = np.flatnonzero(qs)
                    s = int(est[k2] + (nz[0] if len(nz) else win[k2]))
                row.append(s)
                mk = max(mk, s + int(dur[k2]))
            starts.append(row)
            idx2 += len(job)
        return mk, starts

    # seed incumbent with the greedy schedule
    best_mk, best_starts = ub, greedy_starts
    proven_lb = lb
    optimal = False
    while proven_lb < best_mk:
        if _time.monotonic() > deadline:
            break
        t_try = (proven_lb + best_mk - 1) // 2  # prove or improve
        assume = makespan_assumptions(t_try)
        if assume is None:
            proven_lb = t_try + 1
            continue
        status = None
        while _time.monotonic() <= deadline:
            status = solver.solve(assume, conflict_budget=20_000)
            if status != -1:
                break
        if status == SAT:
            mk, starts = extract(solver.model())
            if mk <= best_mk:
                best_mk, best_starts = mk, starts
        elif status == UNSAT:
            proven_lb = t_try + 1
        else:
            break  # time limit
    optimal = proven_lb >= best_mk
    return JobshopSolution(
        makespan=int(best_mk),
        starts=best_starts,
        optimal=optimal,
    )


def solve_jobshop_lcg(instance: "JobshopInstance",
                      max_time_in_seconds: float = 60.0,
                      upper_bound: Optional[int] = None
                      ) -> Optional[JobshopSolution]:
    """Exact jobshop on the native lazy-clause-generation core.

    The LCG twin of ``solve_jobshop_cdcl``: same head/tail windows, greedy
    seed, and prove-or-improve binary descent, but start variables live
    directly in the learning core as lazily-encoded integers
    (_native/lcg.cc; reference integer.h:453,722) — no eager q-ladder.
    One start var per op (domain [est, lst]), one order boolean per
    machine pair with half-reified precedences (precedences.h:111), and a
    makespan variable queried through bound-literal assumptions.
    """
    import time as _time

    from ortools_tpu_torch.sat.lcg import (FALSE_EXT, LcgSolver, SAT, TRUE_EXT,
                                     UNSAT)

    deadline = _time.monotonic() + max_time_in_seconds
    ub, greedy_starts = _greedy_schedule(instance)
    if upper_bound is not None:
        ub = min(ub, upper_bound)
    jobs = instance.jobs
    nm = instance.num_machines
    ops = []  # (job, idx, machine, dur)
    for j, job in enumerate(jobs):
        for o, (mach, d) in enumerate(job):
            ops.append((j, o, mach, d))
    nops = len(ops)
    # heads (earliest start) and tails (work from op start to job end)
    est = [0] * nops
    tail = [0] * nops
    k = 0
    for j, job in enumerate(jobs):
        acc = 0
        for o, (_, d) in enumerate(job):
            est[k + o] = acc
            acc += d
        acc = 0
        for o in range(len(job) - 1, -1, -1):
            acc += job[o][1]
            tail[k + o] = acc
        k += len(job)
    lb = max(
        max(est[i] + tail[i] for i in range(nops)),
        max((sum(d for j2 in jobs for m2, d in j2 if m2 == mach)
             for mach in range(nm)), default=0),
    )
    ub = max(ub, lb)

    s = LcgSolver()
    start = [s.new_int(est[i], ub - tail[i]) for i in range(nops)]
    mk = s.new_int(lb, ub)
    # job precedences: s[k] + d[k] <= s[k+1]
    k = 0
    for j, job in enumerate(jobs):
        for o in range(len(job) - 1):
            s.add_linear([], [start[k + o], start[k + o + 1]], [1, -1],
                         None, -job[o][1])
        # makespan: s_last + d_last <= mk
        last = k + len(job) - 1
        s.add_linear([], [start[last], mk], [1, -1], None,
                     -job[-1][1])
        k += len(job)
    # machine disjunctions: order boolean per pair
    by_machine: dict = {}
    for i, (j, o, mach, d) in enumerate(ops):
        by_machine.setdefault(mach, []).append(i)
    flat_greedy = [greedy_starts[j][o] for j, o, _, _ in ops]
    order: dict = {}  # (i1, i2) -> literal for "i1 before i2"
    for mach, idxs in by_machine.items():
        for a in range(len(idxs)):
            for b in range(a + 1, len(idxs)):
                i1, i2 = idxs[a], idxs[b]
                bx = s.new_bool01()
                bl = s.ge(bx, 1)
                d1, d2 = ops[i1][3], ops[i2][3]
                # bl -> s1 + d1 <= s2 ; !bl -> s2 + d2 <= s1
                s.add_linear([bl], [start[i1], start[i2]], [1, -1],
                             None, -d1)
                s.add_linear([-bl], [start[i2], start[i1]], [1, -1],
                             None, -d2)
                s.set_int_hint(bx,
                               1 if flat_greedy[i1] <= flat_greedy[i2]
                               else 0)
                order[(i1, i2)] = bl
                order[(i2, i1)] = -bl
        # transitivity on the sequencing booleans: before(i,j) and
        # before(j,k) imply before(i,k) (the machine order is total)
        for a in range(len(idxs)):
            for b in range(len(idxs)):
                if a == b:
                    continue
                for c in range(len(idxs)):
                    if c == a or c == b:
                        continue
                    i1, i2, i3 = idxs[a], idxs[b], idxs[c]
                    if i1 < i3:  # each (i,j,k) chain emitted once
                        s.add_clause([-order[(i1, i2)],
                                      -order[(i2, i3)],
                                      order[(i1, i3)]])
    for i in range(nops):
        s.set_int_hint(start[i], min(max(flat_greedy[i], est[i]),
                                     ub - tail[i]))
    if s.infeasible:
        return None

    def extract() -> Tuple[int, List[List[int]]]:
        starts: List[List[int]] = []
        mkv = 0
        k2 = 0
        for j, job in enumerate(jobs):
            row = [int(s.int_value(start[k2 + o]))
                   for o in range(len(job))]
            starts.append(row)
            mkv = max(mkv, row[-1] + job[-1][1])
            k2 += len(job)
        return mkv, starts

    best_mk, best_starts = ub, greedy_starts
    proven_lb = lb
    while proven_lb < best_mk:
        if _time.monotonic() > deadline:
            break
        t_try = (proven_lb + best_mk - 1) // 2  # prove or improve
        a = s.le(mk, t_try)
        if a == FALSE_EXT:
            proven_lb = t_try + 1
            continue
        assume = [] if a == TRUE_EXT else [a]
        status = None
        while _time.monotonic() <= deadline:
            status = s.solve(assume, conflict_budget=20_000,
                             time_budget=max(
                                 0.05, deadline - _time.monotonic()))
            if status != -1:
                break
        if status == SAT:
            mkv, starts = extract()
            if mkv <= best_mk:
                best_mk, best_starts = mkv, starts
        elif status == UNSAT:
            proven_lb = t_try + 1
        else:
            break
    return JobshopSolution(
        makespan=int(best_mk),
        starts=best_starts,
        optimal=proven_lb >= best_mk,
    )


def solve_jobshop(instance: JobshopInstance,
                  max_time_in_seconds: float = 60.0,
                  horizon: Optional[int] = None,
                  disjunctive_branching: bool = True,
                  engine: str = "auto",
                  *, device="cuda",
                  ) -> Optional[JobshopSolution]:
    """Interval + no_overlap CP model (reference jobshop_sat.cc shape).

    ``engine="auto"|"lcg"`` routes to the native lazy-clause-generation
    prover (solve_jobshop_lcg); ``engine="cdcl"`` to the eager-order-
    encoding prover (solve_jobshop_cdcl) — both prove ft10-class
    instances; ``engine="cp"`` keeps the propagate+DFS CP engine.

    With ``disjunctive_branching`` the CP model adds machine-pair order
    booleans (b => end_i <= start_j; !b => end_j <= start_i) so the search
    branches on sequencing decisions instead of start values — the
    classical disjunctive-scheduling branching scheme (start values then
    follow by propagation)."""
    from ortools_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    if engine in ("auto", "lcg"):
        return solve_jobshop_lcg(
            instance, max_time_in_seconds=max_time_in_seconds,
            upper_bound=horizon,
        )
    if engine == "cdcl":
        return solve_jobshop_cdcl(
            instance, max_time_in_seconds=max_time_in_seconds,
            upper_bound=horizon,
        )
    from ortools_tpu_torch.sat import CpModel, CpSolver, FEASIBLE, OPTIMAL

    m = CpModel()
    horizon = horizon or instance.horizon
    all_ops = {}
    machine_ivs = {mm: [] for mm in range(instance.num_machines)}
    machine_ops = {mm: [] for mm in range(instance.num_machines)}
    for j, job in enumerate(instance.jobs):
        prev_end = None
        for o, (mach, dur) in enumerate(job):
            start = m.new_int_var(0, horizon, f"s_{j}_{o}")
            iv = m.new_fixed_size_interval_var(start, dur, f"iv_{j}_{o}")
            all_ops[j, o] = (start, dur)
            machine_ivs[mach].append(iv)
            machine_ops[mach].append((start, dur, j, o))
            if prev_end is not None:
                m.add(start >= prev_end)
            prev_end = start + dur
    order_bools = []
    for mach, ivs in machine_ivs.items():
        if len(ivs) > 1:
            m.add_no_overlap(ivs)
    if disjunctive_branching:
        for mach, ops in machine_ops.items():
            for a in range(len(ops)):
                for b in range(a + 1, len(ops)):
                    s1, d1, j1, o1 = ops[a]
                    s2, d2, j2, o2 = ops[b]
                    lit = m.new_bool_var(f"ord_m{mach}_{j1}{o1}_{j2}{o2}")
                    m.add(s1 + d1 <= s2).only_enforce_if(lit)
                    m.add(s2 + d2 <= s1).only_enforce_if(~lit)
                    order_bools.append(lit)
        # branch on sequencing decisions first
        m.add_decision_strategy(order_bools, "choose_first",
                                "select_min_value")
    makespan = m.new_int_var(0, horizon, "makespan")
    m.add_max_equality(
        makespan,
        [all_ops[j, len(job) - 1][0] + all_ops[j, len(job) - 1][1]
         for j, job in enumerate(instance.jobs)],
    )
    m.minimize(makespan)
    s = CpSolver(device=device)
    s.parameters.max_time_in_seconds = max_time_in_seconds
    status = s.solve(m)
    if status not in (OPTIMAL, FEASIBLE):
        return None
    starts = [
        [s.value(all_ops[j, o][0]) for o in range(len(job))]
        for j, job in enumerate(instance.jobs)
    ]
    return JobshopSolution(
        makespan=int(s.objective_value),
        starts=starts,
        optimal=status == OPTIMAL,
    )
