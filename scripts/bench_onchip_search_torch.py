#!/usr/bin/env python3
"""On-chip search on one CUDA card: batched node LPs and the device
feasibility jump, each beside a host baseline (port of
``scripts/bench_onchip_search.py``).

A. **Batched node-LP PDHG** (``pdlp/batched.py::solve_batch``): the root
   of ``multicommodity_flow_lp(120, 800, 32, seed=1)`` (4,640 rows, 25,600
   columns) at B = 1, then 128 node bound sets drawn from
   ``np.random.default_rng(0)`` by the JAX script's draws (each pins 1-12
   random flows at their root values, so the root's point stays feasible),
   solved in two batches of 64 warm-started from the root's x and y, each
   with a 240 s deadline.  f32, eps 1e-4, at most 60,000 iterations.  The
   host baseline is the port's copy of ``glop/simplex.py::RevisedSimplex``,
   cold, on the same nodes until its time limit.
B. **Device feasibility jump** (``sat/fj_device.py``) in objective-descent
   mode on ``set_cover(250, 100, seed=2)``: the greedy cover's cost times
   0.99 is the cutoff; 64 seeds, 128 steps a round, at most 60 rounds,
   from the greedy x, for 120 s.  The host baseline is the port's copy of
   ``sat/feasibility_jump.py`` with 8 seeds run one after another until
   its time limit.  A cover the device finds is checked in numpy (x
   binary, every row covered, its cost at or below the cutoff); a failed
   check exits 1 with no JSON.  The device FJ draws from a
   ``torch.Generator``, so its trajectory is not the JAX package's.

Both host limits are 120 s, the JAX script's; ``--host-limit SECONDS``
cuts them.  Prints ``# nvidia-smi: ...``, ``# cover check: ...``, ``# peak
device memory: ...`` and ``# launches: {...}`` on stderr, then one JSON line with the JAX script's
keys, each ``tpu_`` key named ``device_``, ``devices`` the card's name,
plus ``device`` and ``power_limit_w``; the same JSON goes to
``build/bench/bench_onchip_search_torch.json``.  Runs on the card only;
without one it exits 2.

    python3 scripts/bench_onchip_search_torch.py [--host-limit SECONDS]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import (BenchFailure, card, print_launches,  # noqa: E402
                         print_peak_memory, require, save_json)
from ortools_tpu_torch.glop.simplex import RevisedSimplex  # noqa: E402
from ortools_tpu_torch.mip.heuristics import detect_set_cover  # noqa: E402
from ortools_tpu_torch.models.generators import multicommodity_flow_lp  # noqa: E402
from ortools_tpu_torch.models.mip_generators import set_cover  # noqa: E402
from ortools_tpu_torch.pdlp import batched  # noqa: E402
from ortools_tpu_torch.pdlp.params import PdhgParams  # noqa: E402
from ortools_tpu_torch.sat import fj_device  # noqa: E402
from ortools_tpu_torch.sat.feasibility_jump import (  # noqa: E402
    LinearSystem, feasibility_jump)
from ortools_tpu_torch.utils.device import resolve_device_or_exit  # noqa: E402
from ortools_tpu_torch.utils.status import MPSolverStatus  # noqa: E402

N_NODES, BATCH = 128, 64
HOST_LIMIT = 120.0  # both host baselines' limit, the JAX script's
NODE_DEADLINE = 240.0
FJ_DEADLINE = 120.0
FJ_SEEDS = 64


def node_bounds(qp, x_root: np.ndarray, rng: np.random.Generator,
                n_nodes: int = N_NODES) -> tuple:
    """The node bound sets: node i pins ``1 + rng.integers(0, 12)`` random
    flows at max(0, their root value), the JAX script's draws in its
    order."""
    n = qp.num_variables
    lb0 = np.asarray(qp.variable_lower, dtype=np.float64)
    ub0 = np.asarray(qp.variable_upper, dtype=np.float64)
    lbs = np.repeat(lb0[None], n_nodes, axis=0)
    ubs = np.repeat(ub0[None], n_nodes, axis=0)
    for i in range(n_nodes):
        depth = 1 + int(rng.integers(0, 12))
        fix = rng.choice(n, size=depth, replace=False)
        v = np.maximum(0.0, x_root[fix])
        lbs[i, fix] = v
        ubs[i, fix] = v
    return lbs, ubs


def bench_node_lps(device, host_limit: float = HOST_LIMIT) -> dict:
    """Part A: the root at B = 1, the 128 node LPs in batches of 64
    warm-started from the root, then the host's cold simplex on the same
    nodes until ``host_limit`` seconds have passed."""
    qp = multicommodity_flow_lp(120, 800, 32, seed=1).as_minimization()
    n = qp.num_variables
    rng = np.random.default_rng(0)
    params = PdhgParams(dtype=torch.float32, eps_optimal_absolute=1e-4,
                        eps_optimal_relative=1e-4, iteration_limit=60_000)

    lb0 = np.asarray(qp.variable_lower, dtype=np.float64)
    ub0 = np.asarray(qp.variable_upper, dtype=np.float64)
    t0 = time.perf_counter()
    root = batched.solve_batch(qp, lb0[None], ub0[None], params,
                               device=device)
    root_time = time.perf_counter() - t0
    x_root = root.primal_solution[0]
    y_root = root.dual_solution[0]

    lbs, ubs = node_bounds(qp, x_root, rng)
    warm_x = np.repeat(x_root[None], BATCH, axis=0)
    warm_y = np.repeat(y_root[None], BATCH, axis=0)
    t0 = time.perf_counter()
    n_opt = n_inf = 0
    for s in range(0, N_NODES, BATCH):
        r = batched.solve_batch(
            qp, lbs[s:s + BATCH], ubs[s:s + BATCH], params,
            warm_start_x=warm_x, warm_start_y=warm_y,
            deadline=time.perf_counter() + NODE_DEADLINE, device=device)
        n_opt += int(r.optimal.sum())
        n_inf += int(r.primal_infeasible.sum())
    dt = time.perf_counter() - t0
    device_nodes_per_sec = N_NODES / dt

    # host baseline: the Python revised simplex, cold (the native dense
    # small-LP core is range-gated far below this size)
    t0 = time.perf_counter()
    host_opt = host_nodes = 0
    host_deadline = time.perf_counter() + host_limit
    for i in range(N_NODES):
        if time.perf_counter() > host_deadline:
            break
        try:
            sx = RevisedSimplex(qp)
            sx.set_variable_bounds(lbs[i], ubs[i])
            st = sx.primal_solve(max_iterations=20_000,
                                 deadline=host_deadline)
            host_opt += st == MPSolverStatus.OPTIMAL
        except Exception as e:  # noqa: BLE001 (the JAX script counts a
            # failed node as run, not optimal)
            print(f"# host simplex, node {i}: {type(e).__name__}: {e}",
                  file=sys.stderr)
        host_nodes += 1
    host_dt = time.perf_counter() - t0
    host_nodes_per_sec = host_nodes / host_dt if host_dt > 0 else 0.0

    return {
        "instance": qp.name,
        "n_vars": int(n),
        "n_rows": int(qp.num_constraints),
        "n_nodes": N_NODES,
        "batch": BATCH,
        "root_solve_sec": round(root_time, 3),
        "device_nodes_per_sec": round(device_nodes_per_sec, 2),
        "device_wall_sec": round(dt, 2),
        "device_optimal": n_opt,
        "device_infeasible": n_inf,
        "host_backend": "python revised simplex (cold; the native small-LP core is range-gated far below this size)",
        "host_nodes_per_sec": round(host_nodes_per_sec, 2),
        "host_nodes_run": host_nodes,
        "host_optimal": host_opt,
        "speedup_vs_host": round(device_nodes_per_sec
                                 / max(host_nodes_per_sec, 1e-9), 2),
    }


def greedy_cover(qp) -> tuple:
    """The JAX script's greedy cover: (its columns, their cost, x)."""
    sc = detect_set_cover(qp)
    require(sc is not None, f"{qp.name} is not a set-cover model")
    rows_of_col, cols_of_row, cost = sc
    a = sp.csr_matrix(qp.constraint_matrix)
    chosen = []
    covered = np.zeros(len(cols_of_row), dtype=bool)
    at = a.T.tocsr()
    while not covered.all():
        gains = at @ (~covered).astype(float)
        scorev = np.where(gains > 0, cost / np.maximum(gains, 1e-9), np.inf)
        j = int(np.argmin(scorev))
        chosen.append(j)
        covered[rows_of_col[j]] = True
    x = np.zeros(qp.num_variables)
    x[chosen] = 1.0
    return chosen, float(cost[chosen].sum()), x


def check_cover(qp, x: np.ndarray, cutoff: float, tol: float = 1e-6) -> list:
    """What a cover fails of: x binary, every row covered, cost at or below
    the cutoff.  Empty when it passes."""
    a = sp.csr_matrix(qp.constraint_matrix)
    fails = []
    if not np.all((x == 0.0) | (x == 1.0)):
        fails.append("x is not binary")
    uncovered = int(np.sum(a @ x < np.asarray(qp.constraint_lower) - tol))
    if uncovered:
        fails.append(f"{uncovered} rows uncovered")
    cost = float(qp.objective_vector @ x)
    if cost > cutoff + tol * (1 + abs(cutoff)):
        fails.append(f"cost {cost!r} above the cutoff {cutoff!r}")
    return fails


def bench_device_fj(device, host_limit: float = HOST_LIMIT) -> dict:
    """Part B: the device FJ against the greedy cover's cutoff, then the
    host FJ on the same system until ``host_limit`` seconds have
    passed."""
    qp = set_cover(250, 100, seed=2).as_minimization()
    cost = np.asarray(qp.objective_vector, dtype=np.float64)
    a = sp.csr_matrix(qp.constraint_matrix)
    _, greedy_cost, x_greedy = greedy_cover(qp)
    cutoff = greedy_cost * 0.99
    a2, lb2, ub2 = fj_device.objective_descent_system(
        a, qp.constraint_lower, qp.constraint_upper, cost, cutoff)

    t0 = time.perf_counter()
    res = fj_device.device_feasibility_jump(
        a2, lb2, ub2, n_seeds=FJ_SEEDS, steps_per_round=128, max_rounds=60,
        seed=1, x0=x_greedy, deadline=time.perf_counter() + FJ_DEADLINE,
        device=device)
    dev_dt = time.perf_counter() - t0
    dev_found = bool(res.solutions)
    dev_cost = float(cost @ res.solutions[0]) if dev_found else None
    if dev_found:
        fails = check_cover(qp, res.solutions[0], cutoff)
        print(f"# cover check: {'passed' if not fails else fails} (cost "
              f"{dev_cost!r}, cutoff {cutoff!r}, {res.rounds_run} rounds)",
              file=sys.stderr)
        require(not fails, f"the device FJ's cover fails: {fails}")
    else:
        print(f"# cover check: no cover found in {res.rounds_run} rounds",
              file=sys.stderr)

    sys_h = LinearSystem(a=sp.csr_matrix(a2), row_lb=lb2, row_ub=ub2,
                         var_lb=np.zeros(qp.num_variables),
                         var_ub=np.ones(qp.num_variables))
    t0 = time.perf_counter()
    host_deadline = t0 + host_limit
    x_h = None
    for s in range(8):  # the host runs seeds sequentially
        x_h = feasibility_jump(sys_h, x0=x_greedy, seed=s,
                               deadline=host_deadline)
        if x_h is not None or time.perf_counter() > host_deadline:
            break
    host_dt = time.perf_counter() - t0
    host_found = x_h is not None
    host_cost = float(cost @ x_h) if host_found else None

    return {
        "instance": qp.name,
        "greedy_cost": round(greedy_cost, 6),
        "cutoff": round(cutoff, 6),
        "device_found": dev_found,
        "device_cost": None if dev_cost is None else round(dev_cost, 6),
        "device_sec": round(dev_dt, 2),
        "device_moves_per_sec": round(res.moves_per_second, 1),
        "device_seeds": FJ_SEEDS,
        "host_found": host_found,
        "host_cost": None if host_cost is None else round(host_cost, 6),
        "host_sec": round(host_dt, 2),
        "device_beats_host": bool(
            dev_found and (not host_found or dev_dt < host_dt)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_onchip_search_torch.py")
    ap.add_argument("--host-limit", type=float, default=HOST_LIMIT,
                    help="seconds of each host baseline (default 120)")
    args = ap.parse_args(argv)
    device = resolve_device_or_exit("cuda", "bench_onchip_search_torch.py")
    smi, watts = card()
    print(f"# nvidia-smi: {smi}", file=sys.stderr, flush=True)
    try:
        out = {
            "metric": "onchip_search",
            "devices": [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())],
            "node_lp_pdhg": bench_node_lps(device, args.host_limit),
            "feasibility_jump": bench_device_fj(device, args.host_limit),
            "device": torch.cuda.get_device_name(device),
            "power_limit_w": watts,
        }
    except BenchFailure as e:
        print(f"bench_onchip_search_torch.py: {e}", file=sys.stderr)
        return 1
    save_json("bench_onchip_search_torch", out)
    print_peak_memory(device)
    print_launches()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
