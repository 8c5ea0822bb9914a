#!/usr/bin/env python3
"""Routing local-search depth battery (port of
``scripts/bench_routing.py``, on the port's ``RoutingModel``).

Ten seeded Solomon-style VRPTW instances (clustered and uniform customers,
capacities, time windows), each solved under the same wall budget at
operator level 1 (2-opt and relocate-1) and level 2 (the full catalogue:
Or-opt chains, cross-exchange, make-active and make-inactive), beside a
fixed-budget portfolio of first-solution strategies and a long-budget
multi-start best (the stand-in for published best-known values).

The budget is ``ROUTING_BUDGET`` seconds (10 by default, the JAX
script's).  Host code: the one route that reaches the card, the CP-SAT
certification, is not taken by these searches; ``--device`` is passed to
``RoutingModel`` all the same (the card by default, exit 2 without one;
``--device cpu`` on a machine without a card).

Prints a line per instance on stdout, ``# launches: {...}`` on stderr,
then one JSON line: the object the JAX script writes, plus ``device`` and
``power_limit_w`` (null on the CPU); it also goes to
``build/bench/bench_routing_torch.json``.

    python3 scripts/bench_routing_torch.py [--device cpu]
"""

from __future__ import annotations

import json
import os
import random
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, print_launches, save_json  # noqa: E402
from ortools_tpu_torch.routing import (  # noqa: E402
    FirstSolutionStrategy, LocalSearchMetaheuristic, RoutingIndexManager,
    RoutingModel, default_routing_search_parameters)
from ortools_tpu_torch.utils.device import device_option_or_exit  # noqa: E402

BUDGET = float(os.environ.get("ROUTING_BUDGET", "10"))
VEHICLES = 4
SERVICE = 10


def seeded_vrptw(seed, n=28, vehicles=VEHICLES, clustered=True):
    rng = random.Random(seed)
    pts = [(50.0, 50.0)]  # depot
    if clustered:
        centers = [(rng.uniform(10, 90), rng.uniform(10, 90))
                   for _ in range(4)]
        for _ in range(n - 1):
            cx, cy = rng.choice(centers)
            pts.append((cx + rng.gauss(0, 6), cy + rng.gauss(0, 6)))
    else:
        for _ in range(n - 1):
            pts.append((rng.uniform(0, 100), rng.uniform(0, 100)))
    d = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            d[i, j] = round(((pts[i][0] - pts[j][0]) ** 2
                             + (pts[i][1] - pts[j][1]) ** 2) ** 0.5)
    demand = [0] + [rng.randint(1, 9) for _ in range(n - 1)]
    cap = max(12, int(sum(demand) / vehicles * 1.35))
    tw = [(0, 10_000)]
    for i in range(1, n):
        a = rng.randint(0, 600)
        tw.append((a, a + rng.randint(150, 400)))
    return d, demand, cap, tw


def instance_data(seed):
    return seeded_vrptw(seed, clustered=(seed % 2 == 0))


def build_instance(seed, device="cuda"):
    """(the model, its index manager) of seed's VRPTW."""
    d, demand, cap, tw = instance_data(seed)
    n = d.shape[0]
    mgr = RoutingIndexManager(n, VEHICLES, 0)
    routing = RoutingModel(mgr, device=device)
    cb = routing.register_transit_callback(
        lambda f, t: int(d[mgr.index_to_node(f), mgr.index_to_node(t)]))
    routing.set_arc_cost_evaluator_of_all_vehicles(cb)
    dem = routing.register_unary_transit_callback(
        lambda f: demand[mgr.index_to_node(f)])
    routing.add_dimension_with_vehicle_capacity(
        dem, 0, [cap] * VEHICLES, True, "Capacity")
    # travel time = distance; service 10 at each stop
    tt = routing.register_transit_callback(
        lambda f, t: int(d[mgr.index_to_node(f),
                           mgr.index_to_node(t)]) + SERVICE)
    routing.add_dimension(tt, 10_000, 20_000, True, "Time")
    time_dim = routing.get_dimension_or_die("Time")
    for node in range(1, n):
        idx = mgr.node_to_index(node)
        time_dim.set_cumul_var_range(idx, tw[node][0], tw[node][1])
    return routing, mgr


def search_params(level, budget=None, meta=None, strategy=None):
    params = default_routing_search_parameters()
    params.time_limit_seconds = budget if budget is not None else BUDGET
    params.local_search_metaheuristic = (
        meta if meta is not None
        else LocalSearchMetaheuristic.GUIDED_LOCAL_SEARCH)
    params.first_solution_strategy = (
        strategy if strategy is not None
        else FirstSolutionStrategy.PATH_CHEAPEST_ARC)
    params.ls_operator_level = level
    return params


def solve_instance(seed, level, budget=None, meta=None, strategy=None,
                   device="cuda"):
    routing, _ = build_instance(seed, device)
    params = search_params(level, budget, meta, strategy)
    t0 = time.perf_counter()
    sol = routing.solve_with_parameters(params)
    dt = time.perf_counter() - t0
    if sol is None:
        return None, dt
    return sol.objective_value(), dt


def best_known_proxy(seed, device="cuda"):
    """Long-budget multi-start best over strategies x metaheuristics: the
    battery's stand-in for published best-known values."""
    best = None
    for strat in (FirstSolutionStrategy.PATH_CHEAPEST_ARC,
                  FirstSolutionStrategy.SAVINGS,
                  FirstSolutionStrategy.SWEEP):
        for meta in (LocalSearchMetaheuristic.GUIDED_LOCAL_SEARCH,
                     LocalSearchMetaheuristic.SIMULATED_ANNEALING):
            o, _ = solve_instance(seed, 2, budget=2.5 * BUDGET,
                                  meta=meta, strategy=strat, device=device)
            if o is not None and (best is None or o < best):
                best = o
    return best


def battery(device) -> dict:
    results = []
    wins = 0
    within5 = 0
    for seed in range(1, 11):
        bk = best_known_proxy(seed, device)
        o1, _ = solve_instance(seed, level=1, device=device)
        o2, _ = solve_instance(seed, level=2, device=device)
        # fixed-budget portfolio row: best of the catalogue at level 2
        o_best = o2
        for strat in (FirstSolutionStrategy.SAVINGS,
                      FirstSolutionStrategy.SWEEP):
            ox, _ = solve_instance(seed, 2, strategy=strat, device=device)
            if ox is not None and (o_best is None or ox < o_best):
                o_best = ox
        gain = (o1 - o2) / o1 * 100 if o1 and o2 else float("nan")
        wins += int(o2 is not None and (o1 is None or o2 <= o1))
        ok5 = (o_best is not None and bk is not None
               and o_best <= bk * 1.05)
        within5 += int(ok5)
        print(f"vrptw_s{seed:<3} bk~{bk}  level1: {o1}  level2: {o2}  "
              f"best: {o_best}  gain {gain:+.1f}%  within5%: {ok5}",
              flush=True)
        results.append({"seed": seed, "best_known_proxy": bk,
                        "level1": o1, "level2": o2,
                        "catalogue_best": o_best,
                        "within_5pct": bool(ok5),
                        "gain_pct": None if gain != gain
                        else round(gain, 2)})
    print(f"level2 at-least-as-good on {wins}/{len(results)}; "
          f"within 5% of best-known proxy on {within5}/{len(results)}")
    return {"budget_s": BUDGET, "instances": results,
            "level2_no_worse_frac": wins / len(results),
            "within_5pct_frac": within5 / len(results)}


def main(argv=None) -> int:
    device, _ = device_option_or_exit(
        sys.argv[1:] if argv is None else argv, "bench_routing_torch.py")
    out = battery(device)
    if device.type == "cuda":
        _, watts = card()
        out.update(device=torch.cuda.get_device_name(device),
                   power_limit_w=watts)
    else:
        out.update(device="cpu", power_limit_w=None)
    save_json("bench_routing_torch", out)
    print_launches()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
