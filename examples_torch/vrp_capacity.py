"""Capacitated VRP sample (parity: constraint_solver/samples/cvrp)."""

import argparse

import numpy as np

from ortools_tpu_torch.routing import RoutingIndexManager, RoutingModel


def main(device="cuda"):
    rng = np.random.default_rng(0)
    n, vehicles, cap = 13, 3, 15  # total demand 38 <= 45
    pts = rng.uniform(0, 100, (n, 2))
    dist = np.round(
        np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    ).astype(np.int64)
    demands = np.concatenate([[0], rng.integers(1, 5, n - 1)])

    manager = RoutingIndexManager(n, vehicles, 0)
    routing = RoutingModel(manager, device=device)
    transit = routing.register_transit_callback(
        lambda f, t: int(dist[f, t])
    )
    routing.set_arc_cost_evaluator_of_all_vehicles(transit)
    demand_cb = routing.register_unary_transit_callback(
        lambda f: int(demands[f])
    )
    routing.add_dimension_with_vehicle_capacity(
        demand_cb, 0, [cap] * vehicles, True, "Capacity"
    )
    solution = routing.solve()
    assert solution is not None
    print(f"Objective: {solution.objective_value()}")
    for v, route in enumerate(solution.routes()):
        nodes = [manager.index_to_node(i) for i in route]
        load = sum(demands[x] for x in nodes[1:-1])
        print(f"  Vehicle {v}: {' -> '.join(map(str, nodes))} (load {load})")
        assert load <= cap
    return solution.objective_value()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
