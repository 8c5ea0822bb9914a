"""Linear programming sample (parity: linear_solver/samples/simple_lp_program)."""

import argparse
import math

from ortools_tpu_torch.linear_solver import Model, Solver
from ortools_tpu_torch.utils.device import resolve_device


def main(device="cuda"):
    # glop is host code: the device is checked, and used nowhere
    resolve_device(device)
    model = Model("simple_lp")
    x = model.new_num_var(0, math.inf, "x")
    y = model.new_num_var(0, math.inf, "y")
    model.add(x + 2 * y <= 14)
    model.add(3 * x - y >= 0)
    model.add(x - y <= 2)
    model.maximize(3 * x + 4 * y)
    solver = Solver("glop")
    status = solver.solve(model)
    print(f"Status: {status.name}")
    print(f"Objective = {solver.objective_value}")
    print(f"x = {solver.value(x)}, y = {solver.value(y)}")
    assert abs(solver.objective_value - 34.0) < 1e-6
    return solver.objective_value


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
