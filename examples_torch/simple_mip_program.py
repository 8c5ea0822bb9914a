"""MIP sample (parity: linear_solver/samples/simple_mip_program)."""

import argparse
import math

from ortools_tpu_torch.linear_solver import Model, Solver


def main(device="cuda"):
    model = Model("simple_mip")
    x = model.new_int_var(0, math.inf, "x")
    y = model.new_int_var(0, math.inf, "y")
    model.add(x + 7 * y <= 17.5)
    model.add(x <= 3.5)
    model.maximize(x + 10 * y)
    solver = Solver("sat", device=device)
    status = solver.solve(model)
    print(f"Status: {status.name}")
    print(f"Objective = {solver.objective_value}")
    print(f"x = {solver.value(x)}, y = {solver.value(y)}")
    assert solver.objective_value == 23  # x=3, y=2
    return solver.objective_value


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
