"""CP-SAT sample (parity: sat/samples/simple_sat_program)."""

import argparse

from ortools_tpu_torch.sat import CpModel, CpSolver, OPTIMAL


def main(device="cuda"):
    model = CpModel()
    x = model.new_int_var(0, 2, "x")
    y = model.new_int_var(0, 2, "y")
    z = model.new_int_var(0, 2, "z")
    model.add(x != y)
    solver = CpSolver(device=device)
    status = solver.solve(model)
    assert status == OPTIMAL
    print(f"x = {solver.value(x)}")
    print(f"y = {solver.value(y)}")
    print(f"z = {solver.value(z)}")
    assert solver.value(x) != solver.value(y)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
