"""CP-SAT model runner CLI.

Capability parity: ``ortools/sat/sat_runner.cc`` — solve a serialized CP
model from a file:

    python -m ortools_tpu.sat.runner model.json [--time_limit S]
        [--num_workers N] [--all_solutions] [--device cuda|cpu]

Models are the JSON serialization of sat/serialization.py (the framework's
CpModelProto-dump equivalent; write one with ``model_to_json(model.ir)``)
— or, matching the reference runner's direct-input formats, a DIMACS
``.cnf``, weighted max-SAT ``.wcnf``, or pseudo-Boolean ``.opb`` file
(sat/sat_io.py; reference sat_cnf_reader.h / opb_reader.h).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ortools_tpu.sat.runner")
    p.add_argument("model", help="path to a JSON-serialized CP model")
    p.add_argument("--time_limit", type=float, default=None)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--all_solutions", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ortools_tpu_torch.sat.params import SatParameters
    from ortools_tpu_torch.sat.sat_io import read_problem_file
    from ortools_tpu_torch.sat.solver import solve_model
    from ortools_tpu_torch.utils.status import SolveStatus
    from ortools_tpu_torch.utils.device import resolve_device_or_exit

    device = resolve_device_or_exit(args.device, p.prog)
    model = read_problem_file(args.model)
    params = SatParameters(num_workers=args.num_workers)
    if args.time_limit is not None:
        params.max_time_in_seconds = args.time_limit
    if args.all_solutions:
        params.enumerate_all_solutions = True
    count = [0]
    callback = None
    if args.all_solutions:
        from ortools_tpu_torch.sat.cp_model import CpSolverSolutionCallback

        class _Counter(CpSolverSolutionCallback):
            def on_solution_callback(self):
                count[0] += 1

        callback = _Counter()
    resp = solve_model(model, params, callback, device=device)
    print(f"Model: {model.name or args.model} "
          f"({len(model.variables)} vars, {len(model.constraints)} cts)")
    print(f"Status: {resp.status.name}")
    if model.objective is not None and resp.solution is not None:
        print(f"Objective: {resp.objective_value}")
        print(f"Best bound: {resp.best_objective_bound}")
    if args.all_solutions:
        print(f"Solutions: {count[0]}")
    print(f"Branches: {resp.num_branches}  Conflicts: {resp.num_conflicts}")
    print(f"Walltime: {resp.wall_time:.3f}s")
    if resp.solution is not None and len(resp.solution) <= 50:
        for i, v in enumerate(model.variables):
            print(f"  {v.name} = {resp.solution[i]}")
    return 0 if resp.status in (SolveStatus.OPTIMAL,
                                SolveStatus.FEASIBLE) else 1


if __name__ == "__main__":
    sys.exit(main())
