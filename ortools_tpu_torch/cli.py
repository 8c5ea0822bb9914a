"""Command-line front-end, the PyTorch port of ``ortools_tpu/cli.py``.

Capability parity: ``ortools/linear_solver/solve.cc`` (MPS/LP solve CLI,
flags at solve.cc:78-112) and ``ortools/sat/sat_runner.cc`` scoped to:

    python -m ortools_tpu_torch solve --input model.mps
        [--solver pdlp|glop|sat|mip|auto] [--time_limit SEC]
        [--sol_file out.sol] [--device cuda|cpu]

Prints the standard status / objective / walltime block and optionally
writes a .sol file (MIPLIB format: objective comment + name value lines).
``--device`` names the device the pdlp and mip routes run on: the card by
default; with no card the command exits non-zero unless it is
``--device cpu``.

    python -m ortools_tpu_torch bench

runs ``bench_torch.py`` from the working directory (the root of a
checkout), as the JAX command runs ``bench.py``: on the card only; with no
card it exits 2.
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_solve(args: argparse.Namespace) -> int:
    from ortools_tpu_torch.linear_solver import Model, Solver
    from ortools_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ortools_tpu_torch: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    model = Model.import_from_mps_file(args.input)
    parse_time = time.perf_counter() - t0
    solver = Solver(args.solver, device=device)
    kw = {}
    if args.time_limit is not None and args.solver == "pdlp":
        kw["time_sec_limit"] = args.time_limit
    t0 = time.perf_counter()
    status = solver.solve(model, **kw)
    solve_time = time.perf_counter() - t0
    print(f"Model:    {model.name or args.input} "
          f"({model.num_variables} vars, {model.num_constraints} rows)")
    print(f"Solver:   {args.solver}")
    print(f"Status:   {status.name}")
    print(f"Objective: {solver.objective_value:.10g}")
    print(f"Parse time: {parse_time:.3f}s  Solve time: {solve_time:.3f}s")
    if args.sol_file:
        with open(args.sol_file, "w") as f:
            f.write(f"=obj= {solver.objective_value:.17g}\n")
            for j, name in enumerate(model.var_names):
                f.write(f"{name} {solver._values[j]:.17g}\n")
        print(f"Solution written to {args.sol_file}")
    return 0 if status.name in ("OPTIMAL", "FEASIBLE") else 1


def _cmd_bench(args: argparse.Namespace) -> int:
    import runpy

    from ortools_tpu_torch.utils.device import resolve_device

    try:
        resolve_device("cuda")
    except RuntimeError as e:
        print(f"ortools_tpu_torch: {e}", file=sys.stderr)
        return 2
    sys.argv = ["bench_torch.py"]
    runpy.run_path("bench_torch.py", run_name="__main__")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ortools_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("solve", help="solve an MPS model")
    ps.add_argument("--input", required=True)
    ps.add_argument("--solver", default="pdlp",
                    choices=["pdlp", "glop", "sat", "mip", "auto"])
    ps.add_argument("--time_limit", type=float, default=None)
    ps.add_argument("--sol_file", default=None)
    ps.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ps.set_defaults(fn=_cmd_solve)
    pb = sub.add_parser("bench", help="run the benchmark on the card")
    pb.set_defaults(fn=_cmd_bench)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
