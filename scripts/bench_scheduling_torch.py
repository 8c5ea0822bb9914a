#!/usr/bin/env python3
"""Scheduling battery: the LCG core against the eager order encoding and
the DFS CP engine (port of ``scripts/bench_scheduling.py``, on the port's
``scheduling/jobshop.py`` and ``scheduling/rcpsp.py``).

The suite is the JAX script's: ft06 (optimum 55), ft10 (930,
``tests/data/ft10.jssp``), seeded instances of the Lawrence la01-la20
shapes (10x5, 15x5, 20x5, 10x10; two seeds each), ft06 and a seeded
10x5 with every duration x50 (the eager ladder's weakness), and PSPLIB's
j301_1 through ``solve_rcpsp`` (optimum 43).  Each jobshop runs on the
three engines under ``SCHED_BUDGET`` seconds (120 by default, the JAX
script's); an engine that claims an optimum other than the known one ends
the run with exit 1, and j301_1 must end OPTIMAL at 43.

ft06 and j301_1 are files of OR-Tools' ``ortools/scheduling/testdata``,
read from the directory that ``SCHED_TESTDATA`` names.  Where it is not
set or a file is missing, the rows that need it (ft06, ft06_x50,
psplib_j301_1) are skipped and named in ``skipped``; nothing is made up
in their place.

Host code: the LCG and CDCL cores and the CP engine reach no kernel;
``--device`` is passed to ``solve_jobshop`` and ``solve_rcpsp`` all the
same (the card by default, exit 2 without one; ``--device cpu`` on a
machine without a card).  Prints a line per row on stdout, ``#
launches: {...}`` on stderr, then one JSON line: the object the JAX
script writes, plus ``skipped``, ``device`` and ``power_limit_w`` (null
on the CPU); it also goes to ``build/bench/bench_scheduling_torch.json``.

    SCHED_TESTDATA=<ortools>/ortools/scheduling/testdata \\
        python3 scripts/bench_scheduling_torch.py [--device cpu]
"""

from __future__ import annotations

import json
import os
import random
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_torch import card, print_launches, save_json  # noqa: E402
from ortools_tpu_torch.scheduling.jobshop import (  # noqa: E402
    JobshopInstance, parse_jobshop, solve_jobshop, solve_jobshop_cdcl,
    solve_jobshop_lcg)
from ortools_tpu_torch.scheduling.rcpsp import (  # noqa: E402
    parse_rcpsp, solve_rcpsp)
from ortools_tpu_torch.utils.device import device_option_or_exit  # noqa: E402

BUDGET = float(os.environ.get("SCHED_BUDGET", "120"))


def testdata_file(name: str):
    """``name`` in the ``SCHED_TESTDATA`` directory, or None where the
    variable is unset or the file is missing."""
    folder = os.environ.get("SCHED_TESTDATA")
    if not folder:
        return None
    path = Path(folder) / name
    return path if path.is_file() else None


def seeded_instance(nj, nm, seed, dur_scale=1):
    rng = random.Random(seed)
    jobs = []
    for _ in range(nj):
        machines = list(range(nm))
        rng.shuffle(machines)
        jobs.append([(mach, rng.randint(5, 99) * dur_scale)
                     for mach in machines])
    return JobshopInstance(name=f"rand{nj}x{nm}_s{seed}", jobs=jobs)


def solve_engine(engine, inst, budget, device="cuda"):
    """The engine's solution (None where it found none)."""
    if engine == "lcg":
        return solve_jobshop_lcg(inst, max_time_in_seconds=budget)
    if engine == "eager":
        return solve_jobshop_cdcl(inst, max_time_in_seconds=budget)
    return solve_jobshop(inst, max_time_in_seconds=budget, engine="cp",
                         device=device)


def run_engine(engine, inst, budget, device="cuda"):
    t0 = time.perf_counter()
    try:
        r = solve_engine(engine, inst, budget, device)
    except Exception as e:  # noqa: BLE001 (records engine blowups, as the
        # JAX script does)
        return {"makespan": None, "optimal": False, "time": -1.0,
                "error": str(e)[:100]}
    dt = time.perf_counter() - t0
    if r is None:
        return {"makespan": None, "optimal": False, "time": dt}
    return {"makespan": r.makespan, "optimal": bool(r.optimal),
            "time": round(dt, 2)}


def suite() -> tuple:
    """(name, instance, known optimum) of each jobshop row, and the names
    of the rows skipped for a missing file."""
    rows, skipped = [], []
    ft06_path = testdata_file("ft06")
    ft06 = parse_jobshop(str(ft06_path)) if ft06_path else None
    if ft06 is not None:
        rows.append(("ft06", ft06, 55))
    else:
        skipped.append("ft06")
    rows.append(("ft10", parse_jobshop(str(ROOT / "tests/data/ft10.jssp")),
                 930))
    for shape, (nj, nm) in [("la01-style", (10, 5)),
                            ("la06-style", (15, 5)),
                            ("la11-style", (20, 5)),
                            ("la16-style", (10, 10))]:
        for seed in (1, 2):
            rows.append((f"{shape}_{nj}x{nm}_s{seed}",
                         seeded_instance(nj, nm, seed), None))
    if ft06 is not None:
        rows.append(("ft06_x50", JobshopInstance(
            name="ft06x50",
            jobs=[[(mm, d * 50) for mm, d in job] for job in ft06.jobs]),
            55 * 50))
    else:
        skipped.append("ft06_x50")
    rows.append(("la01-style_x50_s1", seeded_instance(10, 5, 1,
                                                      dur_scale=50), None))
    return rows, skipped


def _fmt(r):
    if r["makespan"] is None:
        return "   --      "
    return f"{r['makespan']:>5}{'*' if r['optimal'] else ' '} " \
           f"{r['time']:>6.1f}s"


def battery(device, budget: float = BUDGET) -> dict:
    rows, skipped = suite()
    results = {}
    for name, inst, known in rows:
        row = {engine: run_engine(engine, inst, budget, device)
               for engine in ("lcg", "eager", "cp")}
        row["known_optimum"] = known
        results[name] = row
        print(f"{name:<22} lcg: {_fmt(row['lcg'])}  eager: "
              f"{_fmt(row['eager'])}  cp: {_fmt(row['cp'])}  known: {known}",
              flush=True)
        for eng in ("lcg", "eager"):
            r = row[eng]
            if known is not None and r["optimal"] and r["makespan"] != known:
                raise RuntimeError(f"{eng} claims optimal {r['makespan']} "
                                   f"!= known {known}")

    # RCPSP: PSPLIB j30 instance with known optimum 43
    j301 = testdata_file("j301_1.sm")
    if j301 is None:
        skipped.append("psplib_j301_1")
    else:
        t0 = time.perf_counter()
        r = solve_rcpsp(parse_rcpsp(str(j301)), max_time_in_seconds=budget,
                        device=device)
        dt = time.perf_counter() - t0
        results["psplib_j301_1"] = {
            "lcg_routed_facade": {"makespan": r.makespan,
                                  "optimal": bool(r.optimal),
                                  "time": round(dt, 2)},
            "known_optimum": 43,
        }
        print(f"{'psplib_j301_1':<22} facade(lcg): {r.makespan}"
              f"{'*' if r.optimal else ''} {dt:>6.1f}s  known: 43")
        if not (r.makespan == 43 and r.optimal):
            raise RuntimeError(f"j301_1: makespan {r.makespan}, optimal "
                               f"{r.optimal}; known 43")
    if skipped:
        print(f"skipped (no file in SCHED_TESTDATA): {skipped}")
    return {"budget_s": budget, "results": results, "skipped": skipped}


def main(argv=None) -> int:
    device, _ = device_option_or_exit(
        sys.argv[1:] if argv is None else argv, "bench_scheduling_torch.py")
    try:
        out = battery(device)
    except RuntimeError as e:
        print(f"bench_scheduling_torch.py: {e}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        _, watts = card()
        out.update(device=torch.cuda.get_device_name(device),
                   power_limit_w=watts)
    else:
        out.update(device="cpu", power_limit_w=None)
    save_json("bench_scheduling_torch", out)
    print_launches()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
