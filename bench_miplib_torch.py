"""MIPLIB-easy-like battery on one CUDA card: 20 synthetic structured MIPs
vs HiGHS (port of ``bench_miplib.py``).

BASELINE.md target: ">= 80% of MIPLIB-easy matched to or-tools objectives".
The real MIPLIB set is not shipped; this battery is the stand-in declared
in SURVEY §6 — six structured families at the 100-1000 binary scale
(``ortools_tpu_torch/models/mip_generators.py``), solved by the port's
batched-PDHG branch-and-bound (``mip.branch_and_bound.solve`` on the card,
root cuts + pseudo-costs), objective-matched against
``scipy.optimize.milp`` (HiGHS) under the same time limit.

Prints a ``# <name>: ...`` line per instance and ``# launches: {...}`` on
stderr, then ONE JSON line:
  {"metric": "miplib_like_matched_frac", "value": ..., "unit": "frac",
   "vs_baseline": value/0.8, ...}
Each instance's record is ``bench_miplib.py``'s with one key added,
``feasible``: the verdict of the check of our solution against the rows,
bounds and integrality (None where the solve returned no solution).

Runs on the card only; without one it exits 2.

Usage: python3 bench_miplib_torch.py [scale] [time_limit_per_instance_sec]
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp

from bench_torch import print_launches
from ortools_tpu_torch.mip.branch_and_bound import solve as mip_solve
from ortools_tpu_torch.models.mip_generators import miplib_like_battery
from ortools_tpu_torch.utils.device import resolve_device_or_exit
from ortools_tpu_torch.utils.status import MPSolverStatus


def highs(qp, tlim: float):
    """scipy's HiGHS MILP on the minimization form, under ``tlim``."""
    qpm = qp.as_minimization()
    return milp(
        qpm.objective_vector,
        constraints=LinearConstraint(
            qpm.constraint_matrix, qpm.constraint_lower,
            qpm.constraint_upper),
        bounds=Bounds(qpm.variable_lower, qpm.variable_upper),
        integrality=np.asarray(qpm.integrality, dtype=float),
        options={"time_limit": tlim},
    )


def instance_record(qp, result, highs_result, seconds: float) -> dict:
    """The instance's record: our solution re-verified against the
    instance (feasibility + integrality) independently of the solver's
    status, its objective in the minimization sense, HiGHS's, and whether
    they match (bench_miplib.py:66-100)."""
    qpm = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0
    integ = np.asarray(qpm.integrality, dtype=float)
    # result.objective_value is in the ORIGINAL sense; sign converts it to
    # the minimization sense that scipy milp reports.  "matched" also
    # credits solutions strictly BETTER than HiGHS-at-the-time-limit.
    ours_min = math.nan
    feas = None
    if (result.status in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE)
            and not math.isnan(result.objective_value)):
        x = result.solution
        ax = qpm.constraint_matrix @ x
        rs = 1.0 + np.maximum(
            np.abs(np.where(np.isfinite(qpm.constraint_lower),
                            qpm.constraint_lower, 0.0)),
            np.abs(np.where(np.isfinite(qpm.constraint_upper),
                            qpm.constraint_upper, 0.0)))
        feas = bool(
            (ax >= qpm.constraint_lower - 1e-6 * rs).all()
            and (ax <= qpm.constraint_upper + 1e-6 * rs).all()
            and (x >= qpm.variable_lower - 1e-9).all()
            and (x <= qpm.variable_upper + 1e-9).all()
            and (np.abs(x[integ > 0] - np.round(x[integ > 0]))
                 <= 1e-6).all()
        )
        if feas:
            ours_min = sign * result.objective_value
    s = highs_result
    ref = s.fun if s.status in (0, 1) and s.fun is not None else math.nan
    # matched = at least as good as the reference answer (both are
    # subject to the same time limit), or equal within tolerance.
    matched = (
        not math.isnan(ours_min) and not math.isnan(ref)
        and ours_min <= ref + 1e-4 * (1.0 + abs(ref))
    )
    return {
        "name": qp.name,
        "n_bin": int(np.asarray(qpm.integrality).sum()),
        "status": str(result.status.name),
        "obj": None if math.isnan(ours_min) else round(ours_min, 6),
        "highs_obj": None if math.isnan(ref) else round(ref, 6),
        "matched": bool(matched),
        "feasible": feas,
        "nodes": result.num_nodes,
        "sec": round(seconds, 1),
    }


def main(argv=None) -> int:
    device = resolve_device_or_exit("cuda", "bench_miplib_torch.py")
    argv = sys.argv[1:] if argv is None else argv
    scale = float(argv[0]) if len(argv) > 0 else 1.0
    tlim = float(argv[1]) if len(argv) > 1 else 120.0

    results = []
    for qp in miplib_like_battery(scale=scale):
        t0 = time.perf_counter()
        r = mip_solve(qp, max_nodes=20_000, node_batch_size=64,
                      time_limit_sec=tlim, device=device)
        dt = time.perf_counter() - t0
        rec = instance_record(qp, r, highs(qp, tlim), dt)
        results.append(rec)
        print(f"# {qp.name}: ours={rec['obj']} highs={rec['highs_obj']} "
              f"matched={rec['matched']} nodes={r.num_nodes} {dt:.1f}s",
              file=sys.stderr, flush=True)

    print_launches()
    frac = sum(r["matched"] for r in results) / len(results)
    print(json.dumps({
        "metric": "miplib_like_matched_frac",
        "value": round(frac, 3),
        "unit": "frac",
        "vs_baseline": round(frac / 0.8, 3),
        "scale": scale,
        "time_limit_sec": tlim,
        "total_nodes": sum(r["nodes"] for r in results),
        "instances": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
