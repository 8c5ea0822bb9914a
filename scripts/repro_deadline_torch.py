#!/usr/bin/env python3
"""How far ``mip.solve`` overruns its time limit on a battery instance
(port of ``scripts/repro_deadline.py``): ``mip.solve`` under its defaults
with ``max_nodes=20000`` and ``node_batch_size=64`` on the card, then one
line with the status, objective, nodes, wall seconds and the overrun
(wall / limit).  Runs on the card only; without one it exits 2.

    python3 scripts/repro_deadline_torch.py [LIMIT_SEC] [NAME]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ortools_tpu_torch.mip import MipParams  # noqa: E402
from ortools_tpu_torch.mip.branch_and_bound import solve as mip_solve  # noqa: E402
from ortools_tpu_torch.models.mip_generators import miplib_like_battery  # noqa: E402
from ortools_tpu_torch.utils.device import resolve_device_or_exit  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = resolve_device_or_exit("cuda", "repro_deadline_torch.py")
    tlim = float(argv[0]) if argv else 90.0
    name = argv[1] if len(argv) > 1 else "edge_packing_300_s15"
    qp = next(q for q in miplib_like_battery(scale=1.0) if q.name == name)
    t0 = time.perf_counter()
    r = mip_solve(qp, MipParams(max_nodes=20_000, node_batch_size=64,
                                time_limit_sec=tlim), device=device)
    dt = time.perf_counter() - t0
    print(f"{name}: status={r.status.name} obj={r.objective_value} "
          f"nodes={r.num_nodes} wall={dt:.1f}s limit={tlim}s "
          f"overrun={dt / tlim:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
