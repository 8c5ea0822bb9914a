#!/usr/bin/env python3
"""OPB battery: PB resolution (cutting planes) against clause learning on
pigeonhole PB models (port of ``scripts/bench_opb.py``, on the port's
``sat_io.read_opb`` and ``solve_model``; the PB core ``_native/pbsat.cc``
is a byte copy).

Both engines run through ``solve_model``; only ``use_pb_resolution``
differs.  Host code: no model of the battery takes the MaxHS route, the
one that reaches the card, so it launches no kernel; ``--device`` is
passed to ``solve_model`` all the same (the card by default, exit 2
without one; ``--device cpu`` on a machine without a card).

Prints a ``# <model>: ...`` line per model and ``# launches: {...}`` on
stderr, then one JSON line with the JAX script's keys (without
``instances``) plus ``device`` and ``power_limit_w`` (null on the CPU);
the whole object goes to ``build/bench/bench_opb_torch.json``.

    python3 scripts/bench_opb_torch.py [time_limit_sec] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, print_launches, save_json  # noqa: E402
from ortools_tpu_torch.sat.params import SatParameters  # noqa: E402
from ortools_tpu_torch.sat.sat_io import read_opb  # noqa: E402
from ortools_tpu_torch.sat.solver import solve_model  # noqa: E402
from ortools_tpu_torch.utils.device import device_option_or_exit  # noqa: E402


def php_opb_text(n: int) -> str:
    """The pigeonhole PB model of n + 1 pigeons and n holes, as OPB."""
    P, H = n + 1, n
    lines = [f"* pigeonhole {P} pigeons {H} holes"]

    def v(p, h):
        return f"x{p * H + h + 1}"

    for p in range(P):
        lines.append(" ".join(f"+1 {v(p, h)}" for h in range(H)) + " >= 1 ;")
    for h in range(H):
        lines.append(" ".join(f"-1 {v(p, h)}" for p in range(P))
                     + " >= -1 ;")
    return "\n".join(lines)


def php_opb(n: int):
    return read_opb(php_opb_text(n), name=f"php_{n + 1}_{n}")


def run(model, use_pb: bool, tl: float, device="cuda") -> dict:
    params = SatParameters(max_time_in_seconds=tl,
                           use_pb_resolution=use_pb,
                           use_feasibility_jump=False)
    t0 = time.perf_counter()
    r = solve_model(model, params, device=device)
    return {
        "status": r.status.name,
        "sec": round(time.perf_counter() - t0, 2),
        "conflicts": int(r.num_conflicts),
    }


def battery(tl: float, device) -> dict:
    out = {"metric": "opb_pigeonhole_separation", "time_limit_sec": tl,
           "instances": []}
    for n in (8, 10, 12, 14, 16):
        m = php_opb(n)
        pb = run(m, True, tl, device)
        cl = run(m, False, tl, device)
        out["instances"].append({"name": m.name, "n_vars": (n + 1) * n,
                                 "pb_resolution": pb,
                                 "clause_learning": cl})
        print(f"# {m.name}: pb={pb['status']} {pb['sec']}s "
              f"({pb['conflicts']} confl)  clause={cl['status']} "
              f"{cl['sec']}s ({cl['conflicts']} confl)", file=sys.stderr)
    out["pb_solved"] = sum(r["pb_resolution"]["status"] == "INFEASIBLE"
                           for r in out["instances"])
    out["clause_solved"] = sum(
        r["clause_learning"]["status"] == "INFEASIBLE"
        for r in out["instances"])
    return out


def main(argv=None) -> int:
    device, rest = device_option_or_exit(
        sys.argv[1:] if argv is None else argv, "bench_opb_torch.py")
    tl = float(rest[0]) if rest else 30.0
    out = battery(tl, device)
    if device.type == "cuda":
        smi, watts = card()
        print(f"# nvidia-smi: {smi}", file=sys.stderr)
        out.update(device=torch.cuda.get_device_name(device),
                   power_limit_w=watts)
    else:
        out.update(device="cpu", power_limit_w=None)
    save_json("bench_opb_torch", out)
    print_launches()
    print(json.dumps({k: v for k, v in out.items() if k != "instances"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
