#!/usr/bin/env python3
"""SAT inprocessing battery: the conflict counts of the CDCL core with
restart-time vivification and deferred on-the-fly subsumption on and off,
with the DRAT proofs of the UNSAT runs checked (port of
``scripts/bench_inprocessing.py``, on the port's copies of ``sat/cdcl.py``
and ``sat/drat.py``; the native core ``_native/cdcl.cc`` is a byte copy).

Host code: it reaches no kernel and takes no device.  Prints a ``# <name>:
...`` line per instance and ``# launches: {...}`` (none) on stderr, then
one JSON line with the JAX script's keys (without ``instances``, as it
prints them) plus ``device`` ("cpu") and ``power_limit_w`` (null); the
whole object goes to ``build/bench/bench_inprocessing_torch.json``.

    python3 scripts/bench_inprocessing_torch.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import print_launches, save_json  # noqa: E402
from ortools_tpu_torch.sat.cdcl import CdclSolver  # noqa: E402
from ortools_tpu_torch.sat.drat import check_drat  # noqa: E402


def php(holes):
    p, h = holes + 1, holes

    def v(i, j):
        return i * h + j + 1

    cls = [[v(i, j) for j in range(h)] for i in range(p)]
    for j in range(h):
        for i1 in range(p):
            for i2 in range(i1 + 1, p):
                cls.append([-v(i1, j), -v(i2, j)])
    return p * h, cls


def rand3sat(nv, ratio, seed):
    rng = np.random.default_rng(seed)
    cls = []
    for _ in range(int(nv * ratio)):
        vs = rng.choice(nv, size=3, replace=False) + 1
        cls.append(list((vs * rng.choice([-1, 1], 3)).astype(int)))
    return nv, cls


def instances() -> list:
    """A structured family (clause quality matters consistently) and a wide
    random sample (one near-threshold 3-SAT run is trajectory noise)."""
    out = [("php6", *php(6)), ("php7", *php(7)), ("php8", *php(8))]
    for k in range(10):
        out.append((f"r3s_160_{k}", *rand3sat(160, 4.26, 10 + k)))
    return out


def run_instance(name: str, nv: int, cls: list) -> dict:
    """One instance with inprocessing on (and its proof checked where it
    is UNSAT) and off."""
    row = {"name": name, "n_vars": nv, "n_clauses": len(cls)}
    for on in (True, False):
        s = CdclSolver(nv, proof=on)
        s.set_inprocessing(on)
        for c in cls:
            s.add_clause(c)
        t0 = time.perf_counter()
        r = s.solve(conflict_budget=1_000_000)
        key = "on" if on else "off"
        row[key] = {"verdict": int(r),
                    "conflicts": s.num_conflicts,
                    "sec": round(time.perf_counter() - t0, 2)}
        if on:
            row["vivified"] = s.num_vivified
            row["otf_subsumed"] = s.num_otf_subsumed
            if r == 0:  # UNSAT: check the proof
                row["drat_checked"] = bool(check_drat(cls, list(s.proof())))
    if row["on"]["verdict"] != row["off"]["verdict"]:
        raise RuntimeError(f"{name}: the verdicts differ")
    return row


def summary(rows: list) -> dict:
    """The JAX script's JSON object from the instances' rows."""
    proofs = [r["drat_checked"] for r in rows if "drat_checked" in r]
    return {
        "metric": "sat_inprocessing",
        "instances": rows,
        "proofs_checked": f"{sum(proofs)}/{len(proofs)}",
        "total_conflicts_on": sum(r["on"]["conflicts"] for r in rows),
        "total_conflicts_off": sum(r["off"]["conflicts"] for r in rows),
        "php_conflicts_on": sum(r["on"]["conflicts"] for r in rows
                                if r["name"].startswith("php")),
        "php_conflicts_off": sum(r["off"]["conflicts"] for r in rows
                                 if r["name"].startswith("php")),
        "median_ratio_on_over_off": sorted(
            (r["on"]["conflicts"] + 1) / (r["off"]["conflicts"] + 1)
            for r in rows)[len(rows) // 2],
    }


def main() -> int:
    rows = []
    for name, nv, cls in instances():
        row = run_instance(name, nv, cls)
        rows.append(row)
        print(f"# {name}: on={row['on']['conflicts']} "
              f"off={row['off']['conflicts']} "
              f"viv={row.get('vivified')} otf={row.get('otf_subsumed')} "
              f"drat={row.get('drat_checked', 'n/a')}", file=sys.stderr)
    out = dict(summary(rows), device="cpu", power_limit_w=None)
    save_json("bench_inprocessing_torch", out)
    print_launches()
    print(json.dumps({k: v for k, v in out.items() if k != "instances"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
