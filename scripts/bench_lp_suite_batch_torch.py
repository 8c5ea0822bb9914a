#!/usr/bin/env python3
"""LP suite as ONE block-diagonal LP on one CUDA card (port of
``scripts/bench_lp_suite_batch.py``).

The 12 LPs of the JAX script (four ``random_lp``, four ``block_random_lp``,
four ``multicommodity_flow_lp``; the port's copies of the generators) are
stacked with ``scipy.sparse.block_diag`` into one LP and solved by
``pdlp.solve`` on the card in f32 at eps 1e-5 (absolute and relative) with
an iteration limit of 300,000.  Each block's x is then verified against
HiGHS on the host exactly as the JAX script does.

Two of the blocks, ``multicommodity_flow_lp(24, 90, 4, seed=21)`` and
``seed=22``, are infeasible (HiGHS status 2), so the stack is infeasible
and the solve ends ``PRIMAL_INFEASIBLE`` in both packages; the script is
copied as it is.

Prints a ``# <block>: ...`` line per block, ``# nvidia-smi: ...``, ``#
peak device memory: ...`` and ``# launches: {...}`` on stderr, then one JSON line with the JAX script's
keys (without ``instances``, as it prints them), ``devices`` the card's
name, plus ``device`` and ``power_limit_w``; the whole object, with
``instances``, goes to ``build/bench/bench_lp_suite_batch_torch.json``.
Runs on the card only; without one it exits 2.

    python3 scripts/bench_lp_suite_batch_torch.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import (card, print_launches,  # noqa: E402
                         print_peak_memory, save_json)
from ortools_tpu_torch.models.generators import (  # noqa: E402
    block_random_lp, multicommodity_flow_lp)
from ortools_tpu_torch.models.lp import QuadraticProgram, random_lp  # noqa: E402
from ortools_tpu_torch.pdlp import PdhgParams, solve  # noqa: E402
from ortools_tpu_torch.utils.device import resolve_device_or_exit  # noqa: E402


def build_suite() -> list:
    """The JAX script's 12 LPs, in its order."""
    suite = []
    for seed in range(4):
        suite.append(random_lp(120, 160, density=0.15, seed=seed))
    for seed in range(4):
        suite.append(block_random_lp(256, 256, num_blocks=48,
                                     block_shape=(8, 128),
                                     seed=10 + seed))
    for seed in range(4):
        suite.append(multicommodity_flow_lp(24, 90, 4, seed=20 + seed))
    return suite


def stack(suite: list) -> QuadraticProgram:
    """The blocks (each as a minimization) on one block-diagonal matrix."""
    return QuadraticProgram(
        objective_vector=np.concatenate(
            [qp.objective_vector for qp in suite]),
        constraint_matrix=sp.block_diag(
            [qp.constraint_matrix for qp in suite], format="csr"),
        constraint_lower=np.concatenate(
            [qp.constraint_lower for qp in suite]),
        constraint_upper=np.concatenate(
            [qp.constraint_upper for qp in suite]),
        variable_lower=np.concatenate(
            [qp.variable_lower for qp in suite]),
        variable_upper=np.concatenate(
            [qp.variable_upper for qp in suite]),
        name="suite_blockdiag",
    )


def params() -> PdhgParams:
    return PdhgParams(dtype=torch.float32, eps_optimal_absolute=1e-5,
                      eps_optimal_relative=1e-5, iteration_limit=300_000)


def verify(suite: list, x: np.ndarray) -> tuple:
    """Each block's part of ``x`` against HiGHS, as the JAX script checks
    it: (the number of blocks within 1e-3·(1+|HiGHS|), the rows)."""
    names = [qp.name or f"lp{i}" for i, qp in enumerate(suite)]
    rows_ok = 0
    offsets_v = np.cumsum([0] + [qp.num_variables for qp in suite])
    per = []
    for k, qp in enumerate(suite):
        xk = x[offsets_v[k]:offsets_v[k + 1]]
        a = sp.csr_matrix(qp.constraint_matrix)
        res = linprog(
            qp.objective_vector,
            A_ub=sp.vstack([a, -a]).toarray(),
            b_ub=np.concatenate([
                np.where(np.isfinite(qp.constraint_upper),
                         qp.constraint_upper, 1e12),
                np.where(np.isfinite(qp.constraint_lower),
                         -qp.constraint_lower, 1e12)]),
            bounds=list(zip(qp.variable_lower, qp.variable_upper)),
            method="highs")
        ours = float(qp.objective_vector @ xk)
        ok = res.status == 0 and abs(ours - res.fun) <= 1e-3 * (
            1 + abs(res.fun))
        rows_ok += ok
        per.append({"name": names[k], "ours": round(ours, 6),
                    "highs": round(float(res.fun), 6)
                    if res.status == 0 else None,
                    "ok": bool(ok)})
        print(f"# {names[k]}: ours={ours:.6f} "
              f"highs={res.fun if res.status == 0 else None} ok={ok} "
              f"(HiGHS status {res.status})", file=sys.stderr)
    return rows_ok, per


def run(device) -> dict:
    """The stacked solve on ``device`` and the check: the JSON object
    without the card's keys."""
    suite = [qp.as_minimization() for qp in build_suite()]
    qp_all = stack(suite)
    t0 = time.perf_counter()
    r = solve(qp_all, params(), device=device)
    batch_sec = time.perf_counter() - t0
    rows_ok, per = verify(suite, np.asarray(r.primal_solution))
    out = {
        "metric": "lp_suite_blockdiag_batch",
        "n_instances": len(suite),
        "stacked_shape": [int(qp_all.num_constraints),
                          int(qp_all.num_variables)],
        "stacked_nnz": int(qp_all.num_nonzeros),
        "status": r.termination_reason.name,
        "iterations": int(r.iterations),
        "batch_solve_sec": round(batch_sec, 2),
        "verified_ok": f"{rows_ok}/{len(suite)}",
        "instances": per,
    }
    return out


def main() -> int:
    device = resolve_device_or_exit("cuda", "bench_lp_suite_batch_torch.py")
    smi, watts = card()
    print(f"# nvidia-smi: {smi}", file=sys.stderr, flush=True)
    out = run(device)
    out = {"metric": out.pop("metric"),
           "devices": [torch.cuda.get_device_name(i)
                       for i in range(torch.cuda.device_count())],
           **out, "device": torch.cuda.get_device_name(device),
           "power_limit_w": watts}
    save_json("bench_lp_suite_batch_torch", out)
    print_peak_memory(device)
    print_launches()
    print(json.dumps({k: v for k, v in out.items() if k != "instances"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
