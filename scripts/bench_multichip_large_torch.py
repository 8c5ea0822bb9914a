#!/usr/bin/env python3
"""The 1.04M-nonzero LP on one CUDA card and on a 2x4 row x col mesh
(port of ``scripts/bench_multichip_large.py``).

``multicommodity_flow_lp(200, 2700, 128, seed=3)``: 28,300 rows, 345,600
columns, 1,036,800 nonzeros, in f64 at eps 1e-7 (absolute and relative)
with an iteration limit of 400,000:

1. **The census** of the 2-D partition: the blocks of each of the 2x4
   cells, computed as the JAX script computes it, through the port's
   ``build_device_problem`` (on the host) with the padded lengths rounded
   to whole blocks per range.  It depends only on the sparsity pattern
   and the padding, so it must equal the JAX package's.  Its seconds
   (Ruiz, L2 scaling and the block packing on the host) are printed apart
   from the solves.
2. **The single solve**: ``pdlp.solve`` on the card, with its peak device
   memory.
3. **The mesh solve**: the same solve on a ``--mesh`` (default 2x4) row x
   col mesh of ranks started by ``graft_entry.start_ranks``, each running
   ``pdlp.solve(qp, params, mesh=make_mesh(shape, ("row", "col")))``.
   With a card for each rank they use NCCL; with fewer cards they share
   them over gloo.  The census stays at 2x4 whatever ``--mesh`` says.

Both solves must end OPTIMAL with objectives within 1e-6 relative, as the
JAX script asserts; their iteration counts are printed, not required
equal (the 2-D path's order of summation differs).  A failed check exits
1 with no JSON.

Prints ``# nvidia-smi: ...``, ``# census: ...``, ``# single solve: ...``,
``# mesh solve: ...``, ``# peak device memory: ...`` and ``# launches:
{...}`` (this process's: the mesh ranks count their own) on stderr, then one JSON line with the JAX
script's keys, ``mesh`` naming what ran, plus ``device`` and
``power_limit_w``; the same JSON goes to
``build/bench/bench_multichip_large_torch.json``.  Runs on the card only;
without one it exits 2.

    python3 scripts/bench_multichip_large_torch.py [--mesh RxC]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import (BenchFailure, card, print_launches,  # noqa: E402
                         print_peak_memory, require, save_json)
from ortools_tpu_torch import graft_entry  # noqa: E402
from ortools_tpu_torch.models.generators import multicommodity_flow_lp  # noqa: E402
from ortools_tpu_torch.ops.block_sparse import auto_block_shape  # noqa: E402
from ortools_tpu_torch.parallel import make_mesh  # noqa: E402
from ortools_tpu_torch.pdlp import PdhgParams, solve  # noqa: E402
from ortools_tpu_torch.pdlp import solver as S  # noqa: E402
from ortools_tpu_torch.utils.device import resolve_device_or_exit  # noqa: E402

INSTANCE = dict(num_nodes=200, num_arcs=2700, num_commodities=128, seed=3)
CENSUS_SHAPE = (2, 4)
MESH_TIMEOUT = 600.0  # the ranks' process-group timeout (start_ranks')


def params() -> PdhgParams:
    # 1e-7: both solves end within 1e-7 of the optimum, so their
    # objectives agree to the asserted 1e-6 with margin
    return PdhgParams(dtype=torch.float64, eps_optimal_absolute=1e-7,
                      eps_optimal_relative=1e-7, iteration_limit=400_000)


def census(qp, prm: PdhgParams, shape=CENSUS_SHAPE) -> tuple:
    """The blocks of each cell of the 2-D partition over ``shape``, as
    bench_multichip_large.py:73-91 computes them: ((bm, bn), the counts in
    row-major cell order, the host seconds of ``build_device_problem``)."""
    nr, nc = shape
    qpm = qp.as_minimization()
    bm, bn = prm.block_shape or auto_block_shape(
        qpm.num_constraints, qpm.num_variables, qpm.num_nonzeros)
    t0 = time.perf_counter()
    base = S.build_device_problem(
        qpm, prm, "cpu",
        row_pad_multiple=nr * bm * (128 // math.gcd(128, bm)),
        col_pad_multiple=nc * bn * (128 // math.gcd(128, bn)))
    seconds = time.perf_counter() - t0
    mm, nn = base.a.padded_shape
    rows_per_seg = (mm // nr) // bm
    cols_per_seg = (nn // nc) // bn
    brow = base.a.block_rows[: base.a.num_real_blocks].numpy()
    bcol = base.a.block_cols[: base.a.num_real_blocks].numpy()
    cell = (brow // rows_per_seg) * nc + (bcol // cols_per_seg)
    counts = np.bincount(cell, minlength=nr * nc).tolist()
    return (int(bm), int(bn)), counts, seconds


def mesh_rank(instance: dict, shape: tuple, device: str) -> dict:
    """One rank of the mesh solve: the instance made from its seed, the
    mesh over the default group's backend, the solve."""
    qp = multicommodity_flow_lp(**instance)
    mesh = make_mesh(shape, ("row", "col"), device=device,
                     backend=dist.get_backend())
    t0 = time.perf_counter()
    r = solve(qp, params(), device=device, mesh=mesh)
    return dict(status=r.termination_reason.name,
                iterations=int(r.iterations),
                objective=float(r.primal_objective),
                sec=time.perf_counter() - t0)


def mesh_backend(device: torch.device, ranks: int) -> str:
    """NCCL with a card for each rank, gloo where the ranks share cards
    or run on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks:
        return "nccl"
    return "gloo"


def mesh_solve(shape: tuple, device: torch.device,
               instance: dict = INSTANCE) -> tuple:
    """The mesh solve on ``prod(shape)`` ranks: (rank 0's result, every
    rank's, the seconds from the start of the ranks to their end, the
    backend)."""
    n = math.prod(shape)
    backend = mesh_backend(device, n)
    t0 = time.perf_counter()
    job = graft_entry.start_ranks(n, mesh_rank, (instance, shape,
                                                 device.type),
                                  device=device.type, backend=backend,
                                  timeout=MESH_TIMEOUT)
    try:
        ranks = job.join()
    finally:
        job.kill()
    return ranks[0], ranks, time.perf_counter() - t0, backend


def run(device, mesh_shape=CENSUS_SHAPE, instance: dict = INSTANCE) -> tuple:
    """Census, single solve and mesh solve on ``device``, checked: (the
    JSON object without the card's keys, the mesh's backend)."""
    device = torch.device(device)
    qp = multicommodity_flow_lp(**instance)
    nnz = qp.num_nonzeros
    print(f"# instance: {qp.name} m={qp.num_constraints} "
          f"n={qp.num_variables} nnz={nnz}", file=sys.stderr, flush=True)
    prm = params()

    (bm, bn), counts, setup_s = census(qp, prm)
    print(f"# census: {counts} at blocks of {bm}x{bn}; host set-up (Ruiz, "
          f"L2 scaling, block packing) {setup_s:.2f} s", file=sys.stderr,
          flush=True)

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    r1 = solve(qp, prm, device=device)
    t_single = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    print(f"# single solve: {r1.termination_reason.name} "
          f"iters={r1.iterations} obj={r1.primal_objective!r} "
          f"{t_single:.1f} s; peak device memory {peak} bytes",
          file=sys.stderr, flush=True)
    require(r1.termination_reason.name == "OPTIMAL",
            f"the single solve ended {r1.termination_reason.name}")

    r2, ranks, t_mesh, backend = mesh_solve(tuple(mesh_shape), device,
                                            instance)
    label = "x".join(map(str, mesh_shape))
    print(f"# mesh solve: {label} on {len(ranks)} {backend} ranks: "
          f"{r2['status']} iters={r2['iterations']} "
          f"obj={r2['objective']!r} {r2['sec']:.1f} s in rank 0, "
          f"{t_mesh:.1f} s from the ranks' start", file=sys.stderr,
          flush=True)
    require(r2["status"] == "OPTIMAL",
            f"the mesh solve ended {r2['status']}")
    require(all((k["status"], k["iterations"], k["objective"])
                == (r2["status"], r2["iterations"], r2["objective"])
                for k in ranks[1:]), "the mesh's ranks disagree")
    rel = abs(r2["objective"] - r1.primal_objective) / (
        1 + abs(r1.primal_objective))
    require(rel <= 1e-6, f"the objectives differ by {rel:.3e} relative")

    out = {
        "metric": "multichip_large_2d",
        "instance": qp.name,
        "m": int(qp.num_constraints),
        "n": int(qp.num_variables),
        "nnz": int(nnz),
        "block_shape": [bm, bn],
        "blocks_per_cell": counts,
        "cell_padding_ratio": round(max(counts) * len(counts)
                                    / max(sum(counts), 1), 3),
        "single_device": {
            "status": r1.termination_reason.name,
            "iterations": int(r1.iterations),
            "objective": float(r1.primal_objective),
            "sec": round(t_single, 1),
        },
        "mesh_2d": {
            "status": r2["status"],
            "iterations": r2["iterations"],
            "objective": r2["objective"],
            "sec": round(t_mesh, 1),
        },
        "objective_rel_diff": float(rel),
    }
    return out, backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_multichip_large_torch.py")
    ap.add_argument("--mesh", default="2x4",
                    help="the mesh solve's rows x cols (default 2x4)")
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.mesh.lower().split("x"))
    device = resolve_device_or_exit("cuda", "bench_multichip_large_torch.py")
    smi, watts = card()
    print(f"# nvidia-smi: {smi}", file=sys.stderr, flush=True)
    try:
        out, backend = run(device, shape, INSTANCE)
    except BenchFailure as e:
        print(f"bench_multichip_large_torch.py: {e}", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(device)
    cards = min(torch.cuda.device_count(), math.prod(shape))
    out = dict(out, mesh=f"{args.mesh} {backend} ranks on {cards} {name}",
               device=name, power_limit_w=watts)
    # the JAX script's key order: mesh after nnz
    keys = ["metric", "instance", "m", "n", "nnz", "mesh"]
    out = {**{k: out[k] for k in keys},
           **{k: v for k, v in out.items() if k not in keys}}
    save_json("bench_multichip_large_torch", out)
    print_peak_memory(device)
    print_launches()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
