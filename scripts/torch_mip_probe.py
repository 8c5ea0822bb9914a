#!/usr/bin/env python3
"""The short card loop for the port's MIP path: ``chip_smoke.py``'s phase
9 alone, on instances and time limits of one's choice.

Run from the root of a checkout, with one card visible:

    python3 scripts/torch_mip_probe.py [--cases SCALE:NAME:LIMIT,...]
        [--default-limit SECONDS] [--no-fj] [--profile-fj]

It builds the kernels and the native core as phase 2 does, runs the device
feasibility jump at the root's call shape on phase 9's two instances (and
with ``--profile-fj`` prints ``torch.profiler``'s kernel table of one
round on edge_packing_300_s15), then ``mip.solve`` with the PDHG node
backend on each case (a battery instance of ``miplib_like_battery(SCALE)``
under a LIMIT-second time limit; its status is printed, not required) with
the kernels held against their plain versions on its node-LP matrices,
then ``mip.solve`` under the defaults on edge_packing_300_s15 unless
``--default-limit 0``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from ortools_tpu_torch.ops import _build  # noqa: E402
from ortools_tpu_torch.sat import fj_device  # noqa: E402


def profile_fj_round() -> None:
    qp = C.battery()["edge_packing_300_s15"].as_minimization()
    a2, lb2, ub2 = fj_device.objective_descent_system(
        qp.constraint_matrix, qp.constraint_lower, qp.constraint_upper,
        qp.objective_vector, -1e-6)
    a_d = np.ascontiguousarray(a2.toarray(), dtype=np.float32)
    sys_ = fj_device.make_system(a_d, lb2, ub2, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = fj_device.initial_state(sys_, C.FJ_CALL["n_seeds"], gen,
                                 np.zeros(qp.num_variables))
    steps = C.FJ_CALL["steps_per_round"]
    fj_device.run_round(sys_, st, gen, steps, 0.3)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fj_device.run_round(sys_, st, gen, steps, 0.3)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=15), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(
        f"{s}:{n}:{t}" for s, n, t in C.PDHG_MIPS))
    ap.add_argument("--default-limit", type=float,
                    default=C.DEFAULT_MIP_LIMIT)
    ap.add_argument("--no-fj", action="store_true")
    ap.add_argument("--profile-fj", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mip_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    C.environment()
    native = C.build_native()
    _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    native.join()
    C.require(native.error is None, f"native build: {native.error}")
    print(f"build and load: {time.perf_counter() - t0:.1f} s", flush=True)
    if not args.no_fj:
        bat = C.battery()
        for name in C.FJ_INSTANCES:
            C.device_fj_rounds(bat[name])
    if args.profile_fj:
        profile_fj_round()
    cases = []
    for item in filter(None, args.cases.split(",")):
        scale, name, limit = item.split(":")
        cases.append((float(scale), name, float(limit)))
    errs: dict = {}
    for scale, name, limit in cases:
        run = C.pdhg_mip(scale, name, limit)
        C.node_lp_kernels(name, run["prob"], errs)
    if args.default_limit > 0:
        C.default_mip(errs, limit=args.default_limit)
    print(f"largest errors on the node-LP matrices: {errs}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
