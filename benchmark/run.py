#!/usr/bin/env python3
"""The benchmark of ``ortools_tpu_torch`` on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: makes the
cell's instances from ``--seed``, warms up, measures for ``--seconds``,
judges every answer with the plain reference, and prints one JSON line
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` the per-layer metrics and ``breakdown``), the judged numbers
last, beside their limits, in it and on standard error.  Exits 2 without
a result where the card the cell asks for is missing, and 3 where the run
loaded JAX or the JAX package.  Kernel and compiler caches stay under
``build/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - started / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc libraries go to build/kernels and build/native
    by themselves)."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def _few_threads() -> None:
    """One process with few threads: the host's thread pools at one thread
    unless the environment sets them (the program's host work is scipy and
    Python, which use one)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    _few_threads()
    sys.path[:0] = [str(BENCH), str(ROOT)]

    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload)
    if chips is None:
        print(f"run.py: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    import ortools_tpu_torch

    if ROOT not in Path(ortools_tpu_torch.__file__).resolve().parents:
        print(f"run.py: ortools_tpu_torch comes from {ortools_tpu_torch.__file__},"
              f" not from this checkout", file=sys.stderr)
        return 2
    from lpbench.device import power_limit_w
    from lpbench.runner import run_cell

    limit = power_limit_w()
    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda"), T_PROCESS)
    result["device"]["power_limit"] = limit
    return emit(result, lines)


def emit(result: dict, lines: list) -> int:
    """Print the result, unless the process has loaded JAX or the JAX
    package by now: the last step before the result, after the program,
    the judgement and every reader have run."""
    from lpbench.device import loaded_forbidden

    found = loaded_forbidden()
    if found:
        print("run.py: the run loaded " + ", ".join(found), file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
