#!/usr/bin/env python3
"""HBM streaming roofline on one CUDA card (port of
``scripts/bench_roofline.py``).

The step is the JAX script's: y ← x·(1 + 1e-9·i) + y over two f32 arrays
of 2²⁶ elements (12 bytes an element a step: read x, read y, write y).
Both arrays together are 512 MiB, about ten times the H100's 50 MiB L2,
so every step streams from HBM.  On the card a step is one kernel,
``y.add_(x, alpha=1 + 1e-9·i)``.

For each N in (1, 16, 64, 256), N steps are captured in one CUDA graph
(the counterpart of one jitted ``fori_loop``) and the graph is replayed:
one warm-up, then the best of 5 replays, each timed by CUDA events, with
y reset from y0 before each (outside the events).  The least-squares fit
time(N) = fixed + N·per_iter over N >= 16 is the JAX script's; its slope
gives the in-graph bandwidth alone.

Prints ``# nvidia-smi: ...``, ``# peak device memory: ...`` and ``#
launches: {...}`` on stderr, then one
JSON line with the JAX script's keys, ``v5e_paper_peak_gb_per_s`` renamed
``h100_peak_gb_per_s`` (3,350: the H100 SXM data sheet's HBM3 rate),
``devices`` the card's name, plus ``device`` and ``power_limit_w``; the
same JSON goes to ``build/bench/bench_roofline_torch.json``.  Runs on the
card only; without one it exits 2.

    python3 scripts/bench_roofline_torch.py
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import (card, print_launches,  # noqa: E402
                         print_peak_memory, save_json)
from ortools_tpu_torch.utils.device import resolve_device_or_exit  # noqa: E402

N_ELEMS = 1 << 26
ITERS = (1, 16, 64, 256)
REPS = 5
H100_PEAK_GB_PER_S = 3350  # H100 SXM data sheet, HBM3


def step(x: torch.Tensor, y: torch.Tensor, i: int) -> None:
    """Step ``i`` in place: y ← x·(1 + 1e-9·i) + y, one kernel."""
    y.add_(x, alpha=1.0 + 1e-9 * i)


def steps(x: torch.Tensor, y: torch.Tensor, n_iters: int) -> None:
    for i in range(n_iters):
        step(x, y, i)


def best_sec(x: torch.Tensor, y0: torch.Tensor, y: torch.Tensor,
             n_iters: int, reps: int = REPS) -> float:
    """N steps captured in one CUDA graph (on the card; run eagerly
    elsewhere): one warm-up, then the best of ``reps`` runs, y reset from
    ``y0`` before each.  CUDA events on the card, the host clock
    elsewhere."""
    cuda = x.device.type == "cuda"
    if cuda:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            step(x, y, 0)  # the eager warm-up a capture needs
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            steps(x, y, n_iters)
        run = graph.replay
    else:
        def run():
            steps(x, y, n_iters)
    y.copy_(y0)
    run()
    best = math.inf
    for _ in range(reps):
        y.copy_(y0)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best


def fit(results: list) -> tuple:
    """Least-squares time = fixed + per_iter·N over the samples after the
    first (bench_roofline.py's fit): (fixed, per_iter) in seconds."""
    ns = np.array([n for n, _ in results[1:]], dtype=np.float64)
    ts = np.array([t for _, t in results[1:]], dtype=np.float64)
    a = np.stack([np.ones_like(ns), ns], axis=1)
    (fixed, per_iter), *_ = np.linalg.lstsq(a, ts, rcond=None)
    return float(fixed), float(per_iter)


def record(results: list, n_elems: int, devices: list, device_name: str,
           power_limit_w) -> dict:
    """The JSON object: bench_roofline.py's keys and rounding, the peak
    key renamed for the H100, the card's name and power limit."""
    bytes_per_iter = 3 * 4 * n_elems
    fixed, per_iter = fit(results)
    in_dispatch_gbs = bytes_per_iter / per_iter / 1e9
    n1, t1 = results[0]
    single_gbs = bytes_per_iter * n1 / t1 / 1e9
    return {
        "metric": "hbm_stream_roofline",
        "array_mib": n_elems * 4 / 2**20,
        "bytes_per_iteration": bytes_per_iter,
        "samples": [{"iters": n, "best_sec": round(t, 5)}
                    for n, t in results],
        "fixed_overhead_ms": round(fixed * 1e3, 2),
        "per_iteration_us": round(per_iter * 1e6, 2),
        "in_dispatch_gb_per_s": round(in_dispatch_gbs, 1),
        "single_dispatch_gb_per_s": round(single_gbs, 1),
        "h100_peak_gb_per_s": H100_PEAK_GB_PER_S,
        "fraction_of_paper_peak": round(in_dispatch_gbs
                                        / H100_PEAK_GB_PER_S, 3),
        "devices": devices,
        "device": device_name,
        "power_limit_w": power_limit_w,
    }


def run(device, n_elems: int = N_ELEMS, iters=ITERS) -> list:
    """(N, best seconds) for each N, on arrays of ``n_elems``."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n_elems, dtype=np.float32),
                        device=device)
    y0 = torch.as_tensor(rng.standard_normal(n_elems, dtype=np.float32),
                         device=device)
    y = torch.empty_like(y0)
    results = []
    for n_iters in iters:
        best = best_sec(x, y0, y, n_iters)
        results.append((n_iters, best))
        print(f"N={n_iters:5d}: best {best * 1e3:9.3f} ms", file=sys.stderr)
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError("the streamed array is not finite")
    return results


def main() -> int:
    device = resolve_device_or_exit("cuda", "bench_roofline_torch.py")
    smi, watts = card()
    print(f"# nvidia-smi: {smi}", file=sys.stderr, flush=True)
    results = run(device, N_ELEMS)
    name = torch.cuda.get_device_name(device)
    out = record(results, N_ELEMS,
                 [torch.cuda.get_device_name(i)
                  for i in range(torch.cuda.device_count())], name, watts)
    save_json("bench_roofline_torch", out)
    print_peak_memory(device)
    print_launches()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
