#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

1. Environment: the card's name and power limit, CUDA, nvcc, triton.
2. Build the CUDA kernels from ``ortools_tpu_torch/ops/csrc`` and print
   what ``-Xptxas -v`` says of each (registers, shared memory, spills).
3. Each kernel against its plain PyTorch version on the card: A (8x128)
   and its transpose (128x8) at the bench shape, (32,128) and (128,128)
   and their transposes at a smaller size, and an empty matrix; exact in
   f32 and f64, fast (bf16) in f32; each run twice, bit-identical.
4. ``pdlp.solve`` on a moderate LP to OPTIMAL, held against HiGHS.
5. The main path at full width: ``pdlp.solve`` on the bench LP
   (block_random_lp 16384 x 16384, 4096 blocks of 8x128, seed 0, f32,
   default parameters) with an iteration limit, with the launch counters
   set to 0 just before and read just after.  Then PDHG iter/s of each
   stream (the solver's own majors), host syncs per major, peak device
   memory, and each kernel's time at the bench shape beside its bound, its
   plain version and a PyTorch sparse CSR product.
6. The ``kernels`` line (JSON), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

import ortools_tpu_torch
from ortools_tpu_torch.models.generators import block_random_lp
from ortools_tpu_torch.ops import _build, tiled_spmv
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix
from ortools_tpu_torch.pdlp import PdhgParams, solve
from ortools_tpu_torch.pdlp import solver as pdlp_solver
from ortools_tpu_torch.utils.status import TerminationReason

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the tensor
# cores (the kernels multiply in f32 on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50 * 2**20

BENCH = dict(m=16384, n=16384, num_blocks=4096, block_shape=(8, 128), seed=0)
# The bench's solver parameters (bench.py:106): f32, blocks of 8x128.
BENCH_PARAMS = dict(dtype=torch.float32, block_shape=(8, 128))
MODERATE = dict(m=2048, n=2048, num_blocks=512, block_shape=(8, 128), seed=0)
BENCH_ITERATION_LIMIT = 64 * 8
TIMED_MAJORS = 6

KERNELS = {
    "block_spmv_exact": dict(
        route="cuda", source="ortools_tpu_torch/ops/csrc/block_spmv.cu",
        replaces="ortools_tpu/ops/tiled_spmv.py:262",
        wrapper=tiled_spmv.tiled_matvec, plain=tiled_spmv.tiled_matvec_plain),
    "block_spmv_fast": dict(
        route="cuda", source="ortools_tpu_torch/ops/csrc/block_spmv.cu",
        replaces="ortools_tpu/ops/tiled_spmv.py:332",
        wrapper=tiled_spmv.tiled_matvec_fast,
        plain=tiled_spmv.tiled_matvec_fast_plain),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def reset_counters() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


# ---------------------------------------------------------------------------
# 1. Environment
# ---------------------------------------------------------------------------


def environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("nvidia-smi:", smi)
    print("device:", torch.cuda.get_device_name(0),
          "count:", torch.cuda.device_count())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton  # noqa: F401
        print("triton imports:", triton.__version__)
    except ImportError as e:
        print("triton does not import:", e)
    print("float32 matmul precision:", torch.get_float32_matmul_precision(),
          "tf32 matmul:", torch.backends.cuda.matmul.allow_tf32,
          "tf32 cudnn:", torch.backends.cudnn.allow_tf32)
    require(torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# 3. Kernels against their plain versions
# ---------------------------------------------------------------------------


def _x_for(mat: BlockSparseMatrix, dtype: torch.dtype, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(mat.padded_shape[1], generator=g, dtype=torch.float64)
    return x.to(dtype=dtype, device="cuda")


def _rel_err(y, ref) -> tuple:
    err = float((y.double() - ref.double()).abs().max()) if y.numel() else 0.0
    scale = 1.0 + (float(ref.double().abs().max()) if ref.numel() else 0.0)
    return err, scale


def check_matrix(label: str, mat: BlockSparseMatrix, errs: dict) -> None:
    """Exact (f32, f64) and fast kernels against their plain versions on
    ``mat`` (a matrix without layout); records the largest errors."""
    m32 = dataclasses.replace(mat, data=mat.data.float(),
                              tiled=None).with_tiled(hi=True)
    m64 = dataclasses.replace(mat, data=mat.data.double(),
                              tiled=None).with_tiled()
    x32 = _x_for(mat, torch.float32, 1)
    x64 = _x_for(mat, torch.float64, 1)
    exact = tiled_spmv.tiled_matvec
    fast = tiled_spmv.tiled_matvec_fast

    y, y2 = exact(m32.tiled, x32), exact(m32.tiled, x32)
    ref = tiled_spmv.tiled_matvec_plain(m32.tiled, x32)
    d, d2 = exact(m64.tiled, x64), exact(m64.tiled, x64)
    ref64 = tiled_spmv.tiled_matvec_plain(m64.tiled, x64)
    f, f2 = fast(m32.tiled, x32), fast(m32.tiled, x32)
    fref = tiled_spmv.tiled_matvec_fast_plain(m32.tiled, x32)
    torch.cuda.synchronize()

    e32, s32 = _rel_err(y, ref)
    e64, s64 = _rel_err(d, ref64)
    ef, sf = _rel_err(f, fref)
    efx, sfx = _rel_err(f, ref)
    print(f"{label:34s} exact f32 {e32:.3e} (<= {1e-5 * s32:.3e})"
          f"  exact f64 {e64:.3e} (<= {1e-12 * s64:.3e})"
          f"  fast {ef:.3e} (<= {1e-5 * sf:.3e})"
          f"  fast-exact {efx:.3e} (<= {3e-2 * sfx:.3e})")
    require(e32 <= 1e-5 * s32, f"{label}: exact f32 kernel disagrees")
    require(e64 <= 1e-12 * s64, f"{label}: exact f64 kernel disagrees")
    require(ef <= 1e-5 * sf, f"{label}: fast kernel disagrees with plain")
    require(efx <= 3e-2 * sfx, f"{label}: fast kernel too far from exact")
    require(torch.equal(y, y2) and torch.equal(d, d2) and torch.equal(f, f2),
            f"{label}: a repeated launch is not bit-identical")
    nonzero = bool(ref.abs().max() > 0) if ref.numel() else False
    if nonzero:
        require(not torch.equal(f, y), f"{label}: fast equals exact")
    else:
        require(float(y.abs().max()) == 0.0 and float(f.abs().max()) == 0.0,
                f"{label}: an empty matrix gives nonzero y")
    errs["block_spmv_exact"] = max(errs.get("block_spmv_exact", 0.0), e32)
    errs["block_spmv_fast"] = max(errs.get("block_spmv_fast", 0.0), ef)


def kernels_against_plain(bench_prob) -> dict:
    errs: dict = {}
    for name, mat in (("A", bench_prob.a), ("A^T", bench_prob.at)):
        bm, bn = mat.block_shape
        check_matrix(f"bench {name} ({bm}x{bn})", mat.without_tiled(), errs)
    for block_shape, nb in (((32, 128), 128), ((128, 128), 64)):
        qp = block_random_lp(2048, 2048, nb, block_shape, seed=1)
        mat = BlockSparseMatrix.from_scipy(
            qp.constraint_matrix, block_shape=block_shape,
            dtype=torch.float64, device="cuda")
        bm, bn = block_shape
        check_matrix(f"2048^2 A ({bm}x{bn})", mat, errs)
        check_matrix(f"2048^2 A^T ({bn}x{bm})", mat.block_transpose(), errs)
    empty = BlockSparseMatrix.from_scipy(sp.csr_matrix((50, 60)),
                                         device="cuda")
    check_matrix("empty 50x60 (8x128)", empty, errs)
    check_matrix("empty^T (128x8)", empty.block_transpose(), errs)
    return errs


# ---------------------------------------------------------------------------
# 4. A moderate LP to OPTIMAL
# ---------------------------------------------------------------------------


def highs_objective(qp) -> float:
    res = linprog(qp.objective_vector, A_ub=qp.constraint_matrix,
                  b_ub=qp.constraint_upper,
                  bounds=list(zip(qp.variable_lower, qp.variable_upper)),
                  method="highs")
    require(res.status == 0, f"HiGHS failed: {res.message}")
    return float(res.fun)


def moderate_solve() -> None:
    qp = block_random_lp(**MODERATE)
    ref = highs_objective(qp)
    reset_counters()
    r = solve(qp, PdhgParams(record_iteration_stats=True))
    launches = {k: v["wrapper"].launches for k, v in KERNELS.items()}
    streams = [rec["stream"] for rec in r.iteration_stats]
    rel = abs(r.primal_objective - ref) / (1 + abs(ref))
    print(f"moderate LP {MODERATE}: {r.termination_reason.name} in "
          f"{r.iterations} iterations, {r.solve_time_sec:.3f} s; objective "
          f"{r.primal_objective!r} HiGHS {ref!r} (rel {rel:.2e});"
          f" fast majors {streams.count('fast')}, exact majors "
          f"{streams.count('exact')}; launches {launches}")
    require(r.termination_reason == TerminationReason.OPTIMAL,
            "moderate LP did not reach OPTIMAL")
    require(rel <= 1e-4, "moderate LP objective disagrees with HiGHS")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched by the moderate solve: {launches}")


# ---------------------------------------------------------------------------
# 5. Full width: the main path, stream rates, kernel times
# ---------------------------------------------------------------------------


def main_path(qp) -> dict:
    """The bench LP through ``solve`` with default parameters; the launch
    counters are zeroed just before and read just after."""
    params = PdhgParams(iteration_limit=BENCH_ITERATION_LIMIT,
                        record_iteration_stats=True, **BENCH_PARAMS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pdlp_solver.host_syncs = 0
    reset_counters()
    r = solve(qp, params)
    torch.cuda.synchronize()
    launches = {k: v["wrapper"].launches for k, v in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    streams = [rec["stream"] for rec in r.iteration_stats]
    print(f"bench LP {BENCH}: {r.termination_reason.name} after "
          f"{r.iterations} iterations in {r.solve_time_sec:.3f} s (host "
          f"set-up included); majors fast {streams.count('fast')} exact "
          f"{streams.count('exact')}; host syncs {pdlp_solver.host_syncs} "
          f"({pdlp_solver.host_syncs / max(1, len(streams)):.1f} per "
          f"major); launches {launches}; max_memory_allocated {peak} bytes")
    require(r.termination_reason == TerminationReason.ITERATION_LIMIT
            and r.iterations == BENCH_ITERATION_LIMIT,
            "bench solve did not run to its iteration limit")
    require(r.primal_solution.shape == (qp.num_variables,)
            and r.dual_solution.shape == (qp.num_constraints,),
            "bench solution has the wrong shape")
    require(bool(np.all(np.isfinite(r.primal_solution))
                 and np.all(np.isfinite(r.dual_solution))),
            "bench solution is not finite")
    require(all(np.isfinite(rec["kkt_current"]) for rec in r.iteration_stats),
            "bench KKT error is not finite")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path was not launched: {launches}")
    return launches


def stream_rates(prob) -> tuple:
    """Iter/s of the solver's own majors, fast stream then exact stream,
    from one shared start; host syncs per major and the share of the
    major's wall time the host spends blocked in them.  Returns the
    seconds per major of each stream and the state reached."""
    params = PdhgParams(**BENCH_PARAMS)
    g = torch.Generator(device="cpu").manual_seed(0)
    v0 = torch.randn(prob.c.shape[0], generator=g,
                     dtype=torch.float64).to(prob.c)
    sigma = pdlp_solver._make_power_iter(params)(prob, v0)
    state = pdlp_solver._make_initial_state(params)(prob, sigma)
    freq = params.termination_check_frequency
    run_major = {name: pdlp_solver._make_run_major(params, fast=fast)
                 for name, fast in (("fast", True), ("exact", False))}
    for name in run_major:  # warm-up
        state = run_major[name](prob, state)
    torch.cuda.synchronize()
    # Host time varies from turn to turn: the streams take turns (fast,
    # exact, exact, fast), TIMED_MAJORS majors each, and sum their turns.
    total = {name: [0.0, 0, 0.0] for name in run_major}  # s, syncs, blocked
    for name in ("fast", "exact", "exact", "fast"):
        syncs0 = pdlp_solver.host_syncs
        blocked0 = pdlp_solver.host_sync_seconds
        t0 = time.perf_counter()
        for _ in range(TIMED_MAJORS):
            state = run_major[name](prob, state)
        torch.cuda.synchronize()
        t = total[name]
        t[0] += time.perf_counter() - t0
        t[1] += pdlp_solver.host_syncs - syncs0
        t[2] += pdlp_solver.host_sync_seconds - blocked0
        require(bool(torch.isfinite(state.x).all()),
                f"{name} stream majors gave a non-finite iterate")
    major_s = {}
    for name, (dt, syncs, blocked) in total.items():
        majors = 2 * TIMED_MAJORS
        print(f"{name} stream: {majors * freq / dt:.1f} PDHG iter/s "
              f"({dt / majors * 1e3:.3f} ms per {freq}-step major); "
              f"host syncs per major {syncs / majors:.1f}, host blocked in "
              f"them {blocked / dt:.1%} of the major's wall time")
        major_s[name] = dt / majors
    return major_s, state


def device_profile(prob, state, major_s: dict) -> None:
    """One major of each stream under torch.profiler: device time by
    kernel, device kernels per iteration, and the device's busy share of
    an unprofiled major (``major_s``, from ``stream_rates``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = PdhgParams(**BENCH_PARAMS)
    freq = params.termination_check_frequency
    for name, fast in (("fast", True), ("exact", False)):
        run_major = pdlp_solver._make_run_major(params, fast=fast)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = run_major(prob, state)
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        if not by_name:
            print(f"{name} stream: the profiler saw no device time")
            continue
        busy_us = sum(t for t, _ in by_name.values())
        kernels = sum(n for _, n in by_name.values())
        print(f"{name} stream, one profiled major: {kernels / freq:.1f} "
              f"device kernels per iteration; device busy "
              f"{busy_us / 1e3:.3f} ms, {busy_us / 1e6 / major_s[name]:.1%}"
              f" of an unprofiled major ({major_s[name] * 1e3:.3f} ms)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        for kname, (t, n) in top:
            print(f"    {t / 1e3:9.3f} ms {n:6d}x  {kname[:100]}")


def time_launches(fn, args_list, reps: int) -> float:
    """Mean ms per launch over ``reps`` launches cycling through
    ``args_list`` (copies whose bytes together exceed the L2 cache).  A
    sleep kernel runs first so the host enqueues every launch before the
    first one starts: the events then time the device, not Python."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _csr_copies(mat: BlockSparseMatrix, copies: int) -> list:
    """The matrix as torch sparse CSR tensors on the card, every stored
    entry kept (the library yardstick; the port never calls it)."""
    bm, bn = mat.block_shape
    lay = mat.tiled
    br = lay.block_rows.cpu().numpy().astype(np.int64)
    bc = lay.block_cols.cpu().numpy().astype(np.int64)
    rows = (br[:, None, None] * bm + np.arange(bm)[None, :, None]
            + np.zeros(bn, np.int64)[None, None, :]).ravel()
    cols = (bc[:, None, None] * bn + np.zeros(bm, np.int64)[None, :, None]
            + np.arange(bn)[None, None, :]).ravel()
    vals = lay.data.float().cpu().numpy().ravel()
    order = np.lexsort((cols, rows))
    indptr = np.zeros(mat.padded_shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=mat.padded_shape[0]),
              out=indptr[1:])
    crow = torch.as_tensor(indptr, dtype=torch.int32, device="cuda")
    col = torch.as_tensor(cols[order], dtype=torch.int32, device="cuda")
    val = torch.as_tensor(vals[order], dtype=torch.float32, device="cuda")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")
        return [torch.sparse_csr_tensor(crow.clone(), col.clone(),
                                        val.clone(), size=mat.padded_shape,
                                        check_invariants=True)
                for _ in range(copies)]


def kernel_bound_ms(mat: BlockSparseMatrix, value_bytes: int) -> tuple:
    """Least time for one product: each input read once, y written once,
    over the card's memory rate, against 2 flops per stored entry over the
    f32 rate; returns (ms, "bytes" | "operations", bytes)."""
    lay = mat.tiled
    nb = mat.num_blocks
    bm, bn = mat.block_shape
    m, n = mat.padded_shape
    nbytes = (nb * bm * bn * value_bytes + n * 4 + m * 4
              + (lay.num_block_rows + 1) * 4 + nb * 4)
    flops = 2 * nb * bm * bn
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes
    return t_ops * 1e3, "operations", nbytes


def kernel_times(prob) -> dict:
    """Each kernel at the bench shape, A and A^T: its time, its plain
    version's time, the CSR library product's time, and its bound."""
    out = {}
    for orient, mat in (("A", prob.a), ("A^T", prob.at)):
        lay = mat.tiled
        # enough copies that even the bf16 blocks cycled over exceed L2 twice
        copies = 1 + (2 * L2_BYTES) // lay.data_hi.nbytes
        lays32 = [lay._replace(data=lay.data.clone(),
                               data_hi=lay.data_hi.clone())
                  for _ in range(copies)]
        x = _x_for(mat, torch.float32, 2)
        csrs = _csr_copies(mat, copies)
        for name, spec in KERNELS.items():
            fast = name == "block_spmv_fast"
            args = [(t, x) for t in lays32]
            ms = time_launches(spec["wrapper"], args, 400)
            plain_ms = time_launches(spec["plain"], args, 100)
            if fast:
                # No PyTorch call multiplies bf16 blocks by a bf16-rounded
                # x into an f32 result.
                library_ms = None
            else:
                library_ms = time_launches(lambda a, v: a @ v,
                                           [(c, x) for c in csrs], 200)
            bound_ms, bound_by, nbytes = kernel_bound_ms(
                mat, 2 if fast else 4)
            lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"{name:17s} {orient:3s} {mat.block_shape}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (CSR) "
                  f"{lib}, bound {bound_ms:.4f} ms ({nbytes} bytes, "
                  f"{bound_by}); kernel at {bound_ms / ms:.1%} of bound")
            out[(name, orient)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=library_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
        del lays32, csrs
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    package_root = Path(ortools_tpu_torch.__file__).resolve().parents[1]
    if package_root != ROOT:
        print(f"chip_smoke: ortools_tpu_torch comes from {package_root}, "
              f"not from this checkout ({ROOT})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    phase("1. environment")
    smi_line = environment()

    phase("2. build the kernels (nvcc -Xptxas -v)")
    t0 = time.perf_counter()
    report = _build.build()
    _build.library()
    print(report.strip())
    print(f"build and load: {time.perf_counter() - t0:.1f} s")

    phase("3. kernels against their plain versions on the card")
    bench_qp = block_random_lp(**BENCH)
    bench_params = PdhgParams(**BENCH_PARAMS)
    bench_prob = pdlp_solver.build_device_problem(bench_qp, bench_params,
                                                  "cuda")
    errs = kernels_against_plain(bench_prob)
    # freed so that the main path's peak memory is its own
    del bench_prob
    torch.cuda.empty_cache()

    phase("4. moderate LP to OPTIMAL against HiGHS")
    moderate_solve()

    phase("5. full width: the bench LP through pdlp.solve")
    launches = main_path(bench_qp)
    bench_prob = pdlp_solver.build_device_problem(bench_qp, bench_params,
                                                  "cuda")
    major_s, state = stream_rates(bench_prob)
    device_profile(bench_prob, state, major_s)
    times = kernel_times(bench_prob)

    phase("6. kernels")
    kernels = []
    for name, spec in KERNELS.items():
        a, at = times[(name, "A")], times[(name, "A^T")]
        kernels.append(dict(
            name=name, route=spec["route"], source=spec["source"],
            replaces=spec["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=a["ms"], plain_ms=a["plain_ms"],
            bound_ms=a["bound_ms"], bound_by=a["bound_by"],
            library_ms=a["library_ms"], transpose=at, ok=True))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
