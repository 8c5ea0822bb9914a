"""Benchmark: PDHG iterations/s on one CUDA card (port of ``bench.py``).

North-star metric (BASELINE.md): PDHG iterations/s/chip, on the same LP
as ``bench.py``: ``block_random_lp(16384, 16384, 4096, (8, 128), seed=0)``,
f32, blocks of 8x128, σ = sqrt(‖|A|‖∞·‖|A|‖₁) from the host.  The baseline
is the same PDHG iteration over scipy CSR on the host CPU; ``vs_baseline``
divides by a PINNED constant so the ratio cannot swing with host load, and
the live measurement is reported beside it.

What is timed, as ``bench.py`` times it:

- **The headline, exact stream.** 128 replays, back to back, of the
  solver's captured ``main`` graph (``pdlp/solver.py::_Majors._run``: 64
  attempt slots, with no statistics graph, no tail slots and no host
  read), then one ``torch.cuda.synchronize()``; host clock around the
  block, best of 3, after one block that captures the graphs.  A major of
  the JAX package loops until 64 steps are accepted; a port main graph
  makes 64 *attempts*.  So the rate counts the state's Δ``num_accepted``,
  read after each block, and the attempts (Δ``num_steps``) go beside it as
  ``attempts_per_iteration``.
- **The fast stream** the same way, from a fresh initial state, with the
  bf16 SpMV.
- **``spmv``.** y ← A·y / σ chained 512 times in one CUDA graph, once with
  the exact kernel and once with the fast one; CUDA events around a
  replay, best of 3, divided by 512.  A (16.9 MB) stays in the card's 50 MB
  L2 across the chain, so these are L2-warm times.  ``exact_gbps`` counts
  the f32 values array, ``fast_gbps`` the bf16 one.  ``dispatch_fixed_ms``
  is the host time of a replay of a one-kernel graph and a synchronise; it
  is reported, not subtracted (the events leave out the host's dispatch).
  ``launch_floor_us`` is each kernel on a one-block 8x128 matrix.
  ``device_stream_gbps`` streams ``s·0.9999 + 0.0001`` over a 268 MB f32
  array 64 times in one graph (read and write per step).
- **``batched64_lp_iterations_per_sec``.** B = 64 copies of the LP (the
  root bounds tiled; exact stream, the batched solve has no bf16 stream):
  4 replays of the batched ``main`` graph, best of 3, Σ over instances of
  Δ``num_accepted`` per second.  Skipped once 300 s have passed.

Checks, none of them in a timed window; a failed one exits 1 with no
JSON: every state finite after each block; each stream accepted at least
one iteration per major (each instance, in the batch); one exact and one
fast product on the bench A against its plain version (1e-5·(1+‖y‖∞)
exact, 3e-2·(1+‖y‖∞) fast against exact); every instance of the batch
equal to the first.

Prints, on stderr, ``# nvidia-smi: <name, power limit>`` and ``#
launches: {...}`` (each kernel's launches in this run), then ONE JSON line
on stdout: every key of ``bench.py``'s, with ``device`` the card's name,
plus ``power_limit_w``, ``spmv.launch_floor_us`` and
``attempts_per_iteration`` (per stream).

Runs on the card only; without one it exits 2.  The functions under
``main`` take ``device``, so the CPU tests run their arithmetic.

    python3 bench_torch.py          # or: python -m ortools_tpu_torch bench
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from ortools_tpu_torch.models.generators import block_random_lp
from ortools_tpu_torch.ops import tiled_spmv
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix
from ortools_tpu_torch.pdlp import solver as S
from ortools_tpu_torch.pdlp.params import PdhgParams
from ortools_tpu_torch.utils.device import resolve_device_or_exit

# Problem size: ~4M nnz in dense (8,128) blocks -> 16 MB f32 matrix data,
# bandwidth-bound SpMV; representative of a mid-size LP relaxation.
M = 16384
N = 16384
NUM_BLOCKS = 4096
BLOCK = (8, 128)
MAJORS_TIMED = 128  # timed main-graph replays of 64 attempt slots each
TIMING_REPS = 3  # best-of repetitions

# PINNED CPU baseline for vs_baseline (bench.py:36-42).  Provenance:
# cpu_baseline_iters_per_sec(qp) below, the same-math scipy CSR float64
# loop, single thread: median of 5 runs on the host CPU of the container
# that held the JAX package's benchmark, 2026-08-20, bench matrix
# (16384^2, 4M nnz): 62.8 iter/s.  A CPU number, no card's.  Re-pin only
# with a recorded rerun.
PINNED_CPU_BASELINE_IPS = 62.8
KERNEL_SPMV_ITERS = 512  # chained products per graph for kernel timing
FLOOR_LAUNCHES = 400  # launches a kernel for the launch floor
STREAM_SHAPE = (8192, 8192)  # 268 MB of f32: over four times the L2
STREAM_STEPS = 64
BATCH = 64
BATCH_MAJORS = 4
BATCH_DEADLINE_SEC = 300.0  # bench.py:258-260
EXACT_TOL = 1e-5  # tests/test_tiled_spmv.py:49
FAST_TOL = 3e-2  # tests/test_tiled_spmv.py:144


class BenchFailure(RuntimeError):
    """A check failed: the run prints no result."""


def require(cond: bool, what: str) -> None:
    if not cond:
        raise BenchFailure(what)


def cpu_baseline_iters_per_sec(qp, iters: int = 192) -> float:
    """Same PDHG math on host CPU with scipy CSR (float64, like the
    reference's Eigen path); a copy of bench.py's."""
    a = sp.csr_matrix(qp.constraint_matrix)
    at = sp.csr_matrix(a.T)
    n, m = a.shape[1], a.shape[0]
    c = qp.objective_vector
    lb, ub = qp.variable_lower, qp.variable_upper
    cl, cu = qp.constraint_lower, qp.constraint_upper
    x = np.clip(np.zeros(n), lb, ub)
    y = np.zeros(m)
    ax = a @ x
    aty = at @ y
    tau = sigma = 0.05
    t0 = time.perf_counter()
    for _ in range(iters):
        grad = c - aty
        x_new = np.clip(x - tau * grad, lb, ub)
        ax_mid = a @ (2.0 * x_new - x)
        y_hat = y - sigma * ax_mid
        pos = y_hat + sigma * cl
        neg = y_hat + sigma * cu
        y_new = np.where(pos > 0, pos, np.where(neg < 0, neg, 0.0))
        dx = x_new - x
        dy = y_new - y
        movement = 0.5 * (dx @ dx + dy @ dy)
        interaction = abs(dy @ (ax_mid - ax)) * 0.5
        _ = movement, interaction  # same reductions as the device loop
        ax = 0.5 * (ax_mid + ax)
        aty = at @ y_new
        x, y = x_new, y_new
    dt = time.perf_counter() - t0
    return iters / dt


def host_sigma(qp) -> float:
    """σ_max's upper bound sqrt(‖|A|‖∞·‖|A|‖₁) on the host, as bench.py
    computes it (bench.py:122-126): it avoids a power iteration, and the
    adaptive step rule corrects the initial step anyway."""
    a_csr = sp.csr_matrix(abs(qp.constraint_matrix))
    norm_inf = float(a_csr.sum(axis=1).max())
    norm_1 = float(a_csr.sum(axis=0).max())
    return float(np.sqrt(norm_inf * norm_1))


def card() -> tuple:
    """The card's line from ``nvidia-smi --query-gpu=name,power.limit``
    and its power limit in watts."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    watts = float(line.rsplit(",", 1)[1].strip().split()[0])
    return line.strip(), watts


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_majors(prob: S.DeviceProblem, params: PdhgParams,
                sigma: torch.Tensor) -> S._Majors:
    """The solver's majors on ``prob``, loaded with the initial state at
    σ_max ``sigma``."""
    majors = S._Majors(prob, params)
    majors.load(S._make_initial_state(params)(prob, sigma))
    return majors


def run_block(majors: S._Majors, fast: bool, n_majors: int) -> None:
    """The timed body: ``n_majors`` replays of the stream's main graph
    (eager attempt slots off the card), nothing else."""
    for _ in range(n_majors):
        majors._run("main", fast)


def counts(state: S.PdhgState) -> tuple:
    """Each instance's (num_accepted, num_steps) on the host."""
    return (state.num_accepted.reshape(-1).cpu().numpy().astype(np.int64),
            state.num_steps.reshape(-1).cpu().numpy().astype(np.int64))


def check_state(state: S.PdhgState, label: str) -> None:
    for name, v in zip(S.PdhgState._fields, state):
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()),
                    f"{label}: the state's {name} is not finite")


def timed_blocks(majors: S._Majors, fast: bool, n_majors: int, reps: int,
                 label: str) -> dict:
    """One block that captures the graphs, then ``reps`` timed blocks of
    ``n_majors`` main-graph replays, each ended by a synchronise and
    followed (outside the window) by a read of the counts and the checks.
    Returns the fastest block's ``rate`` (Σ Δnum_accepted per second),
    ``accepted``, ``attempts`` (Σ Δnum_steps) and ``seconds``."""
    device = majors.state.x.device
    run_block(majors, fast, n_majors)
    synchronize(device)
    check_state(majors.state, label)
    acc0, steps0 = counts(majors.state)
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        run_block(majors, fast, n_majors)
        synchronize(device)
        dt = time.perf_counter() - t0
        acc1, steps1 = counts(majors.state)
        check_state(majors.state, label)
        accepted = acc1 - acc0
        require(int(accepted.min()) >= n_majors,
                f"{label}: an instance accepted {int(accepted.min())} "
                f"iterations in {n_majors} majors")
        block = dict(rate=int(accepted.sum()) / dt,
                     accepted=int(accepted.sum()),
                     attempts=int((steps1 - steps0).sum()), seconds=dt)
        if best is None or block["rate"] > best["rate"]:
            best = block
        acc0, steps0 = acc1, steps1
    return best


def batched_problem(prob: S.DeviceProblem, batch: int) -> S.DeviceProblem:
    """``prob`` with its variable bounds, scaled and original, tiled to
    [batch, N] (the fields ``BatchSolver._batched_problem`` sets)."""
    return prob._replace(**{
        f: getattr(prob, f).expand(batch, -1).contiguous()
        for f in ("var_lb", "var_ub", "orig_var_lb", "orig_var_ub")})


def rows_equal(state: S.PdhgState) -> bool:
    """Whether every instance of a batched state equals the first."""
    return all(torch.equal(v, v[:1].expand_as(v)) for v in state)


def capture(fn, device: torch.device):
    """``fn`` (a function of no arguments that launches work on the current
    stream) after one eager warm-up, captured in a CUDA graph: returns
    (replay, the captured call's output).  ``replay`` adds the captured
    kernel launches to the wrappers' counters, as the solver's graphs do;
    the capture itself launches nothing, so its counts are taken back.  Off
    the card ``replay`` is ``fn`` itself."""
    if device.type != "cuda":
        return fn, fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    before = tiled_spmv.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    launches = tuple(a - b for a, b in zip(tiled_spmv.launch_counts(),
                                           before))
    tiled_spmv.count_launches(*(-n for n in launches))

    def replay():
        graph.replay()
        tiled_spmv.count_launches(*launches)

    return replay, out


def best_ms(fn, device: torch.device, reps: int = TIMING_REPS) -> float:
    """Best of ``reps`` times of one call of ``fn``, after one untimed
    call: device time by CUDA events on the card, host time elsewhere."""
    fn()
    synchronize(device)
    best = math.inf
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def chain(product, x0: torch.Tensor, inv_sigma: torch.Tensor,
          iters: int) -> torch.Tensor:
    """y ← product(y) · (1/σ), ``iters`` times from ``x0``: the counterpart
    of bench.py's ``fori_loop`` of products."""
    y = x0
    for _ in range(iters):
        y = product(y) * inv_sigma
    return y


def chain_us(product, x0, inv_sigma):
    """µs per step of a chain of KERNEL_SPMV_ITERS products, captured as one
    CUDA graph and timed by CUDA events (best of 3 replays), and the
    chain's output."""
    iters = KERNEL_SPMV_ITERS
    replay, y = capture(lambda: chain(product, x0, inv_sigma, iters),
                        x0.device)
    return best_ms(replay, x0.device) * 1e3 / iters, y


def dispatch_fixed_ms(device: torch.device) -> float:
    """Host milliseconds of a replay of a graph that holds one
    one-element kernel, and a synchronise; best of 3."""
    one = torch.zeros(1, device=device)
    replay, _ = capture(lambda: one.add_(1.0), device)
    best = math.inf
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        replay()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def queued_ms(fn, count: int, device: torch.device) -> float:
    """Milliseconds of ``count`` calls of ``fn`` after one untimed call.
    On the card the calls queue behind a sleep kernel and CUDA events
    bracket them, so the device's time is measured, not Python's; elsewhere
    the host clock."""
    fn()
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def launch_floor_us(device: torch.device) -> dict:
    """Each kernel on a one-block (8x128) matrix, the SpMM at B = 64: µs
    per launch over FLOOR_LAUNCHES queued launches (chip_smoke.py's launch
    floor)."""
    launches = FLOOR_LAUNCHES
    tiny = BlockSparseMatrix.from_scipy(
        sp.csr_matrix(np.ones(BLOCK)), dtype=torch.float32,
        device=device).with_tiled(hi=True)
    x = torch.ones(tiny.padded_shape[1], device=device)
    xb = torch.ones(BATCH, tiny.padded_shape[1], device=device)
    out = {}
    for name, fn, arg in (
            ("block_spmv_exact", tiled_spmv.tiled_matvec, x),
            ("block_spmv_fast", tiled_spmv.tiled_matvec_fast, x),
            ("block_spmm_exact", tiled_spmv.tiled_matmat, xb)):
        ms = queued_ms(lambda: fn(tiny.tiled, arg), launches, device)
        out[name] = round(ms * 1e3 / launches, 2)
    return out


def stream_step(src: torch.Tensor, dst: torch.Tensor,
                offset: torch.Tensor) -> None:
    """dst = src·0.9999 + 0.0001, one elementwise kernel."""
    torch.add(offset, src, alpha=0.9999, out=dst)


def device_stream_gbps(device: torch.device) -> float:
    """GB/s of ``s·0.9999 + 0.0001`` over an f32 array of STREAM_SHAPE
    (8192²: 268 MB), 64 steps in one graph, each step reading and writing
    the array: the card's achievable streaming rate, for scale."""
    a = torch.zeros(STREAM_SHAPE, device=device)
    b = torch.empty_like(a)
    offset = torch.tensor(1e-4, device=device)

    def steps():
        src, dst = a, b
        for _ in range(STREAM_STEPS):
            stream_step(src, dst, offset)
            src, dst = dst, src
        return src

    replay, _ = capture(steps, device)
    ms = best_ms(replay, device)
    return 2 * a.numel() * a.element_size() / (ms / 1e3 / STREAM_STEPS) / 1e9


def chain_start(prob: S.DeviceProblem) -> torch.Tensor:
    """The chains' x: standard normal from seed 0 (bench.py's x0)."""
    return torch.as_tensor(
        np.random.default_rng(0).standard_normal(prob.a.padded_shape[1]),
        dtype=torch.float32, device=prob.c.device)


def check_products(prob: S.DeviceProblem) -> None:
    """One exact and one fast product on the bench A against their plain
    versions, at the kernels' own tolerances."""
    lay = prob.a.tiled
    x = chain_start(prob)
    ref = tiled_spmv.tiled_matvec_plain(lay, x)
    scale = 1.0 + float(ref.abs().max())
    err = float((tiled_spmv.tiled_matvec(lay, x) - ref).abs().max())
    require(err <= EXACT_TOL * scale,
            f"exact SpMV off its plain version by {err} (scale {scale})")
    if lay.data_hi is not None:
        err = float((tiled_spmv.tiled_matvec_fast(lay, x) - ref).abs().max())
        require(err <= FAST_TOL * scale,
                f"fast SpMV off the exact product by {err} (scale {scale})")


def spmv_numbers(prob: S.DeviceProblem, sigma: float,
                 device: torch.device) -> dict:
    """The ``spmv`` object: chained kernel times, bytes over time, the
    dispatch cost, the launch floor and the streaming rate."""
    lay = prob.a.tiled
    inv_sigma = torch.tensor(1.0 / sigma, dtype=torch.float32, device=device)
    x0 = chain_start(prob)
    out = {"dispatch_fixed_ms": round(dispatch_fixed_ms(device), 2),
           "launch_floor_us": launch_floor_us(device)}
    exact_us, y = chain_us(lambda v: tiled_spmv.tiled_matvec(lay, v), x0,
                           inv_sigma)
    require(bool(torch.isfinite(y).all()), "the exact chain is not finite")
    exact_bytes = lay.data.numel() * lay.data.element_size()
    out["exact_us"] = round(exact_us, 2)
    out["exact_gbps"] = round(exact_bytes / (exact_us / 1e6) / 1e9, 1)
    if lay.data_hi is not None:
        fast_us, y = chain_us(
            lambda v: tiled_spmv.tiled_matvec_fast(lay, v), x0, inv_sigma)
        require(bool(torch.isfinite(y).all()), "the fast chain is not finite")
        fast_bytes = lay.data_hi.numel() * 2
        out["fast_us"] = round(fast_us, 2)
        out["fast_gbps"] = round(fast_bytes / (fast_us / 1e6) / 1e9, 1)
    out["device_stream_gbps"] = round(device_stream_gbps(device), 1)
    return out


def batched_rate(prob: S.DeviceProblem, params: PdhgParams,
                 sigma: torch.Tensor) -> dict:
    """``timed_blocks`` on BATCH copies of ``prob`` (exact stream,
    BATCH_MAJORS a block); every instance must end equal to the first."""
    majors = load_majors(batched_problem(prob, BATCH), params, sigma)
    out = timed_blocks(majors, False, BATCH_MAJORS, TIMING_REPS,
                       f"batch of {BATCH}")
    require(rows_equal(majors.state),
            "the batch's instances differ, though their bounds are equal")
    return out


def _emit(ips, cpu_ips, batched_ips, nnz, device_name, power_limit_w,
          fast_ips=None, spmv=None, attempts=None) -> dict:
    """Print bench.py's JSON line (its keys, units and rounding), with the
    card's name and power limit and the attempts per iteration."""
    out = {
        "metric": "pdhg_iterations_per_sec_per_chip",
        "value": round(ips, 2),
        "unit": "iter/s",
        # pinned denominator: fixed impl/iters/threads (see header)
        "vs_baseline": round(ips / PINNED_CPU_BASELINE_IPS, 3),
        "baseline_cpu_iter_per_sec_pinned": PINNED_CPU_BASELINE_IPS,
        "baseline_cpu_iter_per_sec_live": round(cpu_ips, 2),
        "problem": {"m": M, "n": N, "nnz": int(nnz), "dtype": "float32"},
        "device": device_name,
        "power_limit_w": power_limit_w,
    }
    if fast_ips is not None:
        out["fast_stream_iter_per_sec"] = round(fast_ips, 2)
    if spmv is not None:
        out["spmv"] = spmv
    if batched_ips is not None:
        out["batched64_lp_iterations_per_sec"] = round(batched_ips, 2)
    if attempts is not None:
        out["attempts_per_iteration"] = attempts
    print(json.dumps(out))
    return out


def save_json(stem: str, out: dict) -> Path:
    """Write ``out`` to ``build/bench/<stem>.json`` under the checkout (the
    JAX scripts write theirs under ``artifacts/``, which no port run
    touches)."""
    path = Path(__file__).resolve().parent / "build" / "bench" / f"{stem}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return path


def print_peak_memory(device: torch.device) -> None:
    """``# peak device memory: N bytes`` on stderr: the most this process
    held on ``device`` (``torch.cuda.max_memory_allocated``)."""
    print(f"# peak device memory: "
          f"{torch.cuda.max_memory_allocated(device)} bytes",
          file=sys.stderr, flush=True)


def print_launches() -> None:
    exact, fast, spmm, rows, rows_spmm = tiled_spmv.launch_counts()
    print("# launches: " + json.dumps({
        "block_spmv_exact": exact, "block_spmv_fast": fast,
        "block_spmm_exact": spmm, "block_spmv_rows": rows,
        "block_spmm_rows": rows_spmm}),
        file=sys.stderr, flush=True)


def main() -> int:
    t_start = time.perf_counter()
    device = resolve_device_or_exit("cuda", "bench_torch.py")
    smi, watts = card()
    print(f"# nvidia-smi: {smi}", file=sys.stderr, flush=True)

    qp = block_random_lp(M, N, num_blocks=NUM_BLOCKS, block_shape=BLOCK,
                         seed=0)
    params = PdhgParams(dtype=torch.float32, block_shape=BLOCK)
    prob = S.build_device_problem(qp, params, device)
    sigma_host = host_sigma(qp)
    sigma = torch.tensor(sigma_host, dtype=params.dtype, device=device)
    try:
        check_products(prob)
        majors = load_majors(prob, params, sigma)
        exact = timed_blocks(majors, False, MAJORS_TIMED, TIMING_REPS,
                             "exact stream")
        attempts = {"exact": round(exact["attempts"] / exact["accepted"], 4)}
        fast_ips = None
        if prob.a.has_fast_stream and prob.at.has_fast_stream:
            majors.load(S._make_initial_state(params)(prob, sigma))
            fast = timed_blocks(majors, True, MAJORS_TIMED, TIMING_REPS,
                                "fast stream")
            fast_ips = fast["rate"]
            attempts["fast"] = round(fast["attempts"] / fast["accepted"], 4)
        del majors
        spmv = spmv_numbers(prob, sigma_host, device)
        cpu_ips = cpu_baseline_iters_per_sec(qp)
        batched_ips = None
        if time.perf_counter() - t_start <= BATCH_DEADLINE_SEC:
            batch = batched_rate(prob, params, sigma)
            batched_ips = batch["rate"]
            attempts[f"batched{BATCH}"] = round(
                batch["attempts"] / batch["accepted"], 4)
    except BenchFailure as e:
        print(f"bench_torch.py: {e}", file=sys.stderr)
        return 1
    print_launches()
    _emit(exact["rate"], cpu_ips, batched_ips, qp.num_nonzeros,
          torch.cuda.get_device_name(device), watts, fast_ips, spmv,
          attempts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
