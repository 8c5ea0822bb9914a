"""Entry points: the single-device major step and a multi-device dry run
(port of the JAX package's ``__graft_entry__.py``).

- ``entry()`` returns ``(run_major, (prob, state))``: one major of the
  PDHG (``termination_check_frequency`` adaptive iterations, each two
  block-sparse SpMVs and vector ops) on a small LP.
- ``dryrun_multichip(n)`` starts ``n`` ranks and runs whole solves over a
  1-D mesh of ``n`` and, for even ``n >= 4``, a 2-D ``(2, n/2)`` mesh,
  each held against the single-device solve of the same LP.
- ``start_ranks`` is the rank launcher: it lives in the package so that
  the spawned ranks can import their target.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from ortools_tpu_torch.utils.device import resolve_device


def _tiny_problem(seed: int = 0):
    from ortools_tpu_torch.models.generators import block_random_lp

    return block_random_lp(256, 256, num_blocks=64, block_shape=(8, 128),
                           seed=seed)


def entry(device="cuda"):
    """(run_major, (prob, state)): one major's function and its arguments
    on a small f32 LP, from the initial state at sigma_max = 4."""
    from ortools_tpu_torch.pdlp import solver as S
    from ortools_tpu_torch.pdlp.params import PdhgParams

    params = PdhgParams(dtype=torch.float32)
    prob = S.build_device_problem(_tiny_problem(), params, device)
    state = S._make_initial_state(params)(
        prob, torch.tensor(4.0, dtype=torch.float32, device=prob.c.device))
    return S._make_run_major(params), (prob, state)


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------


def _default_backend(device: torch.device, n: int) -> str:
    """NCCL on cards, gloo on the CPU.  NCCL takes one card per rank, so
    ranks that share a card must ask for gloo themselves."""
    if device.type != "cuda":
        return "gloo"
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(
            f"NCCL needs one card per rank: {n} ranks, {count} cards; pass "
            f"backend='gloo' to share the cards")
    return "nccl"


def _rank_main(rank: int, n: int, init_method: str, backend: str,
               device_type: str, pg_timeout: float, target: Callable,
               args: tuple, results) -> None:
    """One rank: join the group, run ``target(*args)``, report."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            # the n ranks share the host's cores: an even share of torch's
            # threads each (each rank starts with them all, and n pools
            # spinning on the same cores slow every rank's host loop)
            torch.set_num_threads(max(1, torch.get_num_threads() // n))
        else:
            # n ranks share the host's cores: one torch thread each
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=pg_timeout))
        try:
            out = target(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))


class RankJob:
    """Ranks started by ``start_ranks``; ``join`` collects their results."""

    def __init__(self, procs, results, tmpdir, timeout: float):
        self._procs = procs
        self._results = results
        self._tmpdir = tmpdir
        self._deadline = time.monotonic() + timeout

    def kill(self) -> None:
        """End every rank that is still running."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join()
        self._tmpdir.cleanup()

    def join(self) -> List[Any]:
        """Each rank's return value, in rank order.  Raises, with the
        failed rank's traceback, when a rank fails or the time is up; every
        rank is killed then, and ended in any case."""
        n = len(self._procs)
        out: dict = {}
        failure = None
        try:
            while len(out) < n and failure is None:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    failure = (f"ranks {sorted(set(range(n)) - set(out))} "
                               f"did not finish in time")
                    break
                try:
                    rank, ok, value = self._results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [p.exitcode for p in self._procs
                            if p.exitcode not in (None, 0)]
                    if dead and self._results.empty():
                        failure = f"a rank died with exit code {dead[0]}"
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in self._procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            self._tmpdir.cleanup()
        if failure is not None:
            raise RuntimeError(failure)
        return [out[k] for k in range(n)]


def start_ranks(n: int, target: Callable, args: Sequence = (),
                device="cuda", backend: Optional[str] = None,
                timeout: float = 600.0) -> RankJob:
    """Start ``n`` ranks, each a spawned process that joins a
    ``torch.distributed`` group of ``n`` (a ``file://`` store in a
    temporary directory; ``backend`` by ``_default_backend``; a process-group
    timeout of ``timeout`` seconds) and runs ``target(*args)``.  ``target``
    must be importable (a module-level function).  On a card (the
    default; ``device="cpu"`` for CPU ranks), rank k takes card
    ``k % device_count``; CPU ranks run one torch thread each."""
    device = resolve_device(device)
    backend = backend or _default_backend(device, n)
    ctx = torch_mp.get_context("spawn")
    results = ctx.Queue()
    tmpdir = tempfile.TemporaryDirectory(prefix="ranks-")
    init_method = "file://" + os.path.join(tmpdir.name, "store")
    procs = []
    for rank in range(n):
        p = ctx.Process(
            target=_rank_main,
            args=(rank, n, init_method, backend, device.type, timeout,
                  target, tuple(args), results),
            daemon=True)
        p.start()
        procs.append(p)
    return RankJob(procs, results, tmpdir, timeout)


# ---------------------------------------------------------------------------
# Solves on a mesh
# ---------------------------------------------------------------------------


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _solve_both(qp, params, device, shape, axis_names=("shards",)):
    from ortools_tpu_torch.parallel import make_mesh
    from ortools_tpu_torch.pdlp import solve

    single = solve(qp, params, device=device)
    mesh = make_mesh(shape, axis_names, device=device,
                     backend=dist.get_backend())
    return single, solve(qp, params, device=device, mesh=mesh)


def _dryrun_rank(n: int, device: str) -> list:
    """One rank of ``dryrun_multichip``: the single-device solve and the
    mesh solve of each layout, as the JAX dry run makes them."""
    from ortools_tpu_torch.models.lp import random_lp
    from ortools_tpu_torch.pdlp import PdhgParams

    # f64 keeps the cross-mesh iteration-count invariance (on the card's
    # f64 as on the CPU)
    params = PdhgParams(dtype=torch.float64, iteration_limit=20000)
    out = [("1-D", (n,)) + _solve_both(
        random_lp(60, 60, density=0.2, seed=23), params, device, (n,))]
    if n % 2 == 0 and n >= 4:
        out.append((f"2-D (2,{n // 2})", (2, n // 2)) + _solve_both(
            random_lp(80, 70, density=0.15, seed=37), params, device,
            (2, n // 2), ("row", "col")))
    return out


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: Optional[str] = None,
                     timeout: float = 600.0) -> None:
    """Whole solves over an ``n_devices``-rank mesh, each OPTIMAL with the
    iteration count and objective of the single-device solve of the same
    LP, on every rank alike: the 1-D block-sharded path (psum of partial
    products) on ``random_lp(60, 60, 0.2, seed=23)`` and, for even
    ``n_devices >= 4``, the 2-D ``(2, n/2)`` row x col path (segment psum
    and all_gather, ``Comm2D``) on ``random_lp(80, 70, 0.15, seed=37)``:
    the JAX dry run's contract (tests/test_pdlp_sharded.py)."""
    device = resolve_device(device)
    ranks = start_ranks(n_devices, _dryrun_rank, (n_devices, device.type),
                        device=device, backend=backend,
                        timeout=timeout).join()
    for label, shape, r1, r in ranks[0]:
        _check(r1.termination_reason.name == "OPTIMAL",
               f"{label}: single-device {r1.termination_reason.name}")
        _check(r.termination_reason.name == "OPTIMAL",
               f"{label}: mesh {r.termination_reason.name}")
        _check(r.iterations == r1.iterations,
               f"{label}: {r.iterations} iterations, single-device "
               f"{r1.iterations}")
        _check(abs(r.primal_objective - r1.primal_objective)
               <= 1e-6 * (1 + abs(r1.primal_objective)),
               f"{label}: objective {r.primal_objective!r}, single-device "
               f"{r1.primal_objective!r}")
        print(f"dryrun_multichip({n_devices}): {label} ok: OPTIMAL after "
              f"{r.iterations} iterations (== single-device), "
              f"obj={r.primal_objective:.8f} (single-device "
              f"{r1.primal_objective:.8f})")
    for rank, res in enumerate(ranks[1:], 1):
        for (label, _, _, r0), (_, _, _, r) in zip(ranks[0], res):
            _check(r.iterations == r0.iterations
                   and r.primal_objective == r0.primal_objective
                   and (r.primal_solution == r0.primal_solution).all(),
                   f"{label}: rank {rank}'s result differs from rank 0's")


if __name__ == "__main__":
    fn, fn_args = entry()
    out = fn(*fn_args)
    print("entry(): ran; num_steps =", int(out.num_steps))
