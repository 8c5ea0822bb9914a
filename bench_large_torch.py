"""At-scale PDHG benchmark on one CUDA card (port of ``bench_large.py``).

The LP is 131072², 10,240 dense blocks of 8x128 (10,485,760 nonzeros,
BASELINE config 5's shape), ``block_random_lp`` seed 1, f32.  σ_max comes
from the solver's power iteration (``pdlp/solver.py::_make_power_iter``)
started from a standard normal vector of a ``torch.Generator`` seeded with
1.  ``bench_large.py`` starts it from ``jax.random.normal(PRNGKey(1))``,
whose draw torch cannot reproduce: σ differs in its last digits, which
moves the initial step, not the rate.

The timed block is ``bench_torch.py``'s: 8 replays of the exact stream's
``main`` graph (no statistics, no host read) and a synchronise, best of 2,
after one block that captures the graphs; the rate counts Δ``num_accepted``.
The CPU baseline is ``bench_torch.cpu_baseline_iters_per_sec`` at 16
iterations.  Prints ``# nvidia-smi: ...`` and ``# launches: {...}`` on
stderr, then one JSON line with ``bench_large.py``'s keys, ``device`` the
card's name, and ``power_limit_w``.  Runs on the card only; without one
it exits 2.

    python3 bench_large_torch.py
"""

from __future__ import annotations

import json
import sys

import torch

from bench_torch import (BenchFailure, card, cpu_baseline_iters_per_sec,
                         load_majors, print_launches, timed_blocks)
from ortools_tpu_torch.models.generators import block_random_lp
from ortools_tpu_torch.pdlp import solver as S
from ortools_tpu_torch.pdlp.params import PdhgParams
from ortools_tpu_torch.utils.device import resolve_device_or_exit

M = N = 131072
NUM_BLOCKS = 10240
BLOCK = (8, 128)
MAJORS = 8
REPS = 2
SEED = 1


def power_iteration_sigma(prob: S.DeviceProblem, params: PdhgParams,
                          seed: int = SEED) -> torch.Tensor:
    """σ_max by the solver's power iteration from a seeded normal start."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    v0 = torch.randn(prob.c.shape[0], generator=gen, dtype=torch.float64)
    return S._make_power_iter(params)(prob, v0.to(prob.c))


def main() -> int:
    device = resolve_device_or_exit("cuda", "bench_large_torch.py")
    smi, watts = card()
    print(f"# nvidia-smi: {smi}", file=sys.stderr, flush=True)
    qp = block_random_lp(M, N, num_blocks=NUM_BLOCKS, block_shape=BLOCK,
                         seed=SEED)
    params = PdhgParams(dtype=torch.float32, block_shape=BLOCK)
    prob = S.build_device_problem(qp, params, device)
    sigma = power_iteration_sigma(prob, params)
    try:
        block = timed_blocks(load_majors(prob, params, sigma), False, MAJORS,
                             REPS, "large LP, exact stream")
    except BenchFailure as e:
        print(f"bench_large_torch.py: {e}", file=sys.stderr)
        return 1
    ips = block["rate"]
    cpu = cpu_baseline_iters_per_sec(qp, iters=16)
    print(f"# attempts per iteration: "
          f"{block['attempts'] / block['accepted']:.4f}; sigma "
          f"{float(sigma)!r}", file=sys.stderr)
    print_launches()
    print(json.dumps({
        "metric": "pdhg_large_iterations_per_sec_per_chip",
        "value": round(ips, 2),
        "unit": "iter/s",
        "vs_baseline": round(ips / cpu, 2),
        "baseline_cpu_iter_per_sec": round(cpu, 3),
        "problem": {"m": M, "n": N, "nnz": int(qp.num_nonzeros)},
        "device": torch.cuda.get_device_name(device),
        "power_limit_w": watts,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
