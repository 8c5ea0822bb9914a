"""The bench's stream rates in turns, on one CUDA card.

    python3 scripts/torch_bench_probe.py [ORDER]

ORDER is a comma-separated list of streams (``exact`` or ``fast``; default
``exact,fast,exact,fast``).  The bench LP is built as ``bench_torch.py``
builds it (host σ, f32, 8x128 blocks).  Each turn, from a fresh initial
state, runs the bench's block (128 main-graph replays and a synchronise)
once to capture and then BLOCKS times, printing each block's rate
(Δ``num_accepted`` per second), and times one main graph by CUDA events
(16 replays); then the turn's attempts per iteration, the seconds since
the process started and the card's SM and memory clocks, power draw and
temperature (``nvidia-smi``).  Run it more than once in one call to
compare processes.  Runs on the card only.
"""

import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import bench_torch as B  # noqa: E402
from ortools_tpu_torch.models.generators import block_random_lp  # noqa: E402
from ortools_tpu_torch.ops import _build  # noqa: E402
from ortools_tpu_torch.pdlp import solver as S  # noqa: E402
from ortools_tpu_torch.pdlp.params import PdhgParams  # noqa: E402
from ortools_tpu_torch.utils.device import resolve_device_or_exit  # noqa: E402

BLOCKS = 6  # timed blocks a turn, after the capturing one


def card_state() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def block_rate(majors, fast: bool, device) -> float:
    """One bench block (MAJORS_TIMED main-graph replays, a synchronise):
    Δnum_accepted per second."""
    acc0, _ = B.counts(majors.state)
    t0 = time.perf_counter()
    B.run_block(majors, fast, B.MAJORS_TIMED)
    B.synchronize(device)
    dt = time.perf_counter() - t0
    acc1, _ = B.counts(majors.state)
    return int((acc1 - acc0).sum()) / dt


def main(argv) -> int:
    device = resolve_device_or_exit("cuda", "torch_bench_probe.py")
    order = (argv[0] if argv else "exact,fast,exact,fast").split(",")
    if any(s not in ("exact", "fast") for s in order):
        print(f"torch_bench_probe.py: streams are exact or fast: {order}",
              file=sys.stderr)
        return 2
    print(f"{B.card()[0]}; at start {card_state()}", flush=True)
    _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    qp = block_random_lp(B.M, B.N, B.NUM_BLOCKS, B.BLOCK, seed=0)
    params = PdhgParams(dtype=torch.float32, block_shape=B.BLOCK)
    prob = S.build_device_problem(qp, params, device)
    sigma = torch.tensor(B.host_sigma(qp), dtype=params.dtype,
                         device=device)
    majors = B.load_majors(prob, params, sigma)
    for turn, stream in enumerate(order):
        fast = stream == "fast"
        majors.load(S._make_initial_state(params)(prob, sigma))
        t0 = time.perf_counter()
        acc0, steps0 = B.counts(majors.state)
        rates = [block_rate(majors, fast, device) for _ in range(BLOCKS + 1)]
        B.check_state(majors.state, f"turn {turn}")
        acc1, steps1 = B.counts(majors.state)
        ms = B.best_ms(
            lambda: [majors._run("main", fast) for _ in range(16)],
            device) / 16
        print(f"turn {turn} {stream}: blocks {rates[0]:.1f} (capturing), "
              f"{', '.join(f'{r:.1f}' for r in rates[1:])} iter/s; one main "
              f"graph {ms:.3f} ms by events ({64e3 / ms:.1f} iter/s); "
              f"attempts per iteration "
              f"{(steps1 - steps0).sum() / (acc1 - acc0).sum():.4f}; turn "
              f"{time.perf_counter() - t0:.1f} s, ended at "
              f"{time.perf_counter() - T_START:.1f} s; {card_state()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
