#!/usr/bin/env python3
"""Run a cell's control on the card: the cell one precision below its
configuration's (``lpbench/control.py``), once per seed, and print the
judged numbers of each run as a JSON line.  The judgement has to find
every control run not correct.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    from lpbench.control import run_control
    from lpbench.runner import _number

    for seed in args.seeds:
        judged, lowered = run_control(ROOT, args.workload, seed, args.seconds,
                                      torch.device("cuda"))
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": lowered,
            "correct": judged.correct, "attempted": judged.attempted,
            "failed": judged.failed,
            "check": {k: {"value": _number(v), "limit": lim}
                      for k, (v, lim) in judged.numbers().items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
