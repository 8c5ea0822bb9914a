"""Phase 11b of ``chip_smoke.py`` alone on the card, and a moderate LP's
iteration counts under other meshes' orders of summation.

    python3 scripts/torch_mesh_probe.py [--seed 1] [--orders 2,4,1x2,2x4]
                                        [--dtype f32|f64] [--no-ranks]

Builds the kernels, runs ``chip_smoke.gloo_ranks`` (gloo ranks sharing the
card, with all of its checks; left out with ``--no-ranks``), then solves
``block_random_lp(2048, 2048, 512, (8, 128), seed)`` (f32 or f64) once on the
single exact path and once for each layout of ``--orders`` (``4`` a 1-D
mesh of 4, ``2x4`` a 2-D one) as one process whose products sum their
partials in that mesh's order (``chip_smoke.mesh_arithmetic_solve``),
printing each iteration count: how far the order of summation alone moves
the count.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _layout(text: str):
    shape = tuple(int(k) for k in text.split("x"))
    return shape, ("shards",) if len(shape) == 1 else ("row", "col")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=cs.MESH_SEED)
    ap.add_argument("--orders", default="")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--no-ranks", action="store_true")
    args = ap.parse_args()
    print(cs.environment(), flush=True)
    cs._build.build()
    for name in cs._build.SOURCES:
        cs._build.library(name)
    if not args.no_ranks:
        t0 = time.perf_counter()
        errs = cs.gloo_ranks()
        print(f"phase 11b passed in {time.perf_counter() - t0:.1f} s; shard "
              f"errors {errs}", flush=True)
    qp = cs.block_random_lp(**cs.MODERATE, seed=args.seed)
    params = cs.PdhgParams(dtype={"f32": torch.float32,
                                  "f64": torch.float64}[args.dtype])
    single = cs.solve(qp, dataclasses.replace(params,
                                              stream_precision="exact"))
    print(f"seed {args.seed}, {args.dtype}, single exact path: "
          f"{single.termination_reason.name} after {single.iterations} "
          f"iterations", flush=True)
    for text in filter(None, args.orders.split(",")):
        shape, names = _layout(text)
        r = cs.mesh_arithmetic_solve(qp, params, shape, names)
        print(f"seed {args.seed}, {args.dtype}, the sums of mesh {shape}: "
              f"{r.termination_reason.name} after {r.iterations} iterations "
              f"(ratio {r.iterations / single.iterations:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
