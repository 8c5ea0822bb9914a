#!/usr/bin/env python3
"""The batched block-SpMM kernel alone at the bench shape, on one card.

    python3 scripts/torch_spmm_probe.py [TREE] [--check] [--rates] [--rows]
        [--variant NAME:CONST=VALUE[,CONST=VALUE...]] [--patch NAME OLD NEW]

``TREE`` is the root of a checkout (by default this one).  Its
``chip_smoke.py`` and ``ortools_tpu_torch`` are imported from there, so a
parent commit unpacked with ``git archive`` is timed by the same code in the
same call.  The script builds the tree's kernels, makes the bench LP's
scaled problem as phase 7 of ``chip_smoke.py`` does (16384², 4096 blocks of
8x128, seed 0, exact stream), and prints, for A and Aᵀ at B = 64 in f32 and
f64, the kernel's time L2-cold and L2-warm (CUDA events, ``chip_smoke``'s
``time_launches`` and ``_cold_copies``) beside the bound and the bytes of x
that a row-wise kernel gathers through L2.  ``--check`` first holds the
kernel against its plain version on every shape (``chip_smoke``'s
``spmm_against_plain``).  ``--rates`` then runs, with the tree's own
kernels, what the SpMM moves end to end: the moderate LPs of phase 4
(iterations and objectives), the single path's stream rates (phase 5) and
the batched main path with its rates and device profile (phase 7).

``--rows`` times the batched row kernel (``block_spmm_rows``) instead, on
the row layouts of the benchmark's node-LP relaxation (``ROWS_CONFIG``, A
and Aᵀ as the solve scales them) at B = 8 and 64 in f32 and f64: held to
its plain version and run twice, bit-identical; then L2-cold and L2-warm
beside the block kernel on the same matrix and the benchmark's bound
(``nnz·s + B·(m + n)·s``); then captured in a CUDA graph and replayed.

``--variant`` builds a copy of ``block_spmm.cu`` with the named
``constexpr int`` constants changed into ``build/spmm_variants/``, prints
its registers and spills, checks it against the plain version at the bench
shape and times it the same way.  ``--patch NAME OLD NEW`` builds a copy
with a piece of the source replaced instead (a diagnostic, e.g. a variant
without the FMAs, whose check then fails).  A name that starts with
``SPMM_`` is a
constant of the schedule (``tiled_spmv.py``) instead, and ``kMaxRows``
sets ``SPMM_ROWS`` too; a variant that changes only the schedule runs the
tree's own library.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

BATCH = 64
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}  # f32, f64 outside the tensor cores


# The benchmark's configuration whose batched products take the row layout.
ROWS_CONFIG = "mcnd-c-30-520-100-relax-f32"


def rows_probe(cs, T, S, PdhgParams, torch, variants) -> None:
    """The batched row kernel of each variant on the relaxation's A and
    Aᵀ (see the module's docstring)."""
    qp = cs.benchmark_qp(ROWS_CONFIG)
    prob = S.build_device_problem(qp, PdhgParams(dtype=torch.float32),
                                  "cuda")
    nnz = qp.constraint_matrix.nnz
    from ortools_tpu_torch.ops import _build

    for name, _, _, lib in variants:
        _build._libs["block_spmm"] = lib
        for dtype, vbytes, tol in ((torch.float32, 4, 1e-5),
                                   (torch.float64, 8, 1e-12)):
            for orient, mat in (("A", prob.a), ("A^T", prob.at)):
                mat = dataclasses.replace(
                    mat, data=mat.data.to(dtype),
                    rows=mat.rows._replace(values=mat.rows.values.to(dtype)),
                    tiled=None).with_tiled()
                lay = mat.rows
                m, n = mat.padded_shape
                for batch in (8, BATCH):
                    x = cs._batch_x(mat, batch, dtype, 2)
                    y = T.rows_matmat(lay, x)
                    y2 = T.rows_matmat(lay, x)
                    ref = T.rows_matmat_plain(lay, x)
                    err, scale = cs._rel_err(y, ref)
                    ok = err <= tol * scale and torch.equal(y, y2)
                    lays = cs._row_cold_copies(lay)
                    ms = cs.time_launches(T.rows_matmat,
                                          [(t, x) for t in lays], 200)
                    warm = cs.time_launches(T.rows_matmat, [(lay, x)], 200)
                    blocks = cs._cold_copies(mat.tiled)
                    block_ms = cs.time_launches(
                        T.tiled_matmat, [(t, x) for t in blocks], 50)
                    work = nnz * vbytes + batch * (m + n) * vbytes
                    b_ms = work / PEAK_BYTES_PER_S * 1e3
                    rule = T.prefer_rows_batched(
                        lay.nnz, lay.num_rows, mat.num_blocks,
                        mat.block_shape, vbytes, batch)
                    print(f"rows {name:12s} {str(dtype)[6:]:7s} {orient:3s} "
                          f"B={batch:2d}: kernel {ms * 1e3:.2f} us (L2-warm "
                          f"{warm * 1e3:.2f} us), bound {b_ms * 1e3:.2f} us "
                          f"({b_ms / ms:.1%}); block kernel "
                          f"{block_ms * 1e3:.2f} us; rule "
                          f"{'rows' if rule else 'blocks'}; err {err:.2e} "
                          f"{'ok' if ok else 'WRONG'}", flush=True)
                    del lays, blocks
    for name, _, _, lib in variants:
        _build._libs["block_spmm"] = lib
        for orient, mat in (("A", prob.a), ("A^T", prob.at)):
            lay = mat.rows
            x = cs._batch_x(mat, BATCH, torch.float32, 3)
            eager = T.rows_matmat(lay, x)
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                T.rows_matmat(lay, x)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = T.rows_matmat(lay, x)
            same = True
            for _ in range(3):
                out.zero_()
                graph.replay()
                torch.cuda.synchronize()
                same = same and torch.equal(out, eager)
            print(f"rows {name:12s} float32 {orient:3s} graph: "
                  f"{'bit-identical' if same else 'DIFFERS'}", flush=True)


def bound(mat, vbytes: int):
    """(ms, "bytes" | "operations", bytes of x gathered through L2)."""
    nb, (bm, bn) = mat.num_blocks, mat.block_shape
    m, n = mat.padded_shape
    nbytes = ((nb * bm * bn + (n + m) * BATCH) * vbytes
              + (m // bm + 1) * 4 + nb * 4)
    t_b = nbytes / PEAK_BYTES_PER_S
    t_o = 2 * nb * bm * bn * BATCH / PEAK_FLOPS[vbytes]
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nb * bn * BATCH * vbytes)


def build_variant(root: Path, name: str, consts: dict):
    """Write block_spmm.cu with ``consts`` changed; returns the source's
    and the library's paths."""
    src = (root / "ortools_tpu_torch/ops/csrc/block_spmm.cu").read_text()
    for const, value in consts.items():
        if const.startswith("@"):  # a diagnostic: "@old text" -> new text
            if src.count(const[1:]) != 1:
                raise SystemExit(f"variant {name}: {const[1:]!r} is not in "
                                 f"the source once")
            src = src.replace(const[1:], value)
            continue
        src, k = re.subn(rf"constexpr int {const} = [^;]+;",
                         f"constexpr int {const} = {value};", src)
        if k != 1:
            raise SystemExit(f"variant {name}: no constant {const}")
    out = root / "build" / "spmm_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    return cu, so


def ptxas_summary(report: str) -> list:
    """(kernel instantiation, registers, spill bytes) of each SpMM kernel,
    the block kernel's and the row kernel's."""
    rows, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"block_spmm_kernelI([fd])Li(\d+)ELi(\d+)E", line)
        if m:
            name = f"{'f32' if m.group(1) == 'f' else 'f64'} " \
                   f"{m.group(2)}x{m.group(3)}"
        m = re.search(r"block_spmm_kernel_rowsI([fd])E", line)
        if m:
            name = f"{'f32' if m.group(1) == 'f' else 'f64'} rows"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--patch", action="append", nargs=3, default=[],
                    metavar=("NAME", "OLD", "NEW"))
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)

    import torch
    import chip_smoke as cs
    from ortools_tpu_torch.models.generators import block_random_lp
    from ortools_tpu_torch.ops import _build, tiled_spmv as T
    from ortools_tpu_torch.pdlp import PdhgParams
    from ortools_tpu_torch.pdlp import solver as S

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print("tree", root, "card", torch.cuda.get_device_name(0), flush=True)
    report = _build.build(("block_spmm",))
    lib0 = _build.library("block_spmm")
    for row in ptxas_summary(report):
        print("ptxas base %s: %d registers, %d bytes spilled" % row)

    variants = [("base", {}, {}, lib0)]
    jobs = []
    specs = []
    for spec in args.variant:
        name, _, rest = spec.partition(":")
        specs.append((name, dict(kv.split("=") for kv in rest.split(",")
                                 if kv)))
    specs += [(name, {"@" + old: new}) for name, old, new in args.patch]
    for name, consts in specs:
        sched = {k: int(v) for k, v in consts.items() if k.startswith("SPMM_")}
        if "kMaxRows" in consts:
            sched["SPMM_ROWS"] = int(consts["kMaxRows"])
        kernel = {k: v for k, v in consts.items() if not k.startswith("SPMM_")}
        if not kernel:
            variants.append((name, kernel, sched, lib0))
            continue
        cu, so = build_variant(root, name, kernel)
        proc = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, kernel, sched, so, proc))
    for name, kernel, sched, so, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode:
            print(f"variant {name}: nvcc failed\n{err}")
            continue
        lib = ctypes.CDLL(str(so))
        for fname, argtypes in _build._FUNCTIONS["block_spmm"].items():
            getattr(lib, fname).argtypes = argtypes
            getattr(lib, fname).restype = ctypes.c_int
        for row in ptxas_summary(out + err):
            print(f"ptxas {name} %s: %d registers, %d bytes spilled" % row)
        variants.append((name, kernel, sched, lib))

    if args.rows:
        rows_probe(cs, T, S, PdhgParams, torch, variants)
        return 0
    qp = block_random_lp(**cs.BENCH)
    prob = S.build_device_problem(qp, dataclasses.replace(
        PdhgParams(**cs.BENCH_PARAMS), stream_precision="exact"), "cuda")
    if args.check:
        print(cs.spmm_against_plain(prob), flush=True)

    defaults = {k: getattr(T, k) for k in dir(T) if k.startswith("SPMM_")}
    for name, kernel, sched, lib in variants:
        _build._libs["block_spmm"] = lib
        for k, v in {**defaults, **sched}.items():
            setattr(T, k, v)
        for dtype, vbytes, tol in ((torch.float32, 4, 1e-5),
                                   (torch.float64, 8, 1e-12)):
            for orient, mat in (("A", prob.a), ("A^T", prob.at)):
                mat = dataclasses.replace(mat, data=mat.data.to(dtype),
                                          tiled=None).with_tiled()
                x = cs._batch_x(mat, BATCH, dtype, 2)
                y = T.tiled_matmat(mat.tiled, x)
                y2 = T.tiled_matmat(mat.tiled, x)
                ref = T.tiled_matmat_plain(mat.tiled, x)
                err, scale = cs._rel_err(y, ref)
                ok = err <= tol * scale and torch.equal(y, y2)
                lays = cs._cold_copies(mat.tiled)
                fn_args = [(t, x) for t in lays]
                ms = cs.time_launches(T.tiled_matmat, fn_args, 200)
                warm = cs.time_launches(T.tiled_matmat, fn_args[:1], 200)
                b_ms, b_by, gathered = bound(mat, vbytes)
                items = getattr(mat.tiled, "spmm_schedule", None)
                n_items = "-" if items is None else int(items.shape[0])
                print(f"spmm {name:22s} {str(dtype)[6:]:7s} {orient:3s}: "
                      f"kernel {ms * 1e3:.2f} us (L2-warm {warm * 1e3:.2f} "
                      f"us), bound {b_ms * 1e3:.2f} us ({b_by}), "
                      f"{gathered} bytes of x gathered, {n_items} items; "
                      f"err {err:.2e} {'ok' if ok else 'WRONG'}", flush=True)
                del lays, fn_args
    if args.rates:
        del prob, mat, x, y, y2, ref
        _build._libs["block_spmm"] = lib0
        for k, v in defaults.items():
            setattr(T, k, v)
        torch.cuda.empty_cache()
        cs.moderate_solve()
        single = S.build_device_problem(qp, PdhgParams(**cs.BENCH_PARAMS),
                                        "cuda")
        _, majors = cs.stream_rates(single)
        del majors, single
        torch.cuda.empty_cache()
        _, backend = cs.batched_main_path(qp)
        cs.batched_rates(backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
