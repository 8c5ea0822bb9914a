"""One run of one cell: set-up, the measured window, the judgement."""

from __future__ import annotations

import gc
import math
import time
from pathlib import Path

from lpbench import trace as tr
from lpbench.spec import end_to_end_reader, kind, load_cell, metric_reader


def _number(v):
    """A judged number for JSON: an int, a float, or 'inf' / 'nan'."""
    if isinstance(v, int):
        return v
    return float(v) if math.isfinite(v) else str(float(v))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_process: float):
    """Run ``workload`` of ``root/BENCHMARK.json``: returns the result (the
    JSON line) and the judged numbers' lines for standard error.  The
    window goes on past ``seconds`` to the end of the call in flight and,
    where the mix works in passes over a pool, of the pass; each
    end-to-end reader (``end_to_end/<metric>.py``) reads the set-up, the
    window's whole time and the answers that passed."""
    import torch

    cell = load_cell(root, workload)
    cuda = device.type == "cuda"
    mix = kind(cell.bench_dir, cell.traffic["kind"])(cell, seed, device)
    mix.setup()
    if cuda:
        torch.cuda.synchronize()
    tracer = tr.Tracer(device, float(cell.traffic["trace_seconds"])) \
        if trace else None
    units = lps = 0
    unit_s = []
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    deadline = t0 + seconds
    while True:
        t_unit = time.perf_counter()
        if tracer:
            with tracer.call():
                lps += mix.unit()
        else:
            lps += mix.unit()
        units += 1
        unit_s.append(time.perf_counter() - t_unit)
        if time.perf_counter() >= deadline and mix.at_pass_end():
            break
    if tracer:
        tracer.stop()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dtype = cell.config["params"]["dtype"]
    tdata = None
    if tracer:
        tdata = tracer.data(mix.kind, dtype, mix.shape(), cell.bench_dir,
                            mix.window_info().get("iterations", []))
    mix.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judged = mix.judge()
    numbers = judged.numbers()
    run = dict(setup_s=setup_s, elapsed=elapsed, passed=judged.window_passed)
    metrics = {}
    if tdata is None:
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": end_to_end_reader(cell.bench_dir, m["name"])(run),
                "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = metric_reader(cell.bench_dir, m["name"])(tdata)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tdata is not None:
        dev["busy_s"] = tdata.busy_s
        dev["window_s"] = tdata.window_s
    result = {"correct": judged.correct, "attempted": judged.attempted,
              "failed": judged.failed, "metrics": metrics, "device": dev}
    if tdata is not None:
        result["breakdown"] = tr.breakdown(tdata)
    result["window"] = {"seconds": elapsed, "units": units, "lps": lps,
                        "unit_seconds": unit_s, **mix.window_info()}
    result["check"] = {k: {"value": _number(v), "limit": lim}
                       for k, (v, lim) in numbers.items()}
    lines = [f"check {k}: {_number(v)} (limit {lim})"
             for k, (v, lim) in numbers.items()]
    return result, lines
