"""The per-layer metrics that read the program's own counters in a traced
run (``lpbench/program_counters.py``, ``metrics/*.py``), on the CPU: each
tiny cell reports its kind's as finite numbers, the window's work after
the slice and nothing of set-up, the graph replays over set-up alone, and
a program without the counters leaves them out."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import BENCH, ROOT, TINY_CELLS
from lpbench.runner import run_cell
from lpbench.spec import metric_reader

COUNTER_METRICS = {
    "solve": ("replay_s.solve", "host_loop_s.solve", "slot_use.solve",
              "rescale_s.solve"),
    "node_batches": ("batch_occupancy.nodes", "iterations.nodes",
                     "host_loop_s.nodes", "replay_s.nodes"),
}
# no CUDA graphs on the CPU, so nothing to replay
NO_CPU_READING = {"replay_s.solve", "replay_s.nodes"}


def _run(root, cell, trace=True):
    return run_cell(root, cell, 2**31 + 17, 1.0, trace, torch.device("cpu"),
                    time.perf_counter())


def test_every_counter_metric_is_declared():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for kind, names in COUNTER_METRICS.items():
        cell = "mcf.solve" if kind == "solve" else "mcnd.nodes-b64"
        for name in names:
            m = per_layer[name]
            assert m["source"] == "program_counter"
            assert m["workloads"] == [cell]


@pytest.mark.parametrize("cell,kind", [(c[0], c[3]["kind"])
                                       for c in TINY_CELLS])
def test_a_traced_tiny_cell_reads_the_window_after_its_slice(tiny_root, cell,
                                                            kind):
    from ortools_tpu_torch.utils import tracing

    result, _ = _run(tiny_root, cell)
    assert result["correct"], result["check"]
    after = tracing.since_trace_end()
    metrics = result["metrics"]
    for name in COUNTER_METRICS[kind]:
        if name in NO_CPU_READING:
            assert name not in metrics
        else:
            assert math.isfinite(metrics[name]["value"]), name
    other = "node_batches" if kind == "solve" else "solve"
    assert not set(COUNTER_METRICS[other]) & set(metrics)
    units = result["window"]["units"]
    if kind == "solve":
        # every solve after the traced first one, and no warm-up solve
        assert after["problems_built"] == units - 1
        assert 0 < metrics["slot_use.solve"]["value"] <= 100
    else:
        batch = result["window"]["nodes"] // units
        # the traced batch counts its nodes at its end, after the slice or
        # (where it ended first) before it; the root batch never
        assert after["nodes_finished"] in (units * batch, (units - 1) * batch)
        assert metrics["iterations.nodes"]["value"] == pytest.approx(
            after["node_iterations"] / after["nodes_finished"])
        assert 0 < metrics["batch_occupancy.nodes"]["value"] <= 100


def test_set_up_alone_reads_nothing(tiny_root):
    """The warm-up solve and the root batch of set-up, in a process where
    no profiler has run: the program counted them, the readers see
    nothing."""
    code = (
        "import sys, json, torch; from pathlib import Path; "
        f"sys.path[:0] = [{str(tiny_root / 'benchmark')!r}, {str(ROOT)!r}]; "
        "from lpbench.spec import kind, load_cell; "
        "from ortools_tpu_torch.utils import tracing; "
        "out = []\n"
        "for name in ('tiny64.solve', 'tiny32.nodes'):\n"
        f"    cell = load_cell(Path({str(tiny_root)!r}), name)\n"
        "    kind(cell.bench_dir, cell.traffic['kind'])(cell, 5, "
        "torch.device('cpu')).setup()\n"
        "    out.append([tracing.since_trace_end(), tracing.counters(), "
        "tracing.before_trace()])\n"
        "print(json.dumps(out))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    (solve, nodes) = json.loads(out.stdout.strip().splitlines()[-1])
    assert solve[0] == {} and solve[1]["problems_built"] == 1
    # the root, in every row of the backend's batch
    batch = next(c[3]["batch"] for c in TINY_CELLS if c[0] == "tiny32.nodes")
    assert nodes[0] == {} and nodes[1]["nodes_finished"] == batch
    # no profiler has begun, so there is no start mark either
    assert solve[2] == {} and nodes[2] == {}


@pytest.mark.parametrize("name,kind", [("replay_s.solve", "solve"),
                                       ("replay_s.nodes", "node_batches")])
def test_replays_are_read_over_set_up(name, kind, monkeypatch):
    """The launches of set-up's majors, before the profiler first ran, and
    none of the window's after it: a process that has profiled launches
    graphs about ten times slower, even once the profiler has stopped."""
    from ortools_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "_recording", False)
    monkeypatch.setattr(tracing, "_at_start",
                        {"replay_seconds": 0.6, "majors": 2})
    monkeypatch.setattr(tracing, "_at_end",
                        {"replay_seconds": 8.0, "majors": 4})
    monkeypatch.setattr(tracing, "_counts",
                        {"replay_seconds": 38.0, "majors": 14})
    read = metric_reader(BENCH, name)
    assert read(types.SimpleNamespace(kind=kind)) == pytest.approx(0.3)
    other = "solve" if kind == "node_batches" else "node_batches"
    assert read(types.SimpleNamespace(kind=other)) is None
    monkeypatch.setattr(tracing, "_at_start", {"majors": 2})
    assert read(types.SimpleNamespace(kind=kind)) is None


def test_a_program_without_the_counters_leaves_them_out(tiny_root, tmp_path,
                                                        monkeypatch):
    """A program older than its counters, without ``utils/tracing.py``:
    the run goes on, and the eight metrics stay out of its line."""
    import ortools_tpu_torch.mip.node_lp  # noqa: F401 (the program first)
    import ortools_tpu_torch.utils as utils

    # the package as such a program has it: no tracing.py on its path
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.delitem(sys.modules, "ortools_tpu_torch.utils.tracing")
    monkeypatch.setattr(utils, "__path__", [str(tmp_path)])
    with pytest.raises(ImportError, match="cannot import name"):
        from ortools_tpu_torch.utils import tracing  # noqa: F401
    result, _ = _run(tiny_root, "tiny32.solve")
    assert result["correct"], result["check"]
    assert not {n for names in COUNTER_METRICS.values() for n in names} \
        & set(result["metrics"])
    assert "host_sync_share.solve" in result["metrics"]
