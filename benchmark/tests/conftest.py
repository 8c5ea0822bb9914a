"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with tiny cells added as a later change would add
them, as files of their own and entries of ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# The tests run beside other test processes: one solve a thread or two.
torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

def tiny_instance(form: str) -> dict:
    return {"num_nodes": 8, "num_arcs": 24, "num_commodities": 6,
            "form": form, "demand": [5.0, 50.0], "cost": [1.0, 10.0],
            "fixed_cost": [200.0, 800.0], "capacity": [1.0, 4.0]}


F64 = {"dtype": "float64", "eps_optimal_absolute": 1e-8,
       "eps_optimal_relative": 1e-8, "iteration_limit": 20000,
       "time_sec_limit": 60.0}
F32 = {"dtype": "float32", "eps_optimal_absolute": 1e-4,
       "eps_optimal_relative": 1e-4, "iteration_limit": 20000,
       "time_sec_limit": 60.0}
TINY_CONFIGS = {
    "tiny-open-f64": ("all_open", F64),
    "tiny-open-f32": ("all_open", F32),
    "tiny-relax-f32": ("relaxation", F32),
}
# (cell, config, traffic file, traffic)
TINY_CELLS = [
    ("tiny64.solve", "tiny-open-f64", "solve-tiny",
     {"kind": "solve", "pool": 3, "trace_seconds": 0.5}),
    ("tiny32.solve", "tiny-open-f32", "solve-tiny",
     {"kind": "solve", "pool": 3, "trace_seconds": 0.5}),
    ("tiny32.nodes", "tiny-relax-f32", "nodes-tiny",
     {"kind": "node_batches", "batch": 8, "pool_batches": 2, "close_min": 2,
      "close_max": 8, "sample": 8, "infeasible_sample": 8, "trace_seconds": 0.5}),
]


def add_tiny_cells(root: Path) -> None:
    bench = root / "benchmark"
    for name, (form, params) in TINY_CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "generator": "mcnd_c",
             "instance": tiny_instance(form), "params": params,
             "reduced": []}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for cell, config, mix, traffic in TINY_CELLS:
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": mix, "chips": 1, "why": "test"})
        node = traffic["kind"] == "node_batches"
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and (
                    ("mcnd.nodes-b64" if node else "mcf.solve")
                    in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def tiny_root(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny_cells(tmp_path)
    return tmp_path
