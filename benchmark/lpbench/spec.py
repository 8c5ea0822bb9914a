"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

Every part that belongs to one configuration, traffic kind, generator or
metric is a file of its own, loaded by name, so that a later cell adds files
and edits none:

- ``configs/<config>.json`` and ``traffic/<mix>.json``: data;
- ``reference/generators/<generator>.py``: ``make(**instance, seed)`` and,
  where it has one, ``certificate(inst, closed)``;
- ``lpbench/kinds/<kind>.py``: the traffic driver ``Mix`` of a mix's
  ``kind``;
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: ``read``;
- ``kernels/<kernel>.json``: a kernel's name pattern and its work.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # and with --trace 1
    bench_dir: Path


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; a per-layer
    one without, in every cell that reports the metric it ``moves``; an
    end-to-end one without, in every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration and traffic files read."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bench_dir = root / spec["paths"][0]
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, config, traffic, e2e, per_layer, bench_dir)


_LOADED: Dict[Path, ModuleType] = {}


def load_file(bench_dir: Path, *parts: str) -> ModuleType:
    """The module of ``bench_dir/<parts>.py``, loaded from its file once."""
    path = bench_dir.joinpath(*parts[:-1], parts[-1] + ".py")
    if path not in _LOADED:
        name = "_bench_" + "_".join(parts).replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def generator(bench_dir: Path, name: str) -> ModuleType:
    return load_file(bench_dir, "reference", "generators", name)


def kind(bench_dir: Path, name: str):
    """The traffic driver class of the mix kind ``name``."""
    return load_file(bench_dir, "lpbench", "kinds", name).Mix


def end_to_end_reader(bench_dir: Path, name: str) -> Callable:
    return load_file(bench_dir, "end_to_end", name).read


def metric_reader(bench_dir: Path, name: str) -> Callable:
    return load_file(bench_dir, "metrics", name).read


def kernel_spec(bench_dir: Path, name: str) -> Dict:
    """``kernels/<name>.json``: the kernel-name pattern and its work."""
    return json.loads((bench_dir / "kernels" / f"{name}.json").read_text())
