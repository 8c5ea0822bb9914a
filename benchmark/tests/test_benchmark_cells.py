"""Each traffic kind end to end on the CPU through the program's public
entries, a cell added as files of its own, the measuring path's refusal to
run without a card, and the check for JAX before the result."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT, TINY_CELLS
from lpbench.device import forbidden_modules
from lpbench.runner import run_cell
from lpbench.spec import load_cell


def _run(root, cell, trace=False, seconds=1.0, seed=2**31 + 11):
    return run_cell(root, cell, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter())


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(tiny_root, cell, trace):
    result, lines = _run(tiny_root, cell, trace)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check"
    assert len(lines) == len(result["check"])
    spec = load_cell(tiny_root, cell)
    if trace:
        # no device here: the device readers find nothing and stay out
        names = {m["name"] for m in spec.per_layer}
        assert set(result["metrics"]) <= names
        assert result["breakdown"]["device_ops"] == []
    else:
        assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_every_seed_gives_the_same_work_in_another_order(tiny_root):
    """The node batches are the instance's, whatever the seed; the seed
    draws their order and the sampled nodes."""
    from lpbench.spec import kind

    cell = load_cell(tiny_root, "tiny32.nodes")
    pools, orders = [], []
    for seed in (2**31 + 3, 2**31 + 3, 2**31 + 4):
        mix = kind(cell.bench_dir, "node_batches")(cell, seed, "cpu")
        mix.setup()
        pools.append([a.tolist() for b in mix.pool for a in b])
        orders.append([mix.order.permutation(len(mix.pool)).tolist()
                       for _ in range(8)])
    assert pools[0] == pools[1] == pools[2]
    assert orders[0] == orders[1] != orders[2]


def test_a_new_config_is_a_new_cell_without_an_edit(tiny_root):
    """The tiny cells are files the fixture added and entries of
    BENCHMARK.json: every file the benchmark had is as it was."""
    before = {p.relative_to(BENCH): p.read_bytes()
              for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    for rel, data in before.items():
        assert (tiny_root / "benchmark" / rel).read_bytes() == data
    cell = load_cell(tiny_root, "tiny64.solve")
    assert cell.config["name"] == "tiny-open-f64"
    assert _run(tiny_root, "tiny64.solve")[0]["correct"]


def test_a_new_generator_kind_and_metric_are_files_of_their_own(tiny_root):
    """A generator, a traffic kind and an end-to-end metric that a later
    change adds, each as a new file found by its name, with no edit to a
    file the benchmark has."""
    bench = tiny_root / "benchmark"
    (bench / "reference" / "generators" / "box_lp.py").write_text(
        "import numpy as np\n"
        "from reference.lp import Instance\n"
        "def make(n, seed):\n"
        "    rng = np.random.default_rng(seed)\n"
        "    i = np.arange(n)\n"
        "    return Instance(m=n, n=n, rows=i, cols=i, vals=np.ones(n),\n"
        "                    c=rng.uniform(1, 2, n), con_lo=np.ones(n),\n"
        "                    con_hi=np.full(n, np.inf), var_lo=np.zeros(n),\n"
        "                    var_hi=np.full(n, 4.0), name='box',\n"
        "                    branch_columns=np.zeros(0, np.int64), data={})\n")
    (bench / "lpbench" / "kinds" / "solve_twice.py").write_text(
        "from lpbench.kinds import solve\n"
        "class Mix(solve.Mix):\n"
        "    kind = 'solve_twice'\n"
        "    def unit(self):\n"
        "        return super().unit() + super().unit()\n")
    (bench / "end_to_end" / "lp_pairs_per_s.py").write_text(
        "def read(run):\n    return run['passed'] / 2 / run['elapsed']\n")
    (bench / "configs" / "box.json").write_text(json.dumps(
        {"name": "box", "generator": "box_lp", "instance": {"n": 40},
         "params": {"dtype": "float64", "eps_optimal_absolute": 1e-8,
                    "eps_optimal_relative": 1e-8}, "reduced": []}))
    (bench / "traffic" / "twice.json").write_text(json.dumps(
        {"kind": "solve_twice", "pool": 2, "trace_seconds": 0.5}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "box.twice", "config": "box",
                              "traffic": "twice", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "lp_pairs_per_s", "unit": "pairs/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["box.twice"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = _run(tiny_root, "box.twice")
    assert result["correct"], result["check"]
    assert result["window"]["lps"] == 2 * result["window"]["units"]
    assert set(result["metrics"]) == {"setup_s", "lp_pairs_per_s"}


def test_measuring_path_refuses_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(BENCH))
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mcf.solve", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("ortools_tpu", True), ("ortools_tpu.pdlp.solver", True),
    ("ortools_tpu_torch", False), ("ortools_tpu_torch.pdlp", False),
    ("jax_utils", False), ("numpy", False)])
def test_forbidden_modules_compare_whole_top_level_names(name, bad):
    assert forbidden_modules([name]) == ([name] if bad else [])


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, time, torch; from pathlib import Path; "
        f"sys.path[:0] = [{str(tiny_root / 'benchmark')!r}, {str(ROOT)!r}]; "
        "from lpbench.runner import run_cell; "
        "from lpbench.device import loaded_forbidden; "
        f"r, _ = run_cell(Path({str(tiny_root)!r}), 'tiny32.nodes', 5, 0.5, True,"
        " torch.device('cpu'), time.perf_counter()); "
        "import json; print(json.dumps([r['correct'], loaded_forbidden()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_a_reader_that_loads_jax_leaves_no_result(tiny_root, tmp_path):
    """A per-layer reader that a later change adds, and that imports a
    module named ``jax``: the run prints no result and exits 3."""
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    bench = tiny_root / "benchmark"
    (bench / "metrics" / "planted.py").write_text(
        "def read(t):\n    import jax\n    return 1.0\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "planted", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "host set-up",
        "moves": "lp_solves_per_s", "workloads": ["tiny32.solve"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, time, torch; from pathlib import Path; "
        f"sys.path[:0] = [{str(fake)!r}, {str(bench)!r}, {str(ROOT)!r}]; "
        "import run; from lpbench.runner import run_cell; "
        f"r, lines = run_cell(Path({str(tiny_root)!r}), 'tiny32.solve', 5, 0.5,"
        " True, torch.device('cpu'), time.perf_counter()); "
        "assert 'planted' in r['metrics']; sys.exit(run.emit(r, lines))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "loaded jax" in out.stderr


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    import ast

    for f in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert forbidden_modules(names) == [], (f, names)
