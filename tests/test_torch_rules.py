"""Rules of the PyTorch port that no functional test would catch."""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ortools_tpu_torch  # noqa: F401  (sets the precision pins)
from ortools_tpu_torch import cli, math_opt, mip
from ortools_tpu_torch._native import build as native_build
from ortools_tpu_torch.algorithms import KnapsackSolver, SetCoverModel
from ortools_tpu_torch.algorithms.knapsack import dp_knapsack_torch
from ortools_tpu_torch.algorithms.set_cover import solve_set_cover_mip
from ortools_tpu_torch.bop import IntegralSolver
from ortools_tpu_torch.bop.portfolio import solve_boolean_lp
from ortools_tpu_torch.graft_entry import dryrun_multichip, start_ranks
from ortools_tpu_torch.linear_solver import Model, Solver
from ortools_tpu_torch.mip.node_lp import PdhgNodeBackend
from ortools_tpu_torch.models.lp import random_lp
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix
from ortools_tpu_torch.packing import BinPackingInstance, solve_bin_packing
from ortools_tpu_torch.packing.arc_flow import solve_vector_bin_packing
from ortools_tpu_torch.parallel import make_mesh
from ortools_tpu_torch.pdlp import PdhgParams, solve
from ortools_tpu_torch.pdlp.batched import solve_batch
from ortools_tpu_torch.sat import CpModel, CpSolver, cdcl, lcg, pb_solver
from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.fj_device import device_feasibility_jump
from ortools_tpu_torch.sat.max_hs import minimize_max_hs
from ortools_tpu_torch.sat import runner
from ortools_tpu_torch.sat.solver import solve_model
from ortools_tpu_torch.graph.tsp_paths import christofides_tsp
from ortools_tpu_torch.routing import RoutingIndexManager, RoutingModel
from ortools_tpu_torch.routing.breaks import schedule_route_with_breaks
from ortools_tpu_torch.scheduling import parse_jobshop, solve_jobshop
from ortools_tpu_torch.scheduling.rcpsp import RcpspInstance, solve_rcpsp
from ortools_tpu_torch import constraint_solver
from ortools_tpu_torch.flatzinc import driver as flatzinc_driver
from ortools_tpu_torch.flatzinc import solve_fzn_text

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ortools_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_spmm_probe.py",
    ROOT / "scripts" / "torch_mip_probe.py",
    ROOT / "scripts" / "torch_mesh_probe.py",
    ROOT / "scripts" / "torch_bench_probe.py", ROOT / "bench_torch.py",
    ROOT / "bench_large_torch.py", ROOT / "bench_miplib_torch.py"] + sorted(
    (ROOT / "examples_torch").glob("*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ortools_tpu"), (path, mod)


def test_entry_points_raise_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    qp = random_lp(10, 10, density=0.3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(qp, PdhgParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockSparseMatrix.from_scipy(qp.constraint_matrix)
    lbs = np.tile(qp.variable_lower, (2, 1))
    ubs = np.tile(qp.variable_upper, (2, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_batch(qp, lbs, ubs, PdhgParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PdhgNodeBackend(qp, PdhgParams(), 2).solve(lbs, ubs)
    qp.integrality = np.ones(qp.num_variables, dtype=bool)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mip.solve(qp, mip.MipParams())
    a = np.ones((2, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_feasibility_jump(a, np.ones(2), np.full(2, np.inf))
    # the mesh and the multi-device dry run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        start_ranks(1, print)
    # the front end
    model = Model.from_qp(random_lp(10, 10, density=0.3, seed=0))
    for backend in ("pdlp", "mip"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Solver(backend).solve(model)
    mo = math_opt.Model()
    x = mo.add_variable(lb=0, ub=1)
    mo.maximize(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        math_opt.solve(mo, math_opt.SolverType.PDLP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp_knapsack_torch([1, 2], [1, 1], 2)
    ks = KnapsackSolver(KnapsackSolver.KNAPSACK_MULTIDIMENSION_CBC_MIP_SOLVER)
    ks.init([3, 4], [[1, 2], [2, 1]], [2, 2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ks.solve()
    cover = SetCoverModel()
    cover.add_empty_subset(1.0)
    cover.add_element_to_last_subset(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_set_cover_mip(cover)
    # the host front ends around mip.solve (FFD settles the first packing:
    # the device is checked before it)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_bin_packing(BinPackingInstance(10, [6, 4]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_vector_bin_packing([6], [[3]], [4])
    qp01 = random_lp(4, 6, density=0.5, seed=0)
    qp01.integrality = np.ones(6, dtype=bool)
    qp01.variable_lower, qp01.variable_upper = np.zeros(6), np.ones(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IntegralSolver().solve(qp01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_boolean_lp(qp01)
    maxsat = ir.CpModelIR(
        variables=[ir.IntegerVariableIR("x", ir.Domain(0, 1))],
        constraints=[ir.ConstraintIR("bool_or", ir.BoolArgs([0]))],
        objective=ir.ObjectiveIR(vars=[0], coeffs=[1]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        minimize_max_hs(maxsat)
    # CP-SAT: the device is resolved before any work, on every route
    cp = CpModel()
    cp.add_bool_or([cp.new_bool_var("x")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CpSolver().solve(cp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_model(cp.ir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_model(maxsat)
    # routing and the graph algorithms that reach CP-SAT or mip.solve
    mgr = RoutingIndexManager(4, 1, 0)
    routing = RoutingModel(mgr)
    routing.set_arc_cost_evaluator_of_all_vehicles(
        routing.register_transit_callback(lambda a, b: abs(a - b)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        routing.solve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        schedule_route_with_breaks(routing, [1, 2, 3], "T", [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        christofides_tsp(np.ones((4, 4)) - np.eye(4))
    # the CLI without --device: a non-zero exit with the same message, and
    # nothing solved
    path = tmp_path / "m.mps"
    path.write_text(model.export_to_mps_string())
    assert cli.main(["solve", "--input", str(path)]) != 0
    out = capsys.readouterr()
    assert "device='cpu'" in out.err and "Status" not in out.out
    # the CP-SAT runner without --device: exit code 2, nothing solved
    wcnf = tmp_path / "m.wcnf"
    wcnf.write_text("p wcnf 1 1 10\n3 1 0\n")
    with pytest.raises(SystemExit) as exc:
        runner.main([str(wcnf)])
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert "device='cpu'" in out.err and "Status" not in out.out
    # scheduling, the classic CP facade and FlatZinc: on every route,
    # the host engines' too
    ft = parse_jobshop("2 2\n0 3 1 2\n1 4 0 1\n", is_text=True)
    for engine in ("auto", "lcg", "cdcl", "cp"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solve_jobshop(ft, engine=engine)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_rcpsp(RcpspInstance("", 1, [1], [0, 2], [[0], [1]], [[1], []]))
    classic = constraint_solver.Solver("s")
    cx = classic.IntVar(0, 2, "x")
    classic.Add(cx >= 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classic.Solve(classic.Phase([cx]))
    fzn = tmp_path / "m.fzn"
    fzn.write_text("var 1..3: x :: output_var;\nsolve satisfy;\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_fzn_text(fzn.read_text())
    # the FlatZinc command line without --device: exit code 2, nothing
    # solved
    with pytest.raises(SystemExit) as exc:
        flatzinc_driver.main([str(fzn)])
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert "device='cpu'" in out.err and "x = " not in out.out
    # an example's main, and its command line
    example = ROOT / "examples_torch" / "simple_sat_program.py"
    spec = importlib.util.spec_from_file_location("simple_sat", example)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()
    proc = subprocess.run([sys.executable, str(example)], cwd=ROOT,
                          capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert "x = " not in proc.stdout
    # the bench scripts and the CLI's bench: exit code 2, nothing measured
    # (a script's main resolves the card before any work)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    for script in ("bench_torch", "bench_large_torch", "bench_miplib_torch"):
        mod = importlib.import_module(script)
        with pytest.raises(SystemExit) as exc:
            mod.main()
        assert exc.value.code == 2, script
        out = capsys.readouterr()
        assert "device='cpu'" in out.err and out.out == "", script
    assert cli.main(["bench"]) == 2
    out = capsys.readouterr()
    assert "device='cpu'" in out.err and out.out == ""


def test_cdcl_library_builds_outside_the_source_tree():
    lib = cdcl._lib()
    path = native_build.library_path("cdcl")
    assert path.exists() and path.parent == native_build.OUT_DIR
    assert native_build.OUT_DIR == ROOT / "build" / "native"
    assert lib is native_build.load_library("cdcl")
    src_dir = ROOT / "ortools_tpu_torch" / "_native"
    assert not list(src_dir.glob("*.so"))


@pytest.mark.parametrize("name,load", [("lcg", lcg._lib),
                                       ("pbsat", pb_solver._lib)])
def test_cp_sat_native_cores_build_outside_the_source_tree(name, load):
    lib = load()
    path = native_build.library_path(name)
    assert path.exists() and path.parent == native_build.OUT_DIR
    assert lib is native_build.load_library(name)
    src_dir = ROOT / "ortools_tpu_torch" / "_native"
    assert not list(src_dir.glob("*.so"))


def test_cp_sat_portfolio_solves_as_jax_does():
    """num_workers > 1 reaches the portfolio (sat/solver.py's
    _solve_portfolio): interleaved and forked, the port's answer is the
    JAX package's on the same model, and the single worker's."""
    from ortools_tpu.sat import CpModel as JCpModel, CpSolver as JCpSolver

    out = []
    for model_cls, solver in ((JCpModel, JCpSolver()),
                              (CpModel, CpSolver(device="cpu"))):
        m = model_cls()
        x = m.new_int_var(0, 10, "x")
        y = m.new_int_var(0, 10, "y")
        m.add(x + 2 * y <= 14)
        m.maximize(3 * x + 4 * y)
        for workers, interleave in ((2, True), (2, False), (1, True)):
            solver.parameters.num_workers = workers
            solver.parameters.interleave_search = interleave
            out.append((solver.solve(m).name, solver.objective_value))
    assert out[:3] == out[3:]
    assert set(out) == {("OPTIMAL", 38)}


def test_port_file_list_covers_the_cp_sat_modules():
    names = {str(p.relative_to(ROOT / "ortools_tpu_torch"))
             for p in PORT_FILES if "ortools_tpu_torch" in p.parts}
    for rel in ("sat/cp_model.py", "sat/solver.py", "sat/engine.py",
                "sat/presolve.py", "sat/lcg.py", "sat/pb_solver.py",
                "sat/lp_propagator.py", "algorithms/symmetry.py",
                "utils/logging_util.py", "sat/portfolio.py",
                "sat/parallel_portfolio.py", "sat/runner.py",
                "sat/sat_io.py", "sat/serialization.py", "sat/drat.py",
                "graph/max_flow.py", "graph/min_cost_flow.py",
                "graph/shortest_paths.py", "graph/assignment.py",
                "graph/components.py", "graph/tsp_paths.py",
                "routing/model.py", "routing/sat_path.py",
                "routing/breaks.py", "routing/lp_scheduling.py",
                "routing/parsers.py", "routing/index_manager.py",
                "models/lp_format.py", "models/lp_decomposer.py",
                "scheduling/__init__.py", "scheduling/jobshop.py",
                "scheduling/rcpsp.py", "flatzinc/__init__.py",
                "flatzinc/__main__.py", "flatzinc/driver.py",
                "constraint_solver/__init__.py",
                "constraint_solver/pywrapcp.py", "utils/timers.py",
                "utils/stats.py", "utils/interrupt.py"):
        assert rel in names, rel
    examples = {p.name for p in PORT_FILES if "examples_torch" in p.parts}
    assert len(examples) == 9, examples


def test_tf32_is_off_and_matmul_precision_highest():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_solve_runs_when_asked():
    qp = random_lp(10, 10, density=0.3, seed=0)
    r = solve(qp, PdhgParams(dtype=torch.float64), device="cpu")
    assert r.termination_reason.name == "OPTIMAL"
    assert np.all(np.isfinite(r.primal_solution))
