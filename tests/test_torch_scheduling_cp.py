"""The port's scheduling, FlatZinc and classic CP facade against the JAX
package's, on the CPU (``device="cpu"``).

- FlatZinc: each test of tests/test_flatzinc.py runs twice, once on the JAX
  package and once on the port (its ``solve_fzn_text``, ``parse_fzn``,
  ``FlatZincError`` and ``SolveStatus`` swapped in), and every solve gives
  the same status, objective and output text in both; ``main`` with
  ``--device cpu`` prints the same text.
- pywrapcp: each test of tests/test_pywrapcp.py runs the same way on the
  port's ``Solver(device="cpu")``, and ``Solve``, ``NextSolution`` and
  ``Value`` return the same in both.
- Scheduling: ft06, tests/test_scheduling_packing.py's small instances and
  RCPSP case on every route of ``solve_jobshop``, and the CDCL prover:
  the same makespan, optimality and starts, each schedule checked.
"""

import random

import pytest
import torch

from ortools_tpu import constraint_solver as JCS
from ortools_tpu.flatzinc import driver as JFZ
from ortools_tpu import scheduling as JSCH
from ortools_tpu.scheduling import rcpsp as JRC

from ortools_tpu_torch import constraint_solver as TCS
from ortools_tpu_torch.flatzinc import driver as TFZ
from ortools_tpu_torch import scheduling as TSCH
from ortools_tpu_torch.scheduling import rcpsp as TRC
from ortools_tpu_torch.utils.status import SolveStatus as TSolveStatus

from tests import test_flatzinc as FZ_TESTS
from tests import test_pywrapcp as PW_TESTS
from tests.test_scheduling_packing import (FT06, RCPSP_SM,
                                           _check_jobshop_solution)

torch.set_num_threads(1)


def _names(module) -> list:
    return sorted(n for n in dir(module) if n.startswith("test_"))


# ---------------------------------------------------------------------------
# FlatZinc
# ---------------------------------------------------------------------------


def _fz_recorder(solve_fzn_text, log, **kw):
    def solve_(text, *a, **k):
        r = solve_fzn_text(text, *a, **k, **kw)
        log.append((r.status.name, r.objective, r.text))
        return r
    return solve_


@pytest.mark.parametrize("name", _names(FZ_TESTS))
def test_flatzinc_case_as_the_jax_package(name, monkeypatch):
    test = getattr(FZ_TESTS, name)
    jax_log, port_log = [], []
    monkeypatch.setattr(FZ_TESTS, "solve_fzn_text",
                        _fz_recorder(JFZ.solve_fzn_text, jax_log))
    test()
    for attr, port in (("solve_fzn_text", _fz_recorder(
            TFZ.solve_fzn_text, port_log, device="cpu")),
            ("parse_fzn", TFZ.parse_fzn),
            ("FlatZincError", TFZ.FlatZincError),
            ("SolveStatus", TSolveStatus)):
        monkeypatch.setattr(FZ_TESTS, attr, port)
    test()
    assert port_log == jax_log


KNAPSACK_FZN = """\
array [1..5] of int: w = [3, 4, 5, 2, 6];
array [1..5] of int: v = [4, 5, 7, 3, 8];
array [1..5] of var 0..1: x :: output_array([1..5]);
var 0..24: value :: output_var;
constraint int_lin_le([3, 4, 5, 2, 6], [x[1], x[2], x[3], x[4], x[5]], 10);
constraint int_lin_eq([4, 5, 7, 3, 8, -1], [x[1], x[2], x[3], x[4], x[5], value], 0);
solve maximize value;
"""


def test_flatzinc_main_with_device_cpu(tmp_path, capsys):
    path = tmp_path / "k.fzn"
    path.write_text(KNAPSACK_FZN)
    assert JFZ.main([str(path)]) == 0
    jax_out = capsys.readouterr().out
    assert TFZ.main(["--device", "cpu", str(path)]) == 0
    port_out = capsys.readouterr().out
    assert port_out == jax_out
    assert port_out.rstrip().endswith("==========")
    assert "value = 14;" in port_out


# ---------------------------------------------------------------------------
# pywrapcp
# ---------------------------------------------------------------------------


def _recording_solver(base, log, **init_kw):
    class Recording(base):
        def __init__(self, name: str = "") -> None:
            super().__init__(name, **init_kw)

        def Solve(self, *a, **k):
            out = super().Solve(*a, **k)
            log.append(("Solve", out))
            return out

        def NextSolution(self):
            out = super().NextSolution()
            log.append(("NextSolution", out))
            return out

        def Value(self, v):
            out = super().Value(v)
            log.append(("Value", out))
            return out

    return Recording


@pytest.mark.parametrize("name", _names(PW_TESTS))
def test_pywrapcp_case_as_the_jax_package(name, monkeypatch):
    test = getattr(PW_TESTS, name)
    jax_log, port_log = [], []
    monkeypatch.setattr(PW_TESTS, "Solver",
                        _recording_solver(JCS.Solver, jax_log))
    test()
    monkeypatch.setattr(PW_TESTS, "Solver", _recording_solver(
        TCS.Solver, port_log, device="cpu"))
    test()
    assert port_log == jax_log


# ---------------------------------------------------------------------------
# Scheduling
# ---------------------------------------------------------------------------

SMALL = """\
3 3
0 3 1 2 2 2
0 2 2 1 1 4
1 4 2 3 0 1
"""


def _random_instance(trial: int) -> list:
    """tests/test_scheduling_packing.py::test_jobshop_cdcl_matches_cp_engine's
    4 x 4 instances."""
    rng = random.Random(3)
    for k in range(trial + 1):
        jobs = []
        for _ in range(4):
            machines = list(range(4))
            rng.shuffle(machines)
            jobs.append([(m, rng.randint(1, 9)) for m in machines])
    return jobs


INSTANCES = {"ft06": (FT06, 55), "small": (SMALL, 11)}


def _instance(pkg, name):
    if name.startswith("random"):
        return pkg.JobshopInstance(name, _random_instance(int(name[-1])))
    return pkg.parse_jobshop(INSTANCES[name][0], is_text=True, name=name)


def _jobshop(pkg, name, route, **kw):
    inst = _instance(pkg, name)
    if route == "cdcl_direct":
        sol = pkg.solve_jobshop_cdcl(inst, max_time_in_seconds=30.0)
    else:
        sol = pkg.solve_jobshop(inst, max_time_in_seconds=30.0,
                                engine=route, **kw)
    return inst, sol


@pytest.mark.parametrize("name", ["ft06", "small", "random0", "random1",
                                  "random2"])
@pytest.mark.parametrize("route", ["auto", "lcg", "cdcl", "cp",
                                   "cdcl_direct"])
def test_jobshop_as_the_jax_package(name, route):
    _, j = _jobshop(JSCH, name, route)
    inst, t = _jobshop(TSCH, name, route, **(
        {} if route == "cdcl_direct" else {"device": "cpu"}))
    assert t is not None and j is not None
    assert (t.makespan, t.optimal) == (j.makespan, j.optimal)
    assert t.optimal
    if name in INSTANCES:
        assert t.makespan == INSTANCES[name][1]
    assert t.starts == j.starts
    _check_jobshop_solution(inst, t)


def test_rcpsp_as_the_jax_package():
    j = JRC.solve_rcpsp(JRC.parse_rcpsp(RCPSP_SM, is_text=True),
                        max_time_in_seconds=20.0)
    inst = TRC.parse_rcpsp(RCPSP_SM, is_text=True)
    assert vars(inst) == vars(JRC.parse_rcpsp(RCPSP_SM, is_text=True))
    t = TRC.solve_rcpsp(inst, max_time_in_seconds=20.0, device="cpu")
    assert (t.makespan, t.optimal, t.starts) == (j.makespan, j.optimal,
                                                 j.starts)
    assert t.makespan == 9
    for i, succs in enumerate(inst.successors):
        for k in succs:
            assert t.starts[k] >= t.starts[i] + inst.durations[i]


def test_parse_jobshop_as_the_jax_package():
    for text in (FT06, SMALL):
        t = TSCH.parse_jobshop(text, is_text=True, name="x")
        j = JSCH.parse_jobshop(text, is_text=True, name="x")
        assert vars(t) == vars(j)
        assert (t.num_jobs, t.num_machines, t.horizon) == (
            j.num_jobs, j.num_machines, j.horizon)
