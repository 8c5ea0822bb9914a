"""The port's branch-and-bound (``ortools_tpu_torch.mip.solve``) against the
JAX package's (``ortools_tpu.mip.solve``) on the CPU.

The port runs with ``device="cpu", lp_dtype=torch.float64``, the JAX
package under x64 (tests/conftest.py), on the cases of tests/test_mip.py
(knapsack seeds, a mixed-integer LP, binary random MIPs, an infeasible MIP,
a pure LP); tests/test_torch_mip_battery.py does the same for the four
families of tests/test_mip_battery.py.  Both must give the same status
and, where both prove optimality, objectives within 1e-9·(1+|obj|).  Both
take their ``node_lp="auto"`` route, which sends these small models to the
host simplex, and their heuristics end on the clock, so the node counts
are printed, not compared.

Two more cases run the PDHG node backend (``node_lp="pdhg"``, the batched
solve of ``pdlp/batched.py`` on the CPU) and are held to HiGHS within
1e-4·(1+|ref|).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.mip import MipParams as JMipParams, solve as jsolve
from ortools_tpu.models.lp import QuadraticProgram

from ortools_tpu_torch.mip import MipParams, solve
from ortools_tpu_torch.mip.node_lp import PdhgNodeBackend
from ortools_tpu_torch.pdlp import batched

from tests.test_mip import make_knapsack, milp_reference
from tests.test_mip_battery import fixed_charge_mip
from tests.test_torch_presolve import port_qp

torch.set_num_threads(1)


def _mixed_integer():
    rng = np.random.default_rng(7)
    n, m = 4, 6
    a = rng.standard_normal((m, n))
    x0 = rng.uniform(0, 3, size=n)
    b = a @ x0 + rng.uniform(0.2, 1.0, size=m)
    return QuadraticProgram(
        objective_vector=rng.standard_normal(n),
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=np.full(m, -np.inf),
        constraint_upper=b,
        variable_lower=np.zeros(n),
        variable_upper=np.full(n, 5.0),
        integrality=np.array([True, True, False, False]),
    )


def _binary_random(seed):
    rng = np.random.default_rng(11)
    for s in range(seed + 1):
        n, m = 10, 6
        a = sp.random(m, n, density=0.5,
                      random_state=np.random.RandomState(s))
        b = np.asarray(a.sum(axis=1)).ravel() * 0.5 + 0.5
        c = rng.standard_normal(n)
    return QuadraticProgram(
        objective_vector=c,
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=np.full(m, -np.inf),
        constraint_upper=b,
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.ones(n, dtype=bool),
    )


def _infeasible():
    return QuadraticProgram(
        objective_vector=np.ones(2),
        constraint_matrix=sp.csr_matrix(np.ones((1, 2))),
        constraint_lower=np.array([3.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.zeros(2),
        variable_upper=np.ones(2),
        integrality=np.ones(2, dtype=bool),
    )


def _pure_lp():
    rng = np.random.default_rng(3)
    n = 5
    return QuadraticProgram(
        objective_vector=rng.standard_normal(n),
        constraint_matrix=sp.csr_matrix(np.abs(rng.standard_normal((3, n)))),
        constraint_lower=np.full(3, -np.inf),
        constraint_upper=np.full(3, 10.0),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
        integrality=np.zeros(n, dtype=bool),
    )


# (name, instance, MipParams keywords): tests/test_mip.py's cases with
# their batch sizes.
CASES = (
    [(f"knapsack_{s}", lambda s=s: make_knapsack(seed=s),
      dict(node_batch_size=8)) for s in range(3)]
    + [("mixed_integer", _mixed_integer, dict(node_batch_size=4))]
    + [(f"binary_random_{s}", lambda s=s: _binary_random(s),
        dict(node_batch_size=16)) for s in range(3)]
    + [("infeasible", _infeasible, {}), ("pure_lp", _pure_lp, {})])


def assert_matches_jax(name, qp, kw):
    """The port's solve and the JAX package's, with the same params."""
    rj = jsolve(qp, JMipParams(**kw))
    rt = solve(port_qp(qp), MipParams(**kw), device="cpu",
               lp_dtype=torch.float64)
    print(f"{name}: {rt.status.name}, nodes port {rt.num_nodes} "
          f"JAX {rj.num_nodes}")
    assert rt.status.name == rj.status.name, name
    assert rt.solution.shape == rj.solution.shape
    if rj.status.name == "OPTIMAL":
        obj = rj.objective_value
        assert abs(rt.objective_value - obj) <= 1e-9 * (1 + abs(obj)), (
            name, rt.objective_value, obj)
        assert abs(rt.best_bound - rj.best_bound) <= 1e-9 * (1 + abs(obj))


@pytest.mark.parametrize("name,make,kw", CASES, ids=[c[0] for c in CASES])
def test_mip_solve_matches_jax(name, make, kw):
    assert_matches_jax(name, make(), kw)


PDHG_CASES = [
    ("knapsack_0_f64", lambda: make_knapsack(seed=0), torch.float64),
    ("fixed_charge_f32", fixed_charge_mip, torch.float32),
]


@pytest.mark.parametrize("name,make,dtype", PDHG_CASES,
                         ids=[c[0] for c in PDHG_CASES])
def test_pdhg_node_backend_solve_matches_highs(name, make, dtype,
                                               monkeypatch):
    qp = make()
    ref = milp_reference(qp)
    ref_obj = -ref.fun if qp.maximize else ref.fun
    batches = []
    backend_solve = PdhgNodeBackend.solve

    def counted(backend, lbs, *args, **kw):
        batches.append(lbs.shape[0])
        return backend_solve(backend, lbs, *args, **kw)

    monkeypatch.setattr(PdhgNodeBackend, "solve", counted)
    batched.solvers_built = 0
    r = solve(port_qp(qp), MipParams(node_lp="pdhg", node_batch_size=8),
              device="cpu", lp_dtype=dtype)
    print(f"{name}: {r.status.name} {r.objective_value!r} HiGHS "
          f"{ref_obj!r}, {r.num_nodes} nodes, {len(batches)} node-LP "
          f"batches, {batched.solvers_built} solvers built")
    assert r.status.name == "OPTIMAL"
    assert abs(r.objective_value - ref_obj) <= 1e-4 * (1 + abs(ref_obj))
    # every batch went through the PDHG backend, one solver per cut round
    assert batches and max(batches) <= 8
    assert 1 <= batched.solvers_built <= len(batches)
