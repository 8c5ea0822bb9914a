"""The reference's instances, certificate, feasibility decision and
judgement, on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import BENCH, tiny_instance
from lpbench import instances
from reference import feasibility, kkt
from reference.generators import mcnd_c


def _config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,m,n,nnz", [
    ("mcnd-c-30-700-400-open-f64", 30 * 400 + 700, 700 * 400, 3 * 700 * 400),
    ("mcnd-c-30-520-100-relax-f32", 30 * 100 + 520 + 520 * 100,
     520 * 100 + 520, 5 * 520 * 100 + 520)])
def test_configurations_have_the_instances_published_sizes(name, m, n, nnz):
    inst = mcnd_c.make(**_config(name)["instance"], seed=1)
    assert (inst.m, inst.n, inst.nnz) == (m, n, nnz)
    a = inst.data
    assert len(set(zip(a["tails"], a["heads"]))) == a["A"]  # distinct arcs
    assert not np.any(a["tails"] == a["heads"])
    assert len(set(zip(a["src"], a["dst"]))) == a["K"]


@pytest.mark.parametrize("form", ["all_open", "relaxation"])
@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_certificate_meets_every_row_and_bound(form, seed):
    inst = mcnd_c.make(**tiny_instance(form) | {"num_nodes": 12,
                                                "num_arcs": 60}, seed=seed)
    x = mcnd_c.certificate(inst)
    assert x is not None
    r = kkt.judge(inst, x, np.zeros(inst.m), inst.var_lo, inst.var_hi,
                  1e-12, 1e-12, 2.0**-53)
    assert r["primal_res"] == 0.0


def test_a_closed_arc_carries_nothing_in_the_relaxation():
    """Closing an arc's design (its upper bound 0) forces every flow on it
    to 0 through the forcing rows."""
    inst = mcnd_c.make(**tiny_instance("relaxation"), seed=3)
    x = mcnd_c.certificate(inst)
    used = np.nonzero(x[: inst.data["K"] * inst.data["A"]]
                      .reshape(inst.data["K"], -1).any(axis=0))[0]
    ub = inst.var_hi.copy()
    ub[inst.branch_columns[used[:1]]] = 0.0
    r = kkt.judge(inst, x, np.zeros(inst.m), inst.var_lo, ub, 1e-12, 1e-12,
                  2.0**-53)
    assert r["primal_res"] > 1.0
    x2 = x.copy()
    x2[inst.branch_columns[used[:1]]] = 0.0
    r = kkt.judge(inst, x2, np.zeros(inst.m), inst.var_lo, ub, 1e-12, 1e-12,
                  2.0**-53)
    assert r["primal_res"] > 1.0  # the flow on it breaks a forcing row


@pytest.mark.parametrize("closed,want", [("none", True), ("all", False)])
def test_feasibility_decides_without_the_program(closed, want):
    inst = mcnd_c.make(**tiny_instance("relaxation"), seed=5)
    shut = (np.zeros(0, np.int64) if closed == "none"
            else np.arange(inst.branch_columns.size))
    ub = inst.var_hi.copy()
    ub[inst.branch_columns[shut]] = 0.0
    assert feasibility.is_feasible(inst, inst.var_lo, ub) is want
    assert feasibility.is_feasible(inst, inst.var_lo, ub, mcnd_c.certificate,
                                   shut) is want


@pytest.mark.parametrize("form", ["all_open", "relaxation"])
def test_judge_reads_an_optimal_pair_and_a_perturbed_one(form):
    """A PDHG solve of the program at float64 meets the ratios, and its
    Lagrangian bound is the reference's; the same answer with one flow
    moved does not meet them."""
    import torch

    from ortools_tpu_torch import pdlp
    from ortools_tpu_torch.pdlp.params import PdhgParams

    inst = mcnd_c.make(**tiny_instance(form), seed=3)
    res = pdlp.solve(instances.to_program(inst),
                     PdhgParams(dtype=torch.float64, eps_optimal_absolute=1e-8,
                                eps_optimal_relative=1e-8), device="cpu")
    r = kkt.judge(inst, res.primal_solution, res.dual_solution, inst.var_lo,
                  inst.var_hi, 1e-8, 1e-8, 2.0**-53)
    assert max(r["primal_res"], r["dual_res"], r["gap"]) <= 1.0
    assert np.isfinite(r["lagrangian"])  # every variable is boxed
    x = res.primal_solution.copy()
    x[np.argmax(x)] *= 1.01
    r = kkt.judge(inst, x, res.dual_solution, inst.var_lo, inst.var_hi,
                  1e-8, 1e-8, 2.0**-53)
    assert r["primal_res"] > 1.0


def test_lagrangian_bound_is_below_the_objective():
    inst = mcnd_c.make(**tiny_instance("relaxation"), seed=5)
    x = mcnd_c.certificate(inst)
    rng = np.random.default_rng(0)
    y = rng.normal(size=inst.m)
    k_n = inst.data["K"] * inst.data["N"]
    y[k_n:] = -np.abs(y[k_n:])  # the <= rows take duals <= 0
    r = kkt.judge(inst, x, y, inst.var_lo, inst.var_hi, 1e-6, 1e-6, 2.0**-53)
    assert r["lagrangian"] <= inst.c @ x
