"""The judgement's control and the faults it has to catch, at a size the
CPU holds: a run one precision below the configuration's, and runs with
the timed path broken underneath, each judged not correct.  The control at
each cell's own size runs on the card (``benchmark/control.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from lpbench.control import run_control
from lpbench.runner import run_cell


@pytest.mark.parametrize("cell", ["tiny64.solve", "tiny32.solve",
                                  "tiny32.nodes"])
def test_control_is_not_correct(tiny_root, cell):
    judged, lowered = run_control(tiny_root, cell, 2**31 + 7, 1.0,
                                  torch.device("cpu"))
    assert not judged.correct, (lowered, judged.numbers())


def _run(root, cell):
    return run_cell(root, cell, 2**31 + 9, 1.0, False, torch.device("cpu"),
                    0.0)[0]


@pytest.mark.parametrize("cell", ["tiny64.solve", "tiny32.nodes"])
def test_a_step_that_leaves_the_state_unchanged(tiny_root, monkeypatch, cell):
    """Every attempt is counted as accepted and writes nothing back."""
    from ortools_tpu_torch.pdlp import solver as S

    def commit(s, active, ends, attempts, trial, **fields):
        S._select_(s.state.num_steps, active, s.state.num_steps + 1)
        S._select_(s.state.num_accepted, ends, s.state.num_accepted + 1)
        S._select_(s.accepted, active, s.accepted + 1)

    monkeypatch.setattr(S, "_commit", commit)
    monkeypatch.setattr(S, "capture_seconds", 0.0)
    result = _run(tiny_root, cell)
    assert not result["correct"], result["check"]


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    """The backend solves the first half of each batch and hands its
    answers out for the other half too."""
    from ortools_tpu_torch.mip import node_lp

    solve = node_lp.PdhgNodeBackend.solve

    def half(self, lbs, ubs, warm_x=None, warm_y=None, **kw):
        res = solve(self, lbs, ubs, warm_x, warm_y, **kw)
        k = max(1, len(lbs) // 2)
        idx = np.arange(len(lbs)) % k
        return dataclasses.replace(
            res, **{f.name: getattr(res, f.name)[idx]
                    for f in dataclasses.fields(res)})

    monkeypatch.setattr(node_lp.PdhgNodeBackend, "solve", half)
    result = _run(tiny_root, "tiny32.nodes")
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", ["tiny64.solve", "tiny32.solve"])
def test_an_answer_altered_where_it_is_produced_solve(tiny_root, monkeypatch,
                                                      cell):
    from ortools_tpu_torch import pdlp

    solve = pdlp.solve

    def altered(*args, **kw):
        res = solve(*args, **kw)
        x = res.primal_solution.copy()
        x[np.argmax(x)] *= 1.01
        return dataclasses.replace(res, primal_solution=x)

    monkeypatch.setattr(pdlp, "solve", altered)
    result = _run(tiny_root, cell)
    assert not result["correct"], result["check"]


def test_an_answer_altered_where_it_is_produced_nodes(tiny_root, monkeypatch):
    from ortools_tpu_torch.mip import node_lp

    solve = node_lp.PdhgNodeBackend.solve

    def altered(self, *args, **kw):
        res = solve(self, *args, **kw)
        y = res.dual_solution.copy()
        y[:, np.argmax(np.abs(y[0]))] *= 1.01
        return dataclasses.replace(res, dual_solution=y)

    monkeypatch.setattr(node_lp.PdhgNodeBackend, "solve", altered)
    result = _run(tiny_root, "tiny32.nodes")
    assert not result["correct"], result["check"]


def test_a_feasible_node_claimed_infeasible(tiny_root, monkeypatch):
    """The backend says of every node it proved optimal that it is
    infeasible: the reference's own decision finds the claims wrong."""
    from ortools_tpu_torch.mip import node_lp

    solve = node_lp.PdhgNodeBackend.solve

    def claimed(self, *args, **kw):
        res = solve(self, *args, **kw)
        return dataclasses.replace(
            res, primal_infeasible=res.primal_infeasible | res.optimal,
            optimal=np.zeros_like(res.optimal))

    monkeypatch.setattr(node_lp.PdhgNodeBackend, "solve", claimed)
    result = _run(tiny_root, "tiny32.nodes")
    assert not result["correct"], result["check"]
    assert result["check"]["wrong_infeasible"]["value"] > 0
