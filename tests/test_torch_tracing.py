"""The spans and counters of ``ortools_tpu_torch.utils.tracing`` inside the
PDLP layers, on the CPU: spans only while a ``torch.profiler`` session
records, nested as the layers are; counters always, split by the marks a
session leaves; and the batch's counts of its nodes against the same LPs
solved one at a time."""

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ortools_tpu_torch.models.lp import random_lp
from ortools_tpu_torch.pdlp import PdhgParams, solve
from ortools_tpu_torch.pdlp.batched import BatchSolver
from ortools_tpu_torch.utils import tracing

torch.set_num_threads(1)

P64 = PdhgParams(dtype=torch.float64)


def _change(before: dict) -> dict:
    after = tracing.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _pdlp_events(prof):
    return [e for e in prof.events() if e.name.startswith("pdlp::")]


def _within(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_without_a_profiler_records_nothing():
    assert isinstance(tracing.span("solve"), contextlib.nullcontext)
    solve(random_lp(20, 15, density=0.3, seed=1), P64, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not isinstance(tracing.span("solve"), contextlib.nullcontext)
    # the solve before the session left nothing in it
    assert _pdlp_events(prof) == []


def test_spans_nest_as_the_layers_do():
    qp = random_lp(30, 20, density=0.3, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = solve(qp, P64, device="cpu")
    events = _pdlp_events(prof)
    by = {}
    for e in events:
        by.setdefault(e.name[len("pdlp::"):], []).append(e)
    for name in ("solve", "host_prep", "rescale", "layout", "upload",
                 "power_iteration", "major", "read", "final"):
        assert name in by, (name, sorted(by))
    (top,) = by["solve"]
    (prep,) = by["host_prep"]
    assert _within(prep, top)
    for name in ("rescale", "layout", "upload"):
        (e,) = by[name]
        assert _within(e, prep)
    assert len(by["major"]) == r.iterations // P64.termination_check_frequency
    for read in by["read"]:
        assert any(_within(read, m) for m in by["major"])
    for e in events:
        assert _within(e, top)


def test_counts_fall_on_their_side_of_the_marks():
    tracing.count("test.before", 1)
    first = tracing.counters()["test.before"]
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("test.during", 2)
        tracing.count("test.before", 4)
    tracing.count("test.after", 3)
    at_start = tracing.before_trace()
    since = tracing.since_trace_end()
    assert at_start["test.before"] == first
    assert "test.during" not in at_start and "test.after" not in at_start
    assert since["test.after"] == 3
    assert since["test.during"] == 0 and since["test.before"] == 0
    assert tracing.counters()["test.before"] == first + 4


def test_a_process_whose_profiler_never_ended_reads_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "_at_start", None)
    monkeypatch.setattr(tracing, "_at_end", None)
    tracing.count("test.never", 1)
    assert tracing.since_trace_end() == {}
    assert tracing.before_trace() == {}


def test_a_solve_counts_its_majors_slots_and_set_up():
    qp = random_lp(30, 20, density=0.3, seed=3)
    before = tracing.counters()
    r = solve(qp, P64, device="cpu")
    c = _change(before)
    freq = P64.termination_check_frequency
    assert c["problems_built"] == 1 and c["rescale_seconds"] > 0
    assert c["majors"] == r.iterations // freq
    assert c["accepted"] == r.iterations <= c["slots"]
    # one gap fewer than majors, each shorter than the whole solve
    assert 0 < c["host_loop_seconds"] < r.solve_time_sec
    assert c.get("replay_seconds", 0) == 0  # no graphs on the CPU


def _batch():
    """Three LPs that differ in their variable bounds."""
    qp = random_lp(30, 20, density=0.3, seed=5)
    n = qp.num_variables
    rng = np.random.default_rng(0)
    lbs = np.zeros((3, n))
    ubs = np.full((3, n), 10.0)
    for i in (1, 2):
        ubs[i, rng.choice(n, 3 * i, replace=False)] = 0.0
    return qp, lbs, ubs


# 8 x 128 blocks: at the auto shape of so small an LP, one 128 x 128
# block, the plain SpMM's ``torch.bmm`` (``tiled_spmv.
# block_product_batched``) multiplies a single right-hand column as the
# CPU's BLAS does a matrix-vector product, whose sums run in another order
# than its matrix-matrix product at B >= 2 (an ulp a product); at 8 x 128
# every op of a row of a batch gives what it gives at B = 1.
P_BATCH = PdhgParams(dtype=torch.float64, block_shape=(8, 128))


@pytest.mark.parametrize("limit", [None, 128, 700])
def test_batch_counts_its_nodes_as_the_single_solves_do(limit):
    """Each node ends where it ends solved alone, at B = 1: proven (at
    1,664, 576 and 64 iterations, the last infeasible) or at the call's
    limit."""
    qp, lbs, ubs = _batch()
    alone = [BatchSolver(qp, P_BATCH, 1, device="cpu").solve(
        lbs[i:i + 1], ubs[i:i + 1], iteration_limit=limit).iterations
        for i in range(3)]
    solver = BatchSolver(qp, P_BATCH, 3, device="cpu")
    before = tracing.counters()
    r = solver.solve(lbs, ubs, iteration_limit=limit)
    c = _change(before)
    assert c["nodes_finished"] == 3
    assert c["node_iterations"] == sum(alone)
    assert r.iterations == max(alone)
    assert c["batch_instances"] == 3 * c["majors"]
    assert 0 < c["batch_open"] <= c["batch_instances"]
    assert c["accepted"] == 3 * r.iterations
    if limit is None:
        assert alone == [1664, 576, 64]
        assert (r.optimal | r.primal_infeasible).all()
        assert c["batch_open"] < c["batch_instances"]


def test_a_session_that_ends_in_a_batch_leaves_its_nodes_on_one_side():
    """A profiler session that stops in the middle of a batch, as the
    benchmark's traced slice does: the batch's majors split at the end
    mark, its open instances and its nodes fall after it whole."""
    qp, lbs, ubs = _batch()
    solver = BatchSolver(qp, P_BATCH, 3, device="cpu")
    solver.solve(lbs, ubs)  # the solver keeps its majors from here
    prof = profile(activities=[ProfilerActivity.CPU])
    major = solver.majors.major
    seen = []

    def stop_in_the_second(*args, **kwargs):
        seen.append(1)
        if len(seen) == 2:
            prof.stop()
        return major(*args, **kwargs)

    solver.majors.major = stop_in_the_second
    before = tracing.counters()
    prof.start()
    solver.solve(lbs, ubs)
    c = _change(before)
    after = tracing.since_trace_end()
    assert tracing.before_trace() == before
    assert c["majors"] > 2 and after["majors"] == c["majors"] - 1
    for name in ("batch_open", "batch_instances", "nodes_finished",
                 "node_iterations"):
        assert after[name] == c[name] > 0, name
    assert after["batch_instances"] == 3 * c["majors"]
    assert _pdlp_events(prof)


def test_batch_host_loop_is_timed_within_a_call():
    qp, lbs, ubs = _batch()
    solver = BatchSolver(qp, P_BATCH, 3, device="cpu")
    solver.solve(lbs, ubs)
    time.sleep(0.3)
    before = tracing.counters()
    solver.solve(lbs, ubs)
    c = _change(before)
    # the pause between the calls is no host loop of either
    assert c["host_loop_seconds"] < 0.3
    assert c["majors"] > 1
