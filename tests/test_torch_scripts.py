"""The port's scripts (``scripts/*_torch.py``) against the JAX package's
scripts of the same name without ``_torch``, on the CPU at small sizes.

The device scripts' ``main`` runs on the card only; their functions take
``device`` and run here with ``device="cpu"`` (the kernel wrappers then
run their plain versions).  Where a JAX script computes a quantity inside
its ``main`` or a benchmark function, that function is run here with its
solver calls replaced by stand-ins that record their arguments (and its
``open`` by one that writes under the test's temporary directory), so
the JAX script's own code makes the reference; nothing under
``scripts/`` or ``ortools_tpu/`` is edited.  Each JSON object's keys are
held against the dict literals of the JAX script (read with ``ast``).

Solves are compared by the parity rules: the same status and iteration
counts within a quarter of each other.
"""

import ast
import importlib
import json
import math
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ortools_tpu.glop.simplex
import ortools_tpu.pdlp
import ortools_tpu.pdlp.batched
import ortools_tpu.sat.feasibility_jump
import ortools_tpu.sat.fj_device
from ortools_tpu.models.generators import (
    multicommodity_flow_lp as jmulticommodity_flow_lp)
from ortools_tpu.ops.block_sparse import auto_block_shape as jauto_block_shape
from ortools_tpu.pdlp import solver as J
from ortools_tpu.pdlp.params import PdhgParams as JParams

from ortools_tpu_torch.models.generators import multicommodity_flow_lp
from ortools_tpu_torch.pdlp import PdhgParams, solve
from ortools_tpu_torch.pdlp.batched import solve_batch

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
# the scripts' own directory on the path: the spawned mesh ranks import
# bench_multichip_large_torch by name
for _p in (str(ROOT), str(SCRIPTS)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CPU = torch.device("cpu")


def port(name: str):
    return importlib.import_module(f"{name}_torch")


def jax_script(name: str):
    return importlib.import_module(name)


def dict_keys(name: str, where: str) -> list:
    """The keys of the dict literal that ``where`` names in the JAX script
    ``name``: ``"out"`` (an assignment to ``out``) or a function's name
    (its returned dict)."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (where == "out" and isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "out" for t in node.targets)
                and isinstance(node.value, ast.Dict)):
            return [k.value for k in node.value.keys]
        if isinstance(node, ast.FunctionDef) and node.name == where:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and isinstance(sub.value,
                                                              ast.Dict):
                    return [k.value for k in sub.value.keys]
    raise AssertionError(f"no dict for {where} in {name}.py")


def same_qp(a, b) -> None:
    """Two QuadraticPrograms (one of each package) equal bit for bit."""
    for f in ("objective_vector", "constraint_lower", "constraint_upper",
              "variable_lower", "variable_upper"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    ca, cb = sp.csr_matrix(a.constraint_matrix), sp.csr_matrix(
        b.constraint_matrix)
    assert ca.shape == cb.shape
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f), f)
    assert a.name == b.name and a.maximize == b.maximize


def within_a_quarter(ours: int, ref: int) -> bool:
    return abs(ours - ref) <= 0.25 * ref


def fake_card(monkeypatch, mod, tmp_path) -> dict:
    """A device script's ``main`` on the CPU: the device resolves to the
    CPU, the card's name and limit are stand-ins, and the JSON goes under
    ``tmp_path``.  Returns what ``save_json`` was given."""
    saved = {}
    monkeypatch.setattr(mod, "resolve_device_or_exit", lambda d, p: CPU)
    monkeypatch.setattr(mod, "card", lambda: ("a card, 1.00 W", 1.0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d=None: 0)
    monkeypatch.setattr(mod, "save_json",
                        lambda stem, out: saved.update({stem: out}))
    return saved


def last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# bench_roofline
# ---------------------------------------------------------------------------


def jax_roofline_fit(results, bytes_per_iter):
    """bench_roofline.py:59-66's fit, on the same samples."""
    ns = np.array([n for n, _ in results[1:]], dtype=np.float64)
    ts = np.array([t for _, t in results[1:]], dtype=np.float64)
    A = np.stack([np.ones_like(ns), ns], axis=1)
    (fixed, per_iter), *_ = np.linalg.lstsq(A, ts, rcond=None)
    n1, t1 = results[0]
    return (fixed, per_iter, bytes_per_iter / per_iter / 1e9,
            bytes_per_iter * n1 / t1 / 1e9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roofline_fit_equals_the_jax_scripts(seed):
    R = port("bench_roofline")
    rng = np.random.default_rng(seed)
    per, fixed = rng.uniform(2e-4, 4e-4), rng.uniform(1e-5, 1e-3)
    results = [(n, fixed + per * n * rng.uniform(0.98, 1.02))
               for n in R.ITERS]
    f, p = R.fit(results)
    jf, jp, jgbs, jsingle = jax_roofline_fit(results, 12 * R.N_ELEMS)
    np.testing.assert_allclose([f, p], [jf, jp], rtol=1e-12)
    out = R.record(results, R.N_ELEMS, ["card"], "card", 700.0)
    assert out["fixed_overhead_ms"] == round(jf * 1e3, 2)
    assert out["per_iteration_us"] == round(jp * 1e6, 2)
    assert out["in_dispatch_gb_per_s"] == round(jgbs, 1)
    assert out["single_dispatch_gb_per_s"] == round(jsingle, 1)
    assert out["fraction_of_paper_peak"] == round(jgbs / 3350, 3)
    want = [k if k != "v5e_paper_peak_gb_per_s" else "h100_peak_gb_per_s"
            for k in dict_keys("bench_roofline", "out")]
    assert list(out) == want + ["device", "power_limit_w"]
    assert out["h100_peak_gb_per_s"] == 3350


@pytest.mark.parametrize("n_iters", [1, 16])
def test_roofline_steps_equal_the_jax_body(n_iters):
    """N steps on 4,096 f32 elements against bench_roofline.py's body,
    ``x * (1 + 1e-9 i) + y``, in f32: one rounding apart a step at most
    (torch may fuse the multiply and the add)."""
    import jax

    R = port("bench_roofline")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096, dtype=np.float32)
    y0 = rng.standard_normal(4096, dtype=np.float32)

    def body(i, y):
        a = (1.0 + 1e-9 * i).astype(jnp.float32)
        return jnp.asarray(x) * a + y

    ref = np.asarray(jax.lax.fori_loop(0, n_iters, body, jnp.asarray(y0)))
    xt, y = torch.from_numpy(x), torch.from_numpy(y0.copy())
    R.steps(xt, y, n_iters)
    assert y.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=2 * n_iters * 2.0**-23 * scale)
    # best_sec times the same steps from y0
    y2 = torch.empty_like(y)
    R.best_sec(xt, torch.from_numpy(y0), y2, n_iters, reps=2)
    assert torch.equal(y2, y)


def test_roofline_main_prints_the_keys(monkeypatch, tmp_path, capsys):
    R = port("bench_roofline")
    saved = fake_card(monkeypatch, R, tmp_path)
    monkeypatch.setattr(R, "N_ELEMS", 4096)
    assert R.main() == 0
    out = last_json(capsys)
    assert saved["bench_roofline_torch"] == out
    assert out["devices"] == ["card"] and out["device"] == "card"
    assert out["power_limit_w"] == 1.0
    assert [s["iters"] for s in out["samples"]] == [1, 16, 64, 256]


# ---------------------------------------------------------------------------
# bench_lp_suite_batch
# ---------------------------------------------------------------------------


def test_lp_suite_equals_the_jax_scripts():
    L, JL = port("bench_lp_suite_batch"), jax_script("bench_lp_suite_batch")
    ours, theirs = L.build_suite(), JL.build_suite()
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        same_qp(a, b)


def run_jax_suite_main(monkeypatch, tmp_path, x_of):
    """bench_lp_suite_batch.py's main with its solve replaced: returns
    (the stacked QP it built and the parameters it gave, the JSON it
    wrote).  The stand-in's x is ``x_of(stacked QP)``."""
    JL = jax_script("bench_lp_suite_batch")
    seen = {}

    def fake_solve(qp, params):
        seen["qp"], seen["params"] = qp, params
        return types.SimpleNamespace(
            primal_solution=x_of(qp), iterations=7,
            termination_reason=types.SimpleNamespace(
                name="PRIMAL_INFEASIBLE"))

    monkeypatch.setattr(ortools_tpu.pdlp, "solve", fake_solve)
    written = tmp_path / "lpsuite.json"
    monkeypatch.setattr(JL, "open", lambda path, mode: open(written, mode),
                        raising=False)
    JL.main()
    monkeypatch.undo()
    return seen, json.loads(written.read_text())


def suite_x(qp):
    """A point inside the stack's bounds, from seed 0."""
    rng = np.random.default_rng(0)
    lo = np.where(np.isfinite(qp.variable_lower), qp.variable_lower, -5.0)
    hi = np.where(np.isfinite(qp.variable_upper), qp.variable_upper, 5.0)
    return lo + (hi - lo) * rng.random(qp.num_variables)


def test_lp_suite_stack_and_verification_equal_the_jax_scripts(
        monkeypatch, tmp_path, capsys):
    L = port("bench_lp_suite_batch")
    seen, jout = run_jax_suite_main(monkeypatch, tmp_path, suite_x)
    capsys.readouterr()
    suite = [qp.as_minimization() for qp in L.build_suite()]
    qp_all = L.stack(suite)
    same_qp(qp_all, seen["qp"])
    p, jp = L.params(), seen["params"]
    assert p.dtype == torch.float32 and jp.dtype == jnp.float32
    assert (p.eps_optimal_absolute, p.eps_optimal_relative,
            p.iteration_limit) == (jp.eps_optimal_absolute,
                                   jp.eps_optimal_relative,
                                   jp.iteration_limit)
    rows_ok, per = L.verify(suite, suite_x(qp_all))
    assert per == jout["instances"]
    assert f"{rows_ok}/12" == jout["verified_ok"]
    # the blocks that HiGHS finds infeasible: the two MCF seeds 21 and 22
    assert [r["highs"] is None for r in per] == [False] * 9 + [
        True, True, False]
    assert "HiGHS status 2" in capsys.readouterr().err
    assert list(jout) == dict_keys("bench_lp_suite_batch", "out")


def test_lp_suite_three_blocks_primal_infeasible_in_both_packages():
    """One block of each family, the MCF block the infeasible seed 21, in
    f64 on the CPU: PRIMAL_INFEASIBLE in both packages, iteration counts
    within a quarter."""
    L, JL = port("bench_lp_suite_batch"), jax_script("bench_lp_suite_batch")
    pick = (0, 4, 9)  # random_lp seed 0, block_random_lp seed 10, MCF 21
    ours = L.stack([L.build_suite()[i].as_minimization() for i in pick])
    jsuite = [JL.build_suite()[i].as_minimization() for i in pick]
    from ortools_tpu.models.lp import QuadraticProgram as JQP

    theirs = JQP(
        objective_vector=np.concatenate([q.objective_vector for q in jsuite]),
        constraint_matrix=sp.block_diag([q.constraint_matrix for q in jsuite],
                                        format="csr"),
        constraint_lower=np.concatenate([q.constraint_lower for q in jsuite]),
        constraint_upper=np.concatenate([q.constraint_upper for q in jsuite]),
        variable_lower=np.concatenate([q.variable_lower for q in jsuite]),
        variable_upper=np.concatenate([q.variable_upper for q in jsuite]),
        name="suite_blockdiag")
    same_qp(ours, theirs)
    kw = dict(eps_optimal_absolute=1e-5, eps_optimal_relative=1e-5,
              iteration_limit=300_000)
    r = solve(ours, PdhgParams(dtype=torch.float64, **kw), device="cpu")
    jr = J.solve(theirs, JParams(dtype=jnp.float64, **kw))
    assert jr.termination_reason.name == "PRIMAL_INFEASIBLE"
    assert r.termination_reason.name == "PRIMAL_INFEASIBLE"
    assert within_a_quarter(r.iterations, jr.iterations), (
        r.iterations, jr.iterations)


def test_lp_suite_main_prints_the_keys(monkeypatch, tmp_path, capsys):
    L = port("bench_lp_suite_batch")
    saved = fake_card(monkeypatch, L, tmp_path)
    short = L.params()
    monkeypatch.setattr(L, "params", lambda: PdhgParams(
        dtype=short.dtype, eps_optimal_absolute=1e-5,
        eps_optimal_relative=1e-5, iteration_limit=64))
    assert L.main() == 0
    out = last_json(capsys)
    want = [k for k in dict_keys("bench_lp_suite_batch", "out")
            if k != "instances"]
    assert list(out) == want + ["device", "power_limit_w"]
    assert out["status"] == "ITERATION_LIMIT" and out["iterations"] == 64
    assert len(saved["bench_lp_suite_batch_torch"]["instances"]) == 12


# ---------------------------------------------------------------------------
# bench_onchip_search
# ---------------------------------------------------------------------------


class FakeBatch:
    """A stand-in for ``solve_batch`` that records each call: the root's
    x and y are drawn from seed 7 (some entries negative), every node is
    OPTIMAL."""

    def __init__(self):
        self.calls = []

    def __call__(self, qp, lbs, ubs, params, warm_start_x=None,
                 warm_start_y=None, deadline=math.inf, **kw):
        self.calls.append(dict(lbs=np.array(lbs), ubs=np.array(ubs),
                               warm_x=warm_start_x, warm_y=warm_start_y,
                               deadline=deadline, params=params))
        rng = np.random.default_rng(7)
        x = rng.random(qp.num_variables) - 0.2
        y = rng.random(qp.num_constraints)
        b = lbs.shape[0]
        return types.SimpleNamespace(
            primal_solution=np.repeat(x[None], b, 0),
            dual_solution=np.repeat(y[None], b, 0),
            optimal=np.ones(b, dtype=bool),
            primal_infeasible=np.zeros(b, dtype=bool))


class NoSimplex:
    def __init__(self, qp):
        raise RuntimeError("no host simplex in this test")


def test_onchip_node_bounds_equal_the_jax_scripts(monkeypatch, capsys):
    """bench_node_lps in both packages with solve_batch and the host
    simplex replaced: the 128 node bound sets, the warm starts and the
    parameters equal bit for bit, and the same keys (``tpu_`` named
    ``device_``)."""
    O, JO = port("bench_onchip_search"), jax_script("bench_onchip_search")
    jfake, fake = FakeBatch(), FakeBatch()
    monkeypatch.setattr(ortools_tpu.pdlp.batched, "solve_batch", jfake)
    monkeypatch.setattr(ortools_tpu.glop.simplex, "RevisedSimplex", NoSimplex)
    jrec = JO.bench_node_lps()
    monkeypatch.setattr(O.batched, "solve_batch", fake)
    monkeypatch.setattr(O, "RevisedSimplex", NoSimplex)
    rec = O.bench_node_lps(CPU, host_limit=120.0)
    capsys.readouterr()
    assert len(fake.calls) == len(jfake.calls) == 3
    for c, jc in zip(fake.calls, jfake.calls):
        for k in ("lbs", "ubs", "warm_x", "warm_y"):
            if jc[k] is None:
                assert c[k] is None
            else:
                np.testing.assert_array_equal(c[k], jc[k])
                assert c[k].dtype == jc[k].dtype
        assert (c["deadline"] == math.inf) == (jc["deadline"] == math.inf)
        p, jp = c["params"], jc["params"]
        assert (p.eps_optimal_absolute, p.eps_optimal_relative,
                p.iteration_limit) == (jp.eps_optimal_absolute,
                                       jp.eps_optimal_relative,
                                       jp.iteration_limit)
    lbs = np.concatenate([c["lbs"] for c in fake.calls[1:]])
    assert lbs.shape == (128, 25_600)
    pinned = (lbs != fake.calls[0]["lbs"][0]).sum(axis=1)
    assert pinned.max() <= 12
    want = [k.replace("tpu_", "device_")
            for k in dict_keys("bench_onchip_search", "bench_node_lps")]
    assert list(rec) == want
    for k in ("n_vars", "n_rows", "n_nodes", "batch", "device_optimal",
              "device_infeasible", "host_nodes_run", "host_optimal"):
        assert rec[k] == jrec[k.replace("device_", "tpu_")], k
    assert rec["device_optimal"] == 128 and rec["host_nodes_run"] == 128


def test_onchip_greedy_cover_and_system_equal_the_jax_scripts(monkeypatch):
    O, JO = port("bench_onchip_search"), jax_script("bench_onchip_search")
    calls = {}

    def fake_fj(name):
        def run(a, lb, ub, **kw):
            calls[name] = dict(a=sp.csr_matrix(a), lb=lb, ub=ub, **kw)
            return types.SimpleNamespace(solutions=[], rounds_run=0,
                                         moves_per_second=0.0)
        return run

    monkeypatch.setattr(ortools_tpu.sat.fj_device,
                        "device_feasibility_jump", fake_fj("jax"))
    monkeypatch.setattr(ortools_tpu.sat.feasibility_jump,
                        "feasibility_jump", lambda *a, **k: None)
    jrec = JO.bench_device_fj()
    monkeypatch.setattr(O.fj_device, "device_feasibility_jump",
                        fake_fj("port"))
    monkeypatch.setattr(O, "feasibility_jump", lambda *a, **k: None)
    rec = O.bench_device_fj(CPU, host_limit=1.0)
    assert (rec["greedy_cost"], rec["cutoff"]) == (jrec["greedy_cost"],
                                                   jrec["cutoff"])
    c, jc = calls["port"], calls["jax"]
    assert (c["a"] != jc["a"]).nnz == 0
    np.testing.assert_array_equal(c["lb"], jc["lb"])
    np.testing.assert_array_equal(c["ub"], jc["ub"])
    np.testing.assert_array_equal(c["x0"], jc["x0"])
    for k in ("n_seeds", "steps_per_round", "max_rounds", "seed"):
        assert c[k] == jc[k], k
    assert list(rec) == dict_keys("bench_onchip_search", "bench_device_fj")


def test_onchip_device_fj_finds_a_checked_cover():
    """Part B on the CPU: the device FJ (its plain torch ops) finds a cover
    at or below the cutoff, which the script checks in numpy."""
    O = port("bench_onchip_search")
    rec = O.bench_device_fj(CPU, host_limit=1.0)
    assert rec["device_found"] and rec["device_cost"] <= rec["cutoff"]


def test_onchip_check_cover_sees_each_fault():
    O = port("bench_onchip_search")
    from ortools_tpu_torch.models.mip_generators import set_cover

    qp = set_cover(250, 100, seed=2).as_minimization()
    _, cost, x = O.greedy_cover(qp)
    assert O.check_cover(qp, x, cost) == []
    assert O.check_cover(qp, x, cost * 0.99) != []
    half = x.copy()
    half[np.flatnonzero(x)[0]] = 0.5
    assert "x is not binary" in O.check_cover(qp, half, cost)
    assert any("uncovered" in f
               for f in O.check_cover(qp, np.zeros_like(x), cost))


def test_onchip_warm_started_batch_matches_jax():
    """solve_batch with warm starts on a small MCF at B = 4, in f64, both
    packages from the JAX package's root: the same per-node status,
    objectives within 1e-3 relative, iteration counts within a quarter.
    (multicommodity_flow_lp(12, 40, 4, seed=1) is infeasible, HiGHS
    status 2; seed 3 is the smallest feasible one of that shape.)"""
    O = port("bench_onchip_search")
    qp = multicommodity_flow_lp(12, 40, 4, seed=3).as_minimization()
    jqp = jmulticommodity_flow_lp(12, 40, 4, seed=3).as_minimization()
    same_qp(qp, jqp)
    kw = dict(eps_optimal_absolute=1e-4, eps_optimal_relative=1e-4,
              iteration_limit=60_000)
    jp = JParams(dtype=jnp.float64, **kw)
    lb0, ub0 = qp.variable_lower[None], qp.variable_upper[None]
    root = ortools_tpu.pdlp.batched.solve_batch(jqp, lb0, ub0, jp)
    assert bool(root.optimal[0])
    lbs, ubs = O.node_bounds(qp, root.primal_solution[0],
                             np.random.default_rng(0), n_nodes=4)
    warm = dict(warm_start_x=np.repeat(root.primal_solution, 4, 0),
                warm_start_y=np.repeat(root.dual_solution, 4, 0))
    jr = ortools_tpu.pdlp.batched.solve_batch(jqp, lbs, ubs, jp, **warm)
    r = solve_batch(qp, lbs, ubs, PdhgParams(dtype=torch.float64, **kw),
                    device="cpu", **warm)
    np.testing.assert_array_equal(r.optimal, jr.optimal)
    assert r.optimal.all()
    np.testing.assert_allclose(r.primal_objective, jr.primal_objective,
                               rtol=1e-3)
    assert within_a_quarter(r.iterations, jr.iterations), (
        r.iterations, jr.iterations)


def test_onchip_main_prints_the_keys(monkeypatch, tmp_path, capsys):
    O = port("bench_onchip_search")
    saved = fake_card(monkeypatch, O, tmp_path)
    monkeypatch.setattr(O, "bench_node_lps", lambda d, h: {"h": h})
    monkeypatch.setattr(O, "bench_device_fj", lambda d, h: {"h": h})
    assert O.main(["--host-limit", "10"]) == 0
    out = last_json(capsys)
    assert list(out) == dict_keys("bench_onchip_search", "out") + [
        "device", "power_limit_w"]
    assert out["node_lp_pdhg"] == out["feasibility_jump"] == {"h": 10.0}
    assert saved["bench_onchip_search_torch"] == out


# ---------------------------------------------------------------------------
# bench_multichip_large
# ---------------------------------------------------------------------------


def jax_census(qp, shape=(2, 4)):
    """bench_multichip_large.py:73-91's census through the JAX package, the
    block shape by the JAX package's rule (its 2-D build picks the same)."""
    nr, nc = shape
    qpm = qp.as_minimization()
    params = JParams(dtype=jnp.float64)
    bm, bn = jauto_block_shape(qpm.num_constraints, qpm.num_variables,
                               qpm.num_nonzeros)
    base = J.build_device_problem(
        qpm, params,
        row_pad_multiple=nr * bm * (128 // math.gcd(128, bm)),
        col_pad_multiple=nc * bn * (128 // math.gcd(128, bn)))
    mm, nn = base.a.padded_shape
    rows_per_seg = (mm // nr) // bm
    cols_per_seg = (nn // nc) // bn
    brow = np.asarray(base.a.block_rows)[: base.a.num_real_blocks]
    bcol = np.asarray(base.a.block_cols)[: base.a.num_real_blocks]
    cell = (brow // rows_per_seg) * nc + (bcol // cols_per_seg)
    return (bm, bn), np.bincount(cell, minlength=nr * nc).tolist()


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
def test_multichip_census_equals_the_jax_packages(shape):
    M = port("bench_multichip_large")
    qp = multicommodity_flow_lp(24, 90, 8, seed=3)
    block, counts, seconds = M.census(qp, M.params(), shape)
    jblock, jcounts = jax_census(jmulticommodity_flow_lp(24, 90, 8, seed=3),
                                 shape)
    assert block == jblock and counts == jcounts
    assert sum(counts) > 0 and seconds >= 0


def test_multichip_mesh_solve_on_gloo_ranks_against_the_single_solve(
        monkeypatch, tmp_path, capsys):
    """The script's main on the CPU with the instance cut to a small MCF:
    the census, the single solve and the 2x2 mesh on 4 gloo ranks, both
    OPTIMAL within 1e-6; the JAX script's keys."""
    M = port("bench_multichip_large")
    saved = fake_card(monkeypatch, M, tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(M, "INSTANCE", dict(num_nodes=24, num_arcs=90,
                                            num_commodities=8, seed=3))
    assert M.main(["--mesh", "2x2"]) == 0
    out = last_json(capsys)
    assert saved["bench_multichip_large_torch"] == out
    assert list(out) == dict_keys("bench_multichip_large", "out") + [
        "device", "power_limit_w"]
    assert out["mesh"].startswith("2x2 gloo ranks")
    for k in ("single_device", "mesh_2d"):
        assert out[k]["status"] == "OPTIMAL"
    assert out["objective_rel_diff"] <= 1e-6
    jblock, jcounts = jax_census(jmulticommodity_flow_lp(24, 90, 8, seed=3))
    assert out["blocks_per_cell"] == jcounts
    assert out["block_shape"] == list(jblock)


# ---------------------------------------------------------------------------
# The host scripts
# ---------------------------------------------------------------------------


def jax_inprocessing_row(JI, name, nv, cls):
    """bench_inprocessing.py:51-78's body for one instance, on the JAX
    package's CDCL core and DRAT checker."""
    row = {"name": name, "n_vars": nv, "n_clauses": len(cls)}
    for on in (True, False):
        s = JI.CdclSolver(nv, proof=on)
        s.set_inprocessing(on)
        for c in cls:
            s.add_clause(c)
        r = s.solve(conflict_budget=1_000_000)
        row["on" if on else "off"] = {"verdict": int(r),
                                      "conflicts": s.num_conflicts}
        if on:
            row["vivified"] = s.num_vivified
            row["otf_subsumed"] = s.num_otf_subsumed
            if r == 0:
                row["drat_checked"] = bool(JI.check_drat(cls,
                                                         list(s.proof())))
    return row


@pytest.mark.parametrize("name", ["php6", "r3s_160_0", "r3s_160_2"])
def test_inprocessing_rows_equal_the_jax_scripts(name):
    I, JI = port("bench_inprocessing"), jax_script("bench_inprocessing")
    jinst = [("php6", *JI.php(6))] + [
        (f"r3s_160_{k}", *JI.rand3sat(160, 4.26, 10 + k)) for k in (0, 2)]
    jmap = {n: (nv, cls) for n, nv, cls in jinst}
    ours = {n: (nv, cls) for n, nv, cls in I.instances()}
    assert ours[name] == jmap[name]
    row = I.run_instance(name, *ours[name])
    jrow = jax_inprocessing_row(JI, name, *jmap[name])
    for k in ("on", "off"):
        row[k].pop("sec")
    assert row == jrow
    if name == "php6":
        assert row["drat_checked"] is True


def test_inprocessing_summary_keys():
    I = port("bench_inprocessing")
    rows = [I.run_instance("php6", *I.php(6))]
    assert list(I.summary(rows)) == dict_keys("bench_inprocessing", "out")
    assert I.summary(rows)["proofs_checked"] == "1/1"


def test_opb_model_and_pb_resolution_equal_the_jax_scripts(monkeypatch):
    B, JB = port("bench_opb"), jax_script("bench_opb")
    texts = []
    read = JB.read_opb
    monkeypatch.setattr(JB, "read_opb",
                        lambda text, name: texts.append(text)
                        or read(text, name=name))
    jm = JB.php_opb(8)
    assert texts == [B.php_opb_text(8)]
    m = B.php_opb(8)
    assert m.name == jm.name == "php_9_8"
    jr = JB.run(jm, True, 10.0)
    r = B.run(m, True, 10.0, device="cpu")
    assert jr["status"] == r["status"] == "INFEASIBLE"
    assert r["sec"] <= 10.0 and jr["sec"] <= 10.0


@pytest.mark.parametrize("seed", range(1, 11))
def test_routing_instances_equal_the_jax_scripts(seed):
    R, JR = port("bench_routing"), jax_script("bench_routing")
    ours = R.instance_data(seed)
    theirs = JR.seeded_vrptw(seed, clustered=(seed % 2 == 0))
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1:] == theirs[1:]


def test_routing_one_instance_gives_a_checked_route():
    """Seed 1 at level 2 under a 1 s budget: every customer visited once,
    each route within capacity, each arrival (waiting allowed, 10 of
    service at each stop) within its window."""
    R = port("bench_routing")
    d, demand, cap, tw = R.instance_data(1)
    routing, mgr = R.build_instance(1, device="cpu")
    sol = routing.solve_with_parameters(R.search_params(2, 1.0))
    assert sol is not None
    seen = []
    for route in sol.routes():
        nodes = [mgr.index_to_node(i) for i in route]
        assert nodes[0] == 0 and nodes[-1] == 0
        seen += nodes[1:-1]
        assert sum(demand[k] for k in nodes) <= cap
        t = 0
        for a, b in zip(nodes, nodes[1:]):
            t = max(tw[b][0], t + int(d[a, b]) + R.SERVICE)
            assert t <= tw[b][1], (a, b, t, tw[b])
    assert sorted(seen) == list(range(1, d.shape[0]))


def test_scheduling_instances_equal_the_jax_scripts():
    S, JS = port("bench_scheduling"), jax_script("bench_scheduling")
    for nj, nm, seed, scale in ((10, 5, 1, 1), (15, 5, 2, 1), (20, 5, 1, 1),
                                (10, 10, 2, 1), (10, 5, 1, 50)):
        a, b = (mod.seeded_instance(nj, nm, seed, dur_scale=scale)
                for mod in (S, JS))
        assert (a.name, a.jobs) == (b.name, b.jobs)


def test_scheduling_skips_the_rows_of_missing_files(monkeypatch):
    S = port("bench_scheduling")
    monkeypatch.delenv("SCHED_TESTDATA", raising=False)
    rows, skipped = S.suite()
    assert skipped == ["ft06", "ft06_x50"]
    assert [r[0] for r in rows][:2] == ["ft10", "la01-style_10x5_s1"]
    assert len(rows) == 10 and rows[0][2] == 930
    assert S.testdata_file("j301_1.sm") is None


def test_scheduling_one_instance_gives_a_checked_schedule():
    """la01's shape, seed 1, on the LCG core under a 1 s budget: every
    precedence and machine checked, the makespan the last end."""
    S = port("bench_scheduling")
    inst = S.seeded_instance(10, 5, 1)
    r = S.solve_engine("lcg", inst, 1.0, device="cpu")
    assert r is not None
    starts = np.array(r.starts)
    dur = np.array([[dd for _, dd in job] for job in inst.jobs])
    mach = np.array([[mm for mm, _ in job] for job in inst.jobs])
    ends = starts + dur
    assert (starts >= 0).all() and (starts[:, 1:] >= ends[:, :-1]).all()
    for k in np.unique(mach):
        s, e = starts[mach == k], ends[mach == k]
        order = np.argsort(s, kind="stable")
        assert (s[order][1:] >= e[order][:-1]).all()
    assert int(ends.max()) == r.makespan
    row = S.run_engine("lcg", inst, 1.0, device="cpu")
    assert row["makespan"] is not None and "error" not in row
