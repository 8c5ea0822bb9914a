"""The port's multi-device PDLP solve against the JAX package's mesh.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``; the port's side runs in gloo ranks on the CPU,
spawned once per world size for the whole module
(``graft_entry.start_ranks``), each rank running the module's list of
tasks (``tests/torch_mesh_ranks.py::run_tasks``) while this process
computes JAX's results.  Every spawn has a join timeout, so no test can hang.

Precision: the host partition and the padded problem bit for bit, the
sharded products at rtol 1e-12 in f64, and whole solves by the parity
rules of ``tests/test_torch_pdlp.py``: the same termination reason; the
same iteration count and objectives within 1e-9 where the solve ends in
its first major; otherwise the objective at the solve's tolerance and the
iteration count within a quarter (plus one major).  The JAX and the port
solves start from the same power-iteration vector.  Every rank returns
the same result, bit for bit.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.models.lp import QuadraticProgram, random_lp
from ortools_tpu.parallel import make_mesh as jmake_mesh
from ortools_tpu.pdlp import PdhgParams as JParams
from ortools_tpu.pdlp import solve as jsolve
from ortools_tpu.pdlp import solver as J

from ortools_tpu_torch import graft_entry
from ortools_tpu_torch.glop.presolve import presolve as tpresolve
from ortools_tpu_torch.ops.block_sparse import auto_block_shape
from ortools_tpu_torch.parallel import make_mesh
from ortools_tpu_torch.pdlp import PdhgParams as TParams
from ortools_tpu_torch.pdlp import solve as tsolve
from ortools_tpu_torch.pdlp import solver as T

from tests.test_torch_pdlp import (_presolve_lp, assert_close, jax_v0,
                                   port_qp, problem_arrays, scipy_solve)
from tests.torch_mesh_ranks import (MeshSpec, mesh_layout, mesh_products,
                                   run_example, run_tasks, timed_solve)

torch.set_num_threads(1)

JP64 = JParams(dtype=jnp.float64)
TP64 = TParams(dtype=torch.float64)
# Seconds a spawn may take, start-up, tasks and the JAX side included (on
# an idle 8-core sandbox: 38 s for the 8 ranks' tasks, 17 s for the dry
# run, 5 s for the 2 ranks').  Together they stay well inside the suite's
# time limit, so a hang fails its test and not the run.
WORLD8_TIMEOUT = 600.0
DRYRUN_TIMEOUT = 300.0
WORLD2_TIMEOUT = 120.0


def _infeasible():
    # x >= 2 and x <= 1 (tests/test_pdlp_sharded.py:82-98)
    return QuadraticProgram(
        objective_vector=np.array([1.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0], [1.0]])),
        constraint_lower=np.array([2.0, -np.inf]),
        constraint_upper=np.array([np.inf, 1.0]),
        variable_lower=np.array([-10.0]),
        variable_upper=np.array([10.0]),
    )


ROW_COL = ("row", "col")
# name: (problem, params, mesh shape, HiGHS reference) — the cases of
# tests/test_pdlp_sharded.py, and presolve under a mesh.
SOLVES = {
    "sharded_matches_scipy": (
        lambda: random_lp(120, 90, density=0.1, seed=17), {}, (8,), True),
    "sharded_matches_single_device": (
        lambda: random_lp(60, 60, density=0.2, seed=23),
        dict(iteration_limit=512), (8,), False),
    "sharded_mesh_size_2": (
        lambda: random_lp(50, 40, density=0.2, seed=31), {}, (2,), True),
    "2d_mesh_matches_scipy": (
        lambda: random_lp(140, 100, density=0.12, seed=31), {}, (2, 4),
        True),
    "2d_mesh_iteration_invariance": (
        lambda: random_lp(80, 70, density=0.15, seed=37),
        dict(iteration_limit=1024), (2, 4), False),
    "2d_mesh_infeasible_certificate": (
        _infeasible, dict(iteration_limit=20000), (2, 4), False),
    "presolve_2d": (lambda: _presolve_lp(3), dict(presolve=True), (2, 4),
                    True),
}
PRODUCTS = {"1d": (8,), "2d": (2, 4)}
# Solves that no tolerance ends, so the clock does: every rank must stop
# at the same iteration although their clocks differ (``Mesh.any``).  The
# limit is at least TIMED_LIMIT seconds, and at least three times a
# warm-up major's set-up and major (``timed_solve``), so that a loaded
# host's set-up cannot use it up before the first major.
TIMED = {"timed_1d": ((8,), dict(num_shards=8)), "timed_2d": ((2, 4), {})}
TIMED_LIMIT = 2.0


def _names(shape):
    return ("shards",) if len(shape) == 1 else ROW_COL


def _jmesh(shape):
    return jmake_mesh(shape=shape, axis_names=_names(shape),
                      devices=jax.devices()[:math.prod(shape)])


def _padded_n(qp, shape) -> int:
    """The padded variable count of the problem the mesh solve runs on
    (the reduced one under presolve), the length of its v0."""
    bn = auto_block_shape(qp.num_constraints, qp.num_variables,
                          qp.num_nonzeros)[1]
    mult = 128 if len(shape) == 1 else shape[1] * bn * (128 // math.gcd(
        128, bn))
    step = math.lcm(128, mult)
    return -(-max(qp.num_variables, 1) // step) * step


def _product_inputs(qp, shape):
    """The JAX problem of the mesh (placed) and seeded x, y of its padded
    lengths."""
    mesh = _jmesh(shape)
    if len(shape) == 2:
        prob, psum = J.build_2d_problem(qp, JP64, mesh)
        spec = J._problem_specs_2d(prob, *ROW_COL)
    else:
        prob = J.build_device_problem(qp, JP64,
                                      pad_blocks_to_multiple_of=shape[0])
        prob = J._place_problem(prob, mesh, "shards")
        spec = J._problem_specs(prob, "shards")
        psum = functools.partial(jax.lax.psum, axis_name="shards")
    rng = np.random.default_rng(5)
    x = rng.standard_normal(prob.c.shape[0])
    y = rng.standard_normal(prob.con_lb.shape[0])
    P = jax.sharding.PartitionSpec

    def both(prob, x, y):
        mv = J._make_matvecs(prob.a, prob.at, psum)
        return mv.matvec(x), mv.rmatvec(y)

    fn = jax.jit(jax.shard_map(both, mesh=mesh, in_specs=(spec, P(), P()),
                               out_specs=(P(), P()), check_vma=False))
    ax, aty = fn(prob, jnp.asarray(x), jnp.asarray(y))
    return x, y, np.asarray(ax), np.asarray(aty)


def _tasks(world: int):
    """The port's tasks for a spawn of ``world`` ranks, and the JAX results
    they are held against, by name."""
    tasks, names, jax_side = [], [], {}
    if world == 8:
        for label, spec in (("layout_1d", MeshSpec((8,))),
                            ("layout_2d", MeshSpec((2, 4), ROW_COL)),
                            ("wrong_size", MeshSpec((3,))),
                            ("wrong_size_2d", MeshSpec((2, 2), ROW_COL))):
            tasks.append((mesh_layout, dict(mesh=spec)))
            names.append(label)
        qp = random_lp(140, 100, density=0.12, seed=31)
        for label, shape in PRODUCTS.items():
            x, y, ax, aty = _product_inputs(qp, shape)
            tasks.append((mesh_products, dict(
                qp=port_qp(qp), params=TP64,
                mesh=MeshSpec(shape, _names(shape)), x=x, y=y)))
            names.append("products_" + label)
            jax_side["products_" + label] = (ax, aty)
        for label, (shape, kw) in TIMED.items():
            tasks.append((timed_solve, dict(
                qp=port_qp(qp), params=TParams(
                    dtype=torch.float64, eps_optimal_absolute=0.0,
                    eps_optimal_relative=0.0, iteration_limit=10**7,
                    time_sec_limit=TIMED_LIMIT, **kw),
                device="cpu", mesh=MeshSpec(shape, _names(shape)))))
            names.append(label)
        tasks.append((tsolve, dict(
            qp=port_qp(qp), params=TParams(dtype=torch.float64, num_shards=4),
            device="cpu", mesh=MeshSpec((8,)))))
        names.append("num_shards_not_the_mesh")
    if world == 2:
        tasks.append((run_example, dict(stem="pdlp_large_lp", device="cpu")))
        names.append("example_pdlp_large_lp")
    for label, (make, kw, shape, _) in SOLVES.items():
        if math.prod(shape) != world:
            continue
        qp = make()
        reduced = qp
        if kw.get("presolve"):
            reduced = tpresolve(port_qp(qp).as_minimization()).reduced
        tasks.append((tsolve, dict(
            qp=port_qp(qp), params=TParams(dtype=torch.float64, **kw),
            device="cpu", v0=jax_v0(_padded_n(reduced, shape)),
            mesh=MeshSpec(shape, _names(shape)))))
        names.append(label)
    return tasks, names, jax_side


def _jax_solves(world: int) -> dict:
    out = {}
    for label, (make, kw, shape, _) in SOLVES.items():
        if math.prod(shape) == world:
            out[label] = jsolve(make(), JParams(dtype=jnp.float64, **kw),
                                mesh=_jmesh(shape))
    return out


def _spawn(world: int, timeout: float):
    tasks, names, jax_side = _tasks(world)
    job = graft_entry.start_ranks(world, run_tasks, ("cpu", tasks),
                                  device="cpu", timeout=timeout)
    jax_side.update(_jax_solves(world))
    ranks = job.join()
    return dict(ranks=[dict(zip(names, r)) for r in ranks], jax=jax_side)


@pytest.fixture(scope="module")
def world8():
    return _spawn(8, WORLD8_TIMEOUT)


@pytest.fixture(scope="module")
def world2():
    return _spawn(2, WORLD2_TIMEOUT)


# ---------------------------------------------------------------------------
# make_mesh
# ---------------------------------------------------------------------------


def test_make_mesh_needs_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


def test_make_mesh_shapes_names_and_groups(world8):
    for rank, got in enumerate(world8["ranks"]):
        one = got["layout_1d"]
        assert one["shape"] == (8,) and one["axis_names"] == ("shards",)
        assert one["coords"] == (rank,) and one["backend"] == "gloo"
        assert one["groups"] == {"shards": list(range(8))}
        two = got["layout_2d"]
        r, c = divmod(rank, 4)
        assert two["shape"] == (2, 4) and two["axis_names"] == ROW_COL
        assert two["coords"] == (r, c)
        assert two["groups"] == {"row": [c, 4 + c],
                                 "col": [4 * r + k for k in range(4)]}


def test_make_mesh_raises_on_a_shape_that_is_not_the_world(world8):
    for got in world8["ranks"]:
        for label, need in (("wrong_size", 3), ("wrong_size_2d", 4)):
            err = got[label]
            assert isinstance(err, ValueError), err
            assert f"needs {need} devices, have 8" in str(err)


# ---------------------------------------------------------------------------
# The host partitions, bit for bit
# ---------------------------------------------------------------------------


def _assert_same_problem(tprob, jprob):
    j = problem_arrays(jprob)
    for name in J.DeviceProblem._fields:
        t = getattr(tprob, name)
        if name in ("a", "at"):
            for f in ("data", "block_rows", "block_cols"):
                np.testing.assert_array_equal(
                    getattr(t, f).numpy(), j[name][f], err_msg=name + f)
            assert t.shape == tuple(j[name]["shape"])
            assert t.padded_shape == tuple(j[name]["padded_shape"])
            assert t.num_real_blocks == j[name]["num_real_blocks"]
        else:
            np.testing.assert_array_equal(t.numpy(), j[name], err_msg=name)


def test_build_device_problem_padded_blocks_bit_for_bit():
    qp = random_lp(120, 90, density=0.1, seed=17)
    jprob = J.build_device_problem(qp, JP64, pad_blocks_to_multiple_of=8)
    tprob = T.build_device_problem(port_qp(qp), TP64, "cpu",
                                   pad_blocks_to_multiple_of=8)
    assert tprob.a.num_blocks % 8 == 0
    assert tprob.a.num_blocks > tprob.a.num_real_blocks
    _assert_same_problem(tprob, jprob)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("seed", [31, 37])
def test_2d_partition_bit_for_bit(shape, seed):
    qp = random_lp(140, 100, density=0.12, seed=seed)
    jprob, comm = J.build_2d_problem(qp, JP64, _jmesh(shape))
    base, cells = T.partition_2d(port_qp(qp), TP64, shape)
    assert (cells["seg_m"], cells["seg_n"]) == (comm.seg_m, comm.seg_n)
    assert cells["nbmax"] == jprob.a.num_real_blocks
    np.testing.assert_array_equal(cells["data"], np.asarray(jprob.a.data))
    np.testing.assert_array_equal(cells["block_rows"],
                                  np.asarray(jprob.a.block_rows))
    np.testing.assert_array_equal(cells["block_cols"],
                                  np.asarray(jprob.a.block_cols))
    for name in J.DeviceProblem._fields:
        if name not in ("a", "at"):
            np.testing.assert_array_equal(
                getattr(base, name).numpy(), np.asarray(getattr(jprob, name)),
                err_msg=name)


# ---------------------------------------------------------------------------
# The sharded products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(PRODUCTS))
def test_sharded_products_match_jax(world8, layout):
    ax, aty = world8["jax"]["products_" + layout]
    ranks = world8["ranks"]
    for got in ranks:
        tax, taty = got["products_" + layout]
        assert_close(tax, ax, "A x")
        assert_close(taty, aty, "A^T y")
        np.testing.assert_array_equal(tax, ranks[0]["products_" + layout][0])
        np.testing.assert_array_equal(taty, ranks[0]["products_" + layout][1])


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------


def _check_solve(world, label):
    make, kw, shape, highs = SOLVES[label]
    jr = world["jax"][label]
    ranks = [got[label] for got in world["ranks"]]
    tr = ranks[0]
    assert not isinstance(tr, Exception), tr
    for other in ranks[1:]:
        assert other.iterations == tr.iterations
        assert other.termination_reason == tr.termination_reason
        assert other.primal_objective == tr.primal_objective
        np.testing.assert_array_equal(other.primal_solution,
                                      tr.primal_solution)
        np.testing.assert_array_equal(other.dual_solution, tr.dual_solution)
    print(f"{label} {shape}: {jr.termination_reason.name} iterations jax "
          f"{jr.iterations} port {tr.iterations}; objective jax "
          f"{jr.primal_objective!r} port {tr.primal_objective!r}")
    freq = JParams().termination_check_frequency
    reasons = {tr.termination_reason.name, jr.termination_reason.name}
    if reasons == {"OPTIMAL", "ITERATION_LIMIT"}:
        # The case's iteration limit lies within the spread of iteration
        # counts that the rules allow: one solve ended OPTIMAL short of
        # the limit, the other reached it.
        assert min(tr.iterations, jr.iterations) >= \
            kw["iteration_limit"] * 3 // 4 - freq
    else:
        assert tr.termination_reason.name == jr.termination_reason.name
    ref_p, ref_d = jr.primal_objective, jr.dual_objective
    if jr.iterations <= freq:
        assert tr.iterations == jr.iterations
        if np.isfinite(ref_p):
            assert abs(tr.primal_objective - ref_p) <= 1e-9 * (1 + abs(ref_p))
            assert abs(tr.dual_objective - ref_d) <= 1e-9 * (1 + abs(ref_d))
    else:
        assert abs(tr.iterations - jr.iterations) <= jr.iterations // 4 + freq
        assert abs(tr.primal_objective - ref_p) <= 1e-5 * (1 + abs(ref_p))
        assert abs(tr.dual_objective - ref_d) <= 1e-5 * (1 + abs(ref_p))
    if highs:
        ref = scipy_solve(make())
        assert tr.termination_reason.name == "OPTIMAL"
        assert abs(tr.primal_objective - ref) <= 1e-4 * (1 + abs(ref))
    return tr


@pytest.mark.parametrize("label", [k for k, v in SOLVES.items()
                                   if math.prod(v[2]) == 8])
def test_mesh_solve_matches_jax(world8, label):
    tr = _check_solve(world8, label)
    if label == "2d_mesh_infeasible_certificate":
        assert tr.termination_reason.name == "PRIMAL_INFEASIBLE"
    if label.startswith("presolve"):
        assert len(tr.primal_solution) == 40
        assert abs(tr.primal_solution[0] - 1.5) < 1e-12


def test_mesh_size_2_matches_jax(world2):
    _check_solve(world2, "sharded_mesh_size_2")


def test_large_lp_example_takes_the_mesh_path_on_two_ranks(world2):
    """examples_torch/pdlp_large_lp.py in a group of two ranks builds a
    mesh (the counterpart of the JAX example's ``jax.device_count() > 1``):
    both ranks give the same result, OPTIMAL at the single device's
    objective within the solve's tolerance (1e-6)."""
    outs = [got["example_pdlp_large_lp"] for got in world2["ranks"]]
    assert outs[0] == outs[1]
    ranks, status, objective, _ = outs[0]
    assert (ranks, status) == (2, "OPTIMAL")
    _, single_status, single_objective, _ = run_example("pdlp_large_lp",
                                                        "cpu")
    assert single_status == "OPTIMAL"
    assert abs(objective - single_objective) <= 1e-6 * (
        1 + abs(single_objective))


def test_1d_mesh_equals_the_single_device_solve(world8):
    """On this LP every block lies on one rank and the others add zeros,
    so the 1-D mesh solve is the single-device solve (the JAX test's
    invariance)."""
    make, kw, _, _ = SOLVES["sharded_matches_single_device"]
    qp = make()
    single = tsolve(port_qp(qp), TParams(dtype=torch.float64, **kw),
                    device="cpu", v0=jax_v0(_padded_n(qp, (8,))))
    tr = world8["ranks"][0]["sharded_matches_single_device"]
    assert tr.iterations == single.iterations
    np.testing.assert_allclose(tr.primal_solution, single.primal_solution,
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("label", sorted(TIMED))
def test_time_limit_stops_every_rank_at_the_same_iteration(world8, label):
    """The ranks' clocks differ; ``Mesh.any`` makes them stop together."""
    ranks = [got[label] for got in world8["ranks"]]
    assert not isinstance(ranks[0], Exception), ranks[0]
    limits = {limit for _, limit in ranks}
    assert len(limits) == 1 and limits.pop() >= TIMED_LIMIT
    ranks = [r for r, _ in ranks]
    r0 = ranks[0]
    print(f"{label}: limit {world8['ranks'][0][label][1]!r} s, stopped at "
          f"iteration {r0.iterations}")
    assert r0.termination_reason.name == "TIME_LIMIT"
    assert r0.iterations > 0
    for r in ranks[1:]:
        assert r.termination_reason.name == "TIME_LIMIT"
        assert r.iterations == r0.iterations
        assert r.primal_objective == r0.primal_objective
        np.testing.assert_array_equal(r.primal_solution, r0.primal_solution)


def test_num_shards_must_be_the_mesh_size(world8):
    for got in world8["ranks"]:
        err = got["num_shards_not_the_mesh"]
        assert isinstance(err, ValueError), err
        assert "num_shards=4" in str(err) and "8 devices" in str(err)


def test_dryrun_multichip_on_eight_cpu_ranks(capsys):
    graft_entry.dryrun_multichip(8, device="cpu", timeout=DRYRUN_TIMEOUT)
    out = capsys.readouterr().out
    assert "1-D ok" in out and "2-D (2,4) ok" in out


def test_entry_runs_one_major_on_the_cpu():
    run_major, (prob, state) = graft_entry.entry(device="cpu")
    out = run_major(prob, state)
    assert int(out.num_accepted) == JParams().termination_check_frequency
    assert bool(torch.isfinite(out.x).all())
