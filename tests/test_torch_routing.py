"""The port's routing layer (``ortools_tpu_torch/routing/``) against the
JAX package's, on the CPU.

- The copies' text: ``index_manager.py``, ``parsers.py``,
  ``lp_scheduling.py`` and ``__init__.py`` equal the JAX package's apart
  from import lines; ``model.py``, ``sat_path.py`` and ``breaks.py`` apart
  from import lines and lines that name ``device``.
- ``parse_tsplib`` and ``parse_solomon``, ``optimize_route_cumuls`` and
  ``schedule_route_with_breaks`` give the JAX package's output.
- Whole solves under greedy descent (every ``FirstSolutionStrategy``, and
  tests/test_routing.py's models): the local search ends at a local
  optimum before its time limit, so the routes and the objective equal the
  JAX package's.  Each model is built by one builder from each package's
  own ``RoutingIndexManager`` and ``RoutingModel``.
- The metaheuristics end on the clock: they are held to brute force and
  to "never worse than descent", as tests/test_routing.py holds them.
- The CP-SAT certification paths on single-vehicle instances, with
  ``RoutingModel(mgr, device="cpu")``, at the brute-force optimum and
  equal to the JAX package's.
- The repaired ``glop`` package export: ``from ortools_tpu_torch.glop
  import solve`` gives the JAX package's ``SimplexResult``.
"""

import itertools
import time
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ortools_tpu.routing as jrouting
from ortools_tpu.routing import breaks as jbreaks
from ortools_tpu.routing import lp_scheduling as jlps
from ortools_tpu.routing import parsers as jparsers
from ortools_tpu.routing import sat_path as jsat

import ortools_tpu_torch.routing as trouting
from ortools_tpu_torch.routing import breaks as tbreaks
from ortools_tpu_torch.routing import lp_scheduling as tlps
from ortools_tpu_torch.routing import parsers as tparsers
from ortools_tpu_torch.routing import sat_path as tsat

from tests.test_torch_cp_sat_parts import assert_device_diff
from tests.test_torch_mip_host import assert_copy_text, assert_same

torch.set_num_threads(1)

JAX = types.SimpleNamespace(r=jrouting, sat=jsat, lps=jlps, br=jbreaks,
                            kw={})
PORT = types.SimpleNamespace(r=trouting, sat=tsat, lps=tlps, br=tbreaks,
                             kw={"device": "cpu"})

COPIES = ["routing/__init__.py", "routing/index_manager.py",
          "routing/parsers.py", "routing/lp_scheduling.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equals_the_original_apart_from_imports(rel):
    assert_copy_text(rel)


@pytest.mark.parametrize("rel", ["routing/model.py", "routing/sat_path.py",
                                 "routing/breaks.py"])
def test_device_files_differ_only_in_imports_and_device(rel):
    assert_device_diff(rel)


def test_search_parameters_keep_the_jax_defaults():
    j = jrouting.default_routing_search_parameters()
    t = trouting.default_routing_search_parameters()
    assert_same(j, t)
    assert t.cp_sat_certification_share == 0.0
    for name in ("FirstSolutionStrategy", "LocalSearchMetaheuristic"):
        assert ([(e.name, e.value) for e in getattr(jrouting, name)]
                == [(e.name, e.value) for e in getattr(trouting, name)])


# ---------------------------------------------------------------------------
# Parsers, cumul scheduling, breaks
# ---------------------------------------------------------------------------

TSPLIB = {
    "euc2d": """\
NAME : toy7
TYPE : TSP
DIMENSION : 7
EDGE_WEIGHT_TYPE : EUC_2D
NODE_COORD_SECTION
1 0 0
2 10 0
3 10 10
4 0 10
5 5 5
6 3.5 8.25
7 12 1
EOF
""",
    "full_matrix": """\
NAME : m3
TYPE : TSP
DIMENSION : 3
EDGE_WEIGHT_TYPE : EXPLICIT
EDGE_WEIGHT_FORMAT : FULL_MATRIX
EDGE_WEIGHT_SECTION
0 1 2
1 0 3
2 3 0
EOF
""",
    "upper_row": """\
NAME : u4
TYPE : TSP
DIMENSION : 4
EDGE_WEIGHT_TYPE : EXPLICIT
EDGE_WEIGHT_FORMAT : UPPER_ROW
EDGE_WEIGHT_SECTION
4 7 9
5 2
8
EOF
""",
    "geo": """\
NAME : g3
TYPE : TSP
DIMENSION : 3
EDGE_WEIGHT_TYPE : GEO
NODE_COORD_SECTION
1 38.24 20.42
2 39.57 26.15
3 40.56 25.32
EOF
""",
}

SOLOMON = """\
TOY1

VEHICLE
NUMBER     CAPACITY
  2          50

CUSTOMER
CUST NO.  XCOORD.   YCOORD.   DEMAND    READY TIME  DUE DATE   SERVICE TIME

    0      35         35          0          0       230          0
    1      41         49         10          0       200         10
    2      22         75         30         50       180         10
    3      55         20         20         15       150         10
"""


@pytest.mark.parametrize("name", list(TSPLIB))
def test_parse_tsplib_equals_jax(name):
    j = jparsers.parse_tsplib(TSPLIB[name], is_text=True)
    t = tparsers.parse_tsplib(TSPLIB[name], is_text=True)
    assert_same(j, t)
    n = t.dimension
    assert ([[t.distance(a, b) for b in range(n)] for a in range(n)]
            == [[j.distance(a, b) for b in range(n)] for a in range(n)])


def test_parse_solomon_equals_jax(tmp_path):
    path = tmp_path / "toy.txt"
    path.write_text(SOLOMON)
    j = jparsers.parse_solomon(str(path))
    t = tparsers.parse_solomon(str(path))
    assert_same(j, t)
    for scale in (1, 10):
        np.testing.assert_array_equal(t.distance_matrix(scale),
                                      j.distance_matrix(scale))
    assert t.num_vehicles == 2 and t.capacity == 50


def _cumul_model(p, window):
    mgr = p.r.RoutingIndexManager(5, 1, 0)
    model = p.r.RoutingModel(mgr, **p.kw)
    times = np.array([[0, 2, 4, 6, 8], [2, 0, 3, 5, 7], [4, 3, 0, 2, 4],
                      [6, 5, 2, 0, 3], [8, 7, 4, 3, 0]])
    cb = model.register_transit_callback(
        lambda a, b: int(times[mgr.index_to_node(a), mgr.index_to_node(b)]))
    model.set_arc_cost_evaluator_of_all_vehicles(cb)
    model.add_dimension(cb, 10, 100, True, "Time")
    model.get_dimension_or_die("Time").set_cumul_var_range(2, *window)
    return model


@pytest.mark.parametrize("window", [(10, 50), (0, 3), (7, 9)])
def test_optimize_route_cumuls_equals_jax(window):
    out = [p.lps.optimize_route_cumuls(_cumul_model(p, window),
                                       [[1, 2, 3, 4]], "Time")
           for p in (JAX, PORT)]
    assert out[1] == out[0]
    if window == (10, 50):
        assert out[1] is not None and out[1][2] >= 10.0 - 1e-6
    if window == (0, 3):
        assert out[1] is None


def _breaks_case(p, feasible):
    if feasible:  # tests/test_routing.py:318
        mgr = p.r.RoutingIndexManager(4, 1, 0)
        model = p.r.RoutingModel(mgr, **p.kw)
        cb = model.register_transit_callback(lambda a, b: 4)
        model.add_dimension(cb, 100, 100, True, "Time")
        dim = model.get_dimension_or_die("Time")
        dim.set_break_intervals_of_vehicle(
            [p.br.BreakInterval(duration=3, start_min=4, start_max=9)], 0)
        return p.br.schedule_route_with_breaks(
            model, [1, 2, 3], "Time", dim.breaks_per_vehicle[0], **p.kw)
    mgr = p.r.RoutingIndexManager(3, 1, 0)
    model = p.r.RoutingModel(mgr, **p.kw)
    cb = model.register_transit_callback(lambda a, b: 5)
    model.add_dimension(cb, 0, 12, True, "T")
    return p.br.schedule_route_with_breaks(
        model, [1, 2], "T",
        [p.br.BreakInterval(duration=5, start_min=0, start_max=12)], **p.kw)


@pytest.mark.parametrize("feasible", [True, False])
def test_schedule_route_with_breaks_equals_jax(feasible):
    j, t = _breaks_case(JAX, feasible), _breaks_case(PORT, feasible)
    assert t == j
    assert (t is not None) == feasible
    if feasible:
        assert t["cumuls"][5] >= 19 and 4 <= t["break_starts"][0] <= 9


# ---------------------------------------------------------------------------
# Whole solves under greedy descent
# ---------------------------------------------------------------------------

LIMIT = 20.0  # far above what any descent below takes


def _dist(seed, n, scale=100.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, scale, (n, 2))
    pts[0] = (scale / 2, scale / 2)
    return np.round(np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
                    ).astype(np.int64)


def cvrp(p, seed=3, n=16, nv=3):
    """tests/test_routing.py::_cvrp_instance."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (n, 2))
    pts[0] = (50, 50)
    d = np.round(np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
                 ).astype(np.int64)
    demand = rng.integers(1, 8, n)
    demand[0] = 0
    cap = int(demand.sum() / nv * 1.6)
    mgr = p.r.RoutingIndexManager(n, nv, 0)
    m = p.r.RoutingModel(mgr, **p.kw)
    cb = m.register_transit_callback(lambda f, t: int(d[f, t]))
    m.set_arc_cost_evaluator_of_all_vehicles(cb)
    dem = m.register_unary_transit_callback(lambda f: int(demand[f]))
    m.add_dimension_with_vehicle_capacity(dem, 0, [cap] * nv, True, "load")
    return m, mgr


def tsp(p, n=9, seed=7):
    d = _dist(seed, n)
    mgr = p.r.RoutingIndexManager(n, 1, 0)
    m = p.r.RoutingModel(mgr, **p.kw)
    cb = m.register_transit_callback(
        lambda f, t: int(d[mgr.index_to_node(f), mgr.index_to_node(t)]))
    m.set_arc_cost_evaluator_of_all_vehicles(cb)
    return m, mgr


def disjunction(p, penalty):
    x = np.array([0, 1, 2, 1000])
    d = np.abs(x[:, None] - x[None, :]).astype(np.int64)
    mgr = p.r.RoutingIndexManager(4, 1, 0)
    m = p.r.RoutingModel(mgr, **p.kw)
    cb = m.register_transit_callback(lambda f, t: int(d[f, t]))
    m.set_arc_cost_evaluator_of_all_vehicles(cb)
    m.add_disjunction([3], penalty=penalty)
    return m, mgr


def pickup_delivery(p):
    d = _dist(4, 9)
    mgr = p.r.RoutingIndexManager(9, 2, 0)
    m = p.r.RoutingModel(mgr, **p.kw)
    cb = m.register_transit_callback(lambda f, t: int(d[f, t]))
    m.set_arc_cost_evaluator_of_all_vehicles(cb)
    for a, b in [(1, 2), (3, 4), (5, 6)]:
        m.add_pickup_and_delivery(a, b)
    return m, mgr


def vrptw(p):
    """Time windows, service times and capacities on 12 nodes, 3 vehicles,
    with a fixed vehicle cost."""
    rng = np.random.default_rng(11)
    d = _dist(11, 12, 50.0)
    service = rng.integers(1, 5, 12)
    service[0] = 0
    ready = rng.integers(0, 60, 12)
    ready[0] = 0
    mgr = p.r.RoutingIndexManager(12, 3, 0)
    m = p.r.RoutingModel(mgr, **p.kw)
    cb = m.register_transit_callback(lambda f, t: int(d[f, t]))
    m.set_arc_cost_evaluator_of_all_vehicles(cb)
    tcb = m.register_transit_callback(
        lambda f, t: int(d[f, t]) + int(service[f]))
    m.add_dimension(tcb, 30, 400, True, "Time")
    dim = m.get_dimension_or_die("Time")
    for i in range(1, 12):
        dim.set_cumul_var_range(i, int(ready[i]), int(ready[i]) + 120)
    dem = m.register_unary_transit_callback(lambda f: 0 if f == 0 else 2)
    m.add_dimension_with_vehicle_capacity(dem, 0, [9, 9, 9], True, "load")
    m.set_fixed_cost_of_all_vehicles(7)
    return m, mgr


def resources(p):
    """tests/test_routing.py:363."""
    d = np.full((5, 5), 10, dtype=np.int64)
    np.fill_diagonal(d, 0)
    mgr = p.r.RoutingIndexManager(5, 2, 0)
    m = p.r.RoutingModel(mgr, **p.kw)
    cb = m.register_transit_callback(lambda f, t: int(d[f, t]))
    m.set_arc_cost_evaluator_of_all_vehicles(cb)
    m.add_dimension(m.register_transit_callback(lambda f, t: int(d[f, t])),
                    100, 1000, False, "Time")
    dem = m.register_unary_transit_callback(
        lambda f: 1 if mgr.index_to_node(f) != 0 else 0)
    m.add_dimension_with_vehicle_capacity(dem, 0, [2, 2], True, "Cap")
    g = m.add_resource_group()
    g.add_resource("Time", (0, 5), (0, 1000))
    g.add_resource("Time", (20, 30), (0, 1000))
    return m, mgr


MODELS = {
    "tsp_9": tsp,
    "cvrp_16": cvrp,
    "cvrp_25_seed_8": lambda p: cvrp(p, seed=8, n=25, nv=4),
    "disjunction_dropped": lambda p: disjunction(p, 100),
    "disjunction_taken": lambda p: disjunction(p, 10_000),
    "pickup_delivery": pickup_delivery,
    "vrptw_12": vrptw,
    "resource_group": resources,
}


def _solve(p, build, strategy=None, meta=None, limit=LIMIT, routes=None):
    m, mgr = build(p)
    params = p.r.default_routing_search_parameters()
    params.time_limit_seconds = limit
    if strategy is not None:
        params.first_solution_strategy = getattr(p.r.FirstSolutionStrategy,
                                                 strategy)
    if meta is not None:
        params.local_search_metaheuristic = getattr(
            p.r.LocalSearchMetaheuristic, meta)
    t0 = time.perf_counter()
    if routes is None:
        sol = m.solve_with_parameters(params)
    else:
        sol = m.solve_from_routes(routes, params)
    dt = time.perf_counter() - t0
    if sol is None:
        return None, dt, m, mgr
    return (sol.objective_value(), sol.routes()), dt, m, mgr


def _same_solve(build, **kw):
    j, jdt, *_ = _solve(JAX, build, **kw)
    t, tdt, m, mgr = _solve(PORT, build, **kw)
    assert max(jdt, tdt) < LIMIT / 2, (jdt, tdt)  # ended at a local optimum
    assert t == j
    return t, m, mgr


@pytest.mark.parametrize("strategy",
                         [s.name for s in trouting.FirstSolutionStrategy])
def test_first_solution_strategy_with_descent_equals_jax(strategy):
    (obj, routes), m, mgr = _same_solve(cvrp, strategy=strategy)
    rng = np.random.default_rng(3)  # cvrp's draws
    rng.uniform(0, 100, (16, 2))
    demand = rng.integers(1, 8, 16)
    demand[0] = 0
    cap = int(demand.sum() / 3 * 1.6)
    seen = []
    for r in routes:
        nodes = [mgr.index_to_node(i) for i in r[1:-1]]
        assert int(demand[nodes].sum()) <= cap
        seen += nodes
    assert sorted(seen) == list(range(1, 16))


@pytest.mark.parametrize("name", list(MODELS))
def test_descent_solve_equals_jax(name):
    out, m, mgr = _same_solve(MODELS[name])
    assert out is not None
    obj, routes = out
    nodes = [mgr.index_to_node(i) for r in routes for i in r[1:-1]]
    if name == "disjunction_dropped":
        assert 3 not in nodes
    if name == "disjunction_taken":
        assert 3 in nodes
    if name == "resource_group":
        assert sum(len(r) > 2 for r in routes) == 2
    if name == "pickup_delivery":
        where = {}
        for v, r in enumerate(routes):
            for pos, i in enumerate(r[1:-1]):
                where[mgr.index_to_node(i)] = (v, pos)
        for a, b in [(1, 2), (3, 4), (5, 6)]:
            assert where[a][0] == where[b][0] and where[a][1] < where[b][1]


def test_solve_from_routes_equals_jax():
    out, *_ = _same_solve(tsp, routes=[[3, 1, 5, 2, 8, 4, 7, 6]])
    assert out is not None and sorted(out[1][0][1:-1]) == list(range(1, 9))
    j, *_ = _solve(JAX, tsp, routes=[[1, 2]])
    t, *_ = _solve(PORT, tsp, routes=[[1, 2]])
    assert t is None and j is None


def brute_force_tsp(d):
    n = d.shape[0]
    return min(sum(d[a, b] for a, b in zip((0,) + q, q + (0,)))
               for q in itertools.permutations(range(1, n)))


def test_guided_local_search_reaches_brute_force():
    out, *_ = _solve(PORT, lambda p: tsp(p, 8, 7),
                     meta="GUIDED_LOCAL_SEARCH", limit=1.5)
    assert out[0] == brute_force_tsp(_dist(7, 8))


@pytest.mark.parametrize("meta", ["GUIDED_LOCAL_SEARCH",
                                  "SIMULATED_ANNEALING", "TABU_SEARCH"])
def test_metaheuristics_never_worse_than_descent(meta):
    build = lambda p: cvrp(p, seed=5)  # noqa: E731
    base, *_ = _solve(PORT, build, meta="GREEDY_DESCENT", limit=1.5)
    got, _, m, mgr = _solve(PORT, build, meta=meta, limit=1.5)
    assert got is not None and got[0] <= base[0] * 1.001
    nodes = sorted(mgr.index_to_node(i) for r in got[1] for i in r[1:-1])
    assert nodes == list(range(1, 16))


# ---------------------------------------------------------------------------
# CP-SAT certification on one vehicle (sat_path.py:466's false OPTIMAL
# certificates come with more than one vehicle)
# ---------------------------------------------------------------------------


def _manhattan_tsp(p, n=6, seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 50, size=(n, 2))
    d = np.abs(pts[:, None, :] - pts[None, :, :]).sum(-1)
    mgr = p.r.RoutingIndexManager(n, 1, 0)
    m = p.r.RoutingModel(mgr, **p.kw)
    cb = m.register_transit_callback(lambda a, b: int(d[a, b]))
    m.set_arc_cost_evaluator_of_all_vehicles(cb)
    return m, d


def _cert(out):
    if out is None:
        return None
    a, proven = out
    return a.objective_value(), a.routes(), proven


def test_solve_with_cp_sat_equals_jax_and_brute_force():
    out = [_cert(p.sat.solve_with_cp_sat(_manhattan_tsp(p)[0],
                                         time_limit_sec=30))
           for p in (JAX, PORT)]
    assert out[1] == out[0]
    assert out[1][2] and out[1][0] == brute_force_tsp(_manhattan_tsp(PORT)[1])


def test_certify_lazy_sec_equals_jax_and_brute_force():
    out = [_cert(p.sat.certify_lazy_sec(tsp(p, 8, 2)[0],
                                        time_limit_sec=60.0))
           for p in (JAX, PORT)]
    assert out[1] == out[0]
    assert out[1][2] and out[1][0] == brute_force_tsp(_dist(2, 8))


def test_certification_share_through_the_solve():
    """``cp_sat_certification_share`` > 0 runs the certification after the
    local search, through the port's ``CpSolver`` on the model's device."""
    objs = []
    for p in (JAX, PORT):
        m, d = _manhattan_tsp(p, 7, 5)
        params = p.r.default_routing_search_parameters()
        params.cp_sat_certification_share = 0.5
        params.time_limit_seconds = 4.0
        sol = m.solve_with_parameters(params)
        objs.append(sol.objective_value())
    assert objs[1] == objs[0] == brute_force_tsp(d)
    assert str(m.device) == "cpu"


def test_certify_hetero_single_vehicle():
    out = [_cert(p.sat.certify_hetero(tsp(p, 7, 9)[0],
                                      time_limit_sec=60.0))
           for p in (JAX, PORT)]
    assert out[1] == out[0]
    if out[1] is not None:
        assert out[1][0] == brute_force_tsp(_dist(9, 7))


# ---------------------------------------------------------------------------
# glop's package export (lp_scheduling imports it)
# ---------------------------------------------------------------------------


def test_glop_package_solve_equals_jax():
    from ortools_tpu.glop import solve as jsolve
    from ortools_tpu.models.lp import QuadraticProgram as JQP

    from ortools_tpu_torch.glop import SimplexResult, solve as tsolve
    from ortools_tpu_torch.models.lp import QuadraticProgram as TQP

    rng = np.random.default_rng(2)
    a = sp.random(6, 9, density=0.5, random_state=np.random.RandomState(2))
    kw = dict(objective_vector=rng.uniform(-1, 1, 9),
              constraint_lower=np.full(6, -np.inf),
              constraint_upper=rng.uniform(1, 3, 6),
              variable_lower=np.zeros(9), variable_upper=np.full(9, 4.0))
    j = jsolve(JQP(constraint_matrix=sp.csr_matrix(a), **kw))
    t = tsolve(TQP(constraint_matrix=sp.csr_matrix(a), **kw))
    assert isinstance(t, SimplexResult)
    assert_same(j, t)
    assert t.status.name == "OPTIMAL"
