"""The port's LP-format I/O, LP decomposer and utils against the JAX
package's, on the CPU.

- The copies' text: ``models/lp_format.py``, ``models/lp_decomposer.py``,
  ``utils/timers.py``, ``stats.py``, ``interrupt.py``, the package
  ``__init__``s of ``models``, ``utils``, ``scheduling``, ``flatzinc`` and
  ``constraint_solver`` and ``flatzinc/__main__.py`` equal the originals
  apart from import lines; ``scheduling/jobshop.py``, ``rcpsp.py``,
  ``constraint_solver/pywrapcp.py`` and ``flatzinc/driver.py`` apart from
  import lines and lines that name ``device``.
- ``write_lp`` gives the same text in both packages (names, ranged and
  equality rows, infinite bounds, integrality), ``read_lp`` of it the same
  fields, and both raise ``LpFormatError`` on the same bad input.
- ``decompose`` gives the same blocks, maps and assembled vectors; both
  drop a row without entries, even one with lower > 0 (the original's
  fault, kept in the copy).
- ``WallTimer``, ``TimeLimit``, ``StatsGroup``, ``TimeDistribution`` and
  ``SigintHandler`` behave the same.
- ``pdlp.solve`` of an LP read back from its LP file equals the solve of
  the LP, bit for bit.
"""

import math
import os
import signal

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu.models import lp_decomposer as JDEC
from ortools_tpu.models import lp_format as JLPF
from ortools_tpu.models.lp import random_lp
from ortools_tpu.utils import interrupt as JINT
from ortools_tpu.utils import stats as JSTATS
from ortools_tpu.utils import timers as JTIM

from ortools_tpu_torch.models import lp_decomposer as TDEC
from ortools_tpu_torch.models import lp_format as TLPF
from ortools_tpu_torch.models.generators import block_random_lp
from ortools_tpu_torch.pdlp import PdhgParams, solve
from ortools_tpu_torch.utils import interrupt as TINT
from ortools_tpu_torch.utils import stats as TSTATS
from ortools_tpu_torch.utils import timers as TTIM

from tests.test_lp_format import LP_SAMPLE
from tests.test_torch_cp_sat_parts import assert_device_diff
from tests.test_torch_mip_host import assert_copy_text, assert_same
from tests.test_torch_presolve import port_qp

torch.set_num_threads(1)

COPIES = ["models/lp_format.py", "models/lp_decomposer.py",
          "utils/timers.py", "utils/stats.py", "utils/interrupt.py",
          "models/__init__.py", "utils/__init__.py",
          "scheduling/__init__.py", "flatzinc/__init__.py",
          "flatzinc/__main__.py", "constraint_solver/__init__.py"]
DEVICE_FILES = ["scheduling/jobshop.py", "scheduling/rcpsp.py",
                "constraint_solver/pywrapcp.py", "flatzinc/driver.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equals_the_original_apart_from_imports(rel):
    assert_copy_text(rel)


@pytest.mark.parametrize("rel", DEVICE_FILES)
def test_device_files_differ_only_in_imports_and_device(rel):
    assert_device_diff(rel)


# ---------------------------------------------------------------------------
# write_lp / read_lp
# ---------------------------------------------------------------------------


def dressed_lp(seed: int):
    """random_lp(12, 9) with everything the LP format writes: names, an
    equality row, ranged rows, a free row dropped by the writer, rows
    without entries, free, fixed, half-infinite and binary bounds,
    integrality, an objective constant and maximization."""
    qp = random_lp(12, 9, density=0.4, seed=seed)
    rng = np.random.default_rng(100 + seed)
    a = sp.lil_matrix(qp.constraint_matrix)
    a[3, :] = 0  # a row without entries, written as "0 x0"
    qp.constraint_matrix = sp.csr_matrix(a)
    qp.constraint_matrix.eliminate_zeros()
    qp.constraint_lower[1] = qp.constraint_upper[1]  # equality
    qp.constraint_lower[[2, 5]] = qp.constraint_upper[[2, 5]] - rng.uniform(
        1.0, 3.0, 2)  # ranged
    qp.constraint_upper[7] = np.inf  # -inf..inf: dropped by write_lp
    qp.constraint_lower[8], qp.constraint_upper[8] = 0.5, np.inf  # >=
    qp.variable_lower[0], qp.variable_upper[0] = -np.inf, np.inf  # free
    qp.variable_lower[1] = qp.variable_upper[1] = 2.5  # fixed
    qp.variable_lower[2] = -np.inf  # -inf <= x <= 10
    qp.variable_upper[3] = np.inf  # the default bounds
    qp.variable_upper[4] = 1.0  # binary below
    qp.integrality = np.zeros(9, dtype=bool)
    qp.integrality[[4, 5]] = True
    qp.objective_constant = float(rng.uniform(-2, 2))
    qp.maximize = bool(seed % 2)
    qp.variable_names = [f"v{j}" for j in range(9)]
    qp.constraint_names = [f"r{i}" for i in range(12)]
    return qp


SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_write_lp_gives_the_same_text(seed, tmp_path):
    jqp = dressed_lp(seed)
    text = JLPF.write_lp(jqp)
    path = tmp_path / "m.lp"
    assert TLPF.write_lp(port_qp(jqp), str(path)) == text
    assert path.read_text() == text
    for part in ("Maximize" if seed % 2 else "Minimize", "r1: ", "r2_l: ",
                 "r2_u: ", "v0 free", "v1 = 2.5", "-inf <= v2 <= 10",
                 "Generals", "Binaries"):
        assert part in text, part


@pytest.mark.parametrize("seed", SEEDS)
def test_read_lp_gives_the_same_fields(seed):
    text = JLPF.write_lp(dressed_lp(seed))
    assert_same(TLPF.read_lp(text, is_text=True),
                JLPF.read_lp(text, is_text=True))


INTEGERS = """\
Minimize
 obj: x + y + z
Subject to
 c1: x + y + z >= 2
Bounds
 0 <= x <= 5
Generals
 x
Binaries
 y z
End
"""
FREE_AND_FIXED = """\
Minimize
 obj: a + b + c2
Subject to
 r: a + b >= 1
Bounds
 a free
 b = 3
 -2 <= c2 <= 2
End
"""


@pytest.mark.parametrize("text", [LP_SAMPLE, INTEGERS, FREE_AND_FIXED],
                         ids=["sample", "integers", "free_and_fixed"])
def test_read_lp_of_the_jax_tests_texts(text, tmp_path):
    path = tmp_path / "m.lp"
    path.write_text(text)
    assert_same(TLPF.read_lp(str(path)), JLPF.read_lp(text, is_text=True))


BAD = {
    # tests/test_lp_format.py::test_bad_constraint_raises
    "bad_constraint": "Minimize\n obj: x\nSubject to\n c: x ?? 3\nEnd\n",
    "no_sections": "x + y <= 3\n",
    "bad_bounds": "Minimize\n obj: x\nSubject to\n c: x <= 3\nBounds\n"
                  " x <= y\nEnd\n",
    "bad_term": "Minimize\n obj: x + * 3\nSubject to\n c: x <= 3\nEnd\n",
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_lp_format_errors_match(name):
    with pytest.raises(JLPF.LpFormatError) as j:
        JLPF.read_lp(BAD[name], is_text=True)
    with pytest.raises(TLPF.LpFormatError) as t:
        TLPF.read_lp(BAD[name], is_text=True)
    assert str(t.value) == str(j.value)


def test_write_lp_refuses_a_quadratic_objective():
    qp = random_lp(4, 3, density=0.5, seed=0)
    qp.objective_matrix_diagonal = np.ones(3)
    with pytest.raises(JLPF.LpFormatError) as j:
        JLPF.write_lp(qp)
    with pytest.raises(TLPF.LpFormatError) as t:
        TLPF.write_lp(port_qp(qp))
    assert str(t.value) == str(j.value)


# ---------------------------------------------------------------------------
# decompose
# ---------------------------------------------------------------------------


def stacked_lp(empty_lower: float):
    """Three random LPs stacked block-diagonally, a column of its own with
    no row, and an empty row with lower bound ``empty_lower``."""
    parts = [random_lp(6 + k, 5 + k, density=0.5, seed=20 + k)
             for k in range(3)]
    a = sp.block_diag([p.constraint_matrix for p in parts] + [
        sp.csr_matrix((1, 1))], format="csr")
    a.eliminate_zeros()
    m, n = a.shape
    cat = lambda f, extra: np.concatenate(  # noqa: E731
        [getattr(p, f) for p in parts] + [np.asarray(extra, float)])
    qp = random_lp(1, 1, seed=0)
    qp.objective_vector = cat("objective_vector", [1.5])
    qp.constraint_matrix = a
    qp.constraint_lower = cat("constraint_lower", [empty_lower])
    qp.constraint_upper = cat("constraint_upper", [np.inf])
    qp.variable_lower = cat("variable_lower", [0.0])
    qp.variable_upper = cat("variable_upper", [4.0])
    qp.integrality = np.arange(n) % 3 == 0
    qp.name = "stacked"
    assert qp.num_constraints == m
    return qp


@pytest.mark.parametrize("empty_lower", [-math.inf, 0.0, 2.0])
def test_decompose_gives_the_same_blocks(empty_lower):
    jqp = stacked_lp(empty_lower)
    j, t = JDEC.decompose(jqp), TDEC.decompose(port_qp(jqp))
    assert_same(t.blocks, j.blocks)
    assert_same(t.var_maps, j.var_maps)
    assert_same(t.row_maps, j.row_maps)
    assert (t.num_variables, t.num_constraints) == (
        j.num_variables, j.num_constraints)
    # the lone column is a block of its own; the empty row is in no block,
    # even when its lower bound makes the whole LP infeasible
    n = jqp.num_variables
    assert any(list(vm) == [n - 1] and len(rm) == 0
               for vm, rm in zip(t.var_maps, t.row_maps))
    assert len(t.blocks) >= 4
    empty_row = jqp.num_constraints - 1
    assert not any(empty_row in rm for rm in t.row_maps)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(b.num_variables) for b in t.blocks]
    ys = [rng.standard_normal(b.num_constraints) for b in t.blocks]
    assert_same(t.assemble_solution(xs), j.assemble_solution(xs))
    assert_same(t.assemble_duals(ys), j.assemble_duals(ys))


# ---------------------------------------------------------------------------
# utils: timers, stats, interrupt
# ---------------------------------------------------------------------------


def _timer_trace(tim) -> list:
    out = []
    w = tim.WallTimer()
    out.append(w.get())  # 0.0 before start
    w.start()
    w.stop()
    first = w.get()
    out += [first > 0.0, w.get() == first]  # stopped: it holds
    w.start()
    w.stop()
    out.append(w.get() > first)  # elapsed accumulates
    w.restart()
    out.append(w._running)
    lim = tim.TimeLimit(deterministic_limit=2.0)
    out += [lim.limit_reached(), lim.remaining() == math.inf]
    lim.advance_deterministic_time(1.5)
    out += [lim.deterministic_time, lim.limit_reached()]
    lim.advance_deterministic_time(0.5)
    out.append(lim.limit_reached())
    lim2 = tim.TimeLimit(wall_limit_seconds=3600.0)
    out += [lim2.limit_reached(), 0.0 < lim2.remaining() <= 3600.0,
            lim2.elapsed() >= 0.0]
    lim2.interrupt()
    out.append(lim2.limit_reached())
    out.append(tim.TimeLimit(wall_limit_seconds=0.0).limit_reached())
    return out


def test_timers_behave_the_same():
    assert _timer_trace(TTIM) == _timer_trace(JTIM)


def _stats_trace(stats) -> list:
    """tests/test_lp_format.py::test_stats, and the distributions' figures."""
    g = stats.StatsGroup("solver")
    td = g.time_distribution("propagate")
    for _ in range(3):
        with td.time_this():
            pass
    assert g.time_distribution("propagate") is td
    d = g.integer_distribution("depth")
    d.add(3)
    d.add(7)
    d.add(-1.5)
    s = str(g)
    empty = stats.Distribution("none")
    return [td.count, td.total >= 0.0, d.count, d.average, d.min, d.max,
            d.stddev, str(d), str(empty), empty.average, empty.stddev,
            s.splitlines()[0], "propagate" in s and "depth" in s,
            isinstance(td, stats.TimeDistribution)]


def test_stats_behave_the_same():
    assert _stats_trace(TSTATS) == _stats_trace(JSTATS)


def _sigint_trace(intr) -> list:
    """Install, one SIGINT (a stop request), a second (restores the
    previous handler and raises), and the exit restoring the original."""
    original = signal.getsignal(signal.SIGINT)
    out = []
    h = intr.SigintHandler()
    with h:
        out.append(signal.getsignal(signal.SIGINT) == h._on_sigint)
        out.append(h.interrupted)
        os.kill(os.getpid(), signal.SIGINT)
        out.append(h.interrupted)
        try:
            os.kill(os.getpid(), signal.SIGINT)
            out.append("no KeyboardInterrupt")
        except KeyboardInterrupt:
            out.append("KeyboardInterrupt")
        out.append(signal.getsignal(signal.SIGINT) is original)
    out.append(signal.getsignal(signal.SIGINT) is original)
    h2 = intr.SigintHandler()
    out.append(h2.interrupted)
    h2.interrupt()
    out.append(h2.interrupted)
    return out


def test_sigint_handler_behaves_the_same():
    trace = _sigint_trace(TINT)
    assert trace == _sigint_trace(JINT)
    assert trace == [True, False, True, "KeyboardInterrupt", True, True,
                     False, True]


# ---------------------------------------------------------------------------
# an LP file into pdlp.solve
# ---------------------------------------------------------------------------


def test_solve_of_the_lp_file_equals_the_solve_of_the_lp(tmp_path):
    """Rows without entries come back as explicit zeros ("0 x0"); the
    solve drops them with the scaling, so both solves agree bit for bit."""
    qp = block_random_lp(256, 256, 16, (8, 128), seed=2)
    path = tmp_path / "m.lp"
    TLPF.write_lp(qp, str(path))
    read = TLPF.read_lp(str(path))
    explicit_zeros = int((read.constraint_matrix.data == 0).sum())
    empty_rows = int((np.diff(sp.csr_matrix(
        qp.constraint_matrix).indptr) == 0).sum())
    assert explicit_zeros == empty_rows > 0
    params = PdhgParams(dtype=torch.float64)
    r, rr = (solve(q, params, device="cpu") for q in (qp, read))
    assert r.termination_reason.name == "OPTIMAL"
    for f in ("termination_reason", "iterations", "kkt_matrix_passes",
              "primal_objective", "dual_objective", "primal_residual",
              "dual_residual", "relative_gap", "primal_solution",
              "dual_solution", "reduced_costs"):
        assert_same(getattr(rr, f), getattr(r, f), f)
