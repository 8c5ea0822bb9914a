"""The port's MaxHS (``sat/max_hs.py``) and OLL (``sat/core_guided.py``)
against the JAX package's, on the CPU.

The models are tests/test_max_hs.py's, built with the JAX package's
``CpModel`` and carried into the port's ``CpModelIR``.  Each hitting-set
MIP runs the port's ``mip.solve`` with ``device="cpu"`` (float64 node LPs);
the CDCL core (``_native/cdcl.cc``, a copy) is deterministic, so status,
values, bound and conflict count must be equal.  A seed takes about 40 s in
each package, which is why this file stands alone.
"""

import pytest
import torch

from ortools_tpu.sat import CpModel
from ortools_tpu.sat.core_guided import minimize_core_guided as joll
from ortools_tpu.sat.max_hs import minimize_max_hs as jmax_hs

from ortools_tpu_torch.sat.core_guided import minimize_core_guided
from ortools_tpu_torch.sat.max_hs import minimize_max_hs

from tests.test_max_hs import brute_force, weighted_maxsat_model
from tests.test_torch_mip_host import to_port_ir

torch.set_num_threads(1)


def _infeasible_model():
    """tests/test_max_hs.py::test_max_hs_infeasible's model."""
    mdl = CpModel()
    x = mdl.new_bool_var("x")
    mdl.add_bool_or([x])
    mdl.add_bool_or([~x])
    mdl.minimize(x)
    return mdl


@pytest.mark.parametrize("seed", [0, 1])
def test_max_hs_matches(seed):
    mdl, w = weighted_maxsat_model(seed)
    port = minimize_max_hs(to_port_ir(mdl.ir), device="cpu")
    assert port == jmax_hs(mdl.ir)
    st, values, bound, _ = port
    ref = brute_force(mdl, w, len(w))
    assert (st, bound) == ((0, 0) if ref is None else (1, ref))
    if ref is not None:
        assert sum(int(a) * b for a, b in zip(w, values)) == ref


def test_max_hs_infeasible_matches():
    mdl = _infeasible_model()
    port = minimize_max_hs(to_port_ir(mdl.ir), device="cpu")
    assert port == jmax_hs(mdl.ir)
    assert port[0] == 0


def test_max_hs_outside_the_fragment():
    """No objective: None in both packages."""
    mdl = CpModel()
    mdl.add_bool_or([mdl.new_bool_var("x")])
    assert minimize_max_hs(to_port_ir(mdl.ir), device="cpu") is None
    assert jmax_hs(mdl.ir) is None


@pytest.mark.parametrize("seed", range(5))
def test_core_guided_matches(seed):
    mdl, w = weighted_maxsat_model(seed)
    port = minimize_core_guided(to_port_ir(mdl.ir))
    assert port == joll(mdl.ir)
    ref = brute_force(mdl, w, len(w))
    assert port[0] == (0 if ref is None else 1)
    if ref is not None:
        assert port[2] == ref


def test_core_guided_infeasible_matches():
    mdl = _infeasible_model()
    assert minimize_core_guided(to_port_ir(mdl.ir)) == joll(mdl.ir)
