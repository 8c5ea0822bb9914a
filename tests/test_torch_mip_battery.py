"""The port's branch-and-bound against the JAX package's on the four
families of tests/test_mip_battery.py, on the CPU, as tests/test_torch_mip.py
does for tests/test_mip.py's cases (same status; objectives within
1e-9·(1+|obj|) where both prove optimality)."""

import pytest
import torch

from tests.test_mip_battery import (equality_knapsack, fixed_charge_mip,
                                    interval_scheduling_mip, set_cover_mip)
from tests.test_torch_mip import assert_matches_jax

torch.set_num_threads(1)

# The interval-scheduling family runs under a 16 s limit on both sides: its
# independent-set heuristic otherwise spends its whole 40 s budget
# (branch_and_bound.py:575-578) in each solve.
FAMILIES = [
    ("set_cover", set_cover_mip, dict(node_batch_size=16)),
    ("fixed_charge", fixed_charge_mip, dict(node_batch_size=16)),
    ("eq_knapsack", equality_knapsack, dict(node_batch_size=16)),
    ("interval_scheduling", interval_scheduling_mip,
     dict(node_batch_size=16, time_limit_sec=16.0)),
]


@pytest.mark.parametrize("name,make,kw", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_mip_family_matches_jax(name, make, kw):
    assert_matches_jax(name, make(), kw)
