"""The port's device feasibility jump (``ortools_tpu_torch.sat.fj_device``)
on the CPU.

Its random numbers come from a ``torch.Generator``, not ``jax.random``, so
its trajectory is not the JAX module's.  It is held to the contract of
tests/test_fj_device.py (a cover is found, objective descent improves, the
deadline is kept; every solution passes a numpy check), and one batched
step is held against a numpy evaluation of the JAX module's ``one_step``
(ortools_tpu/sat/fj_device.py:94-122) for each seed, on the same x,
activities, weights and random draws.
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ortools_tpu_torch.sat import fj_device as F
from ortools_tpu_torch.sat.fj_device import (
    device_feasibility_jump,
    objective_descent_system,
)

torch.set_num_threads(1)


def _set_cover_system(n=60, m=25, density=0.12, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, n)) < density).astype(float)
    for i in range(m):  # every row coverable
        if a[i].sum() == 0:
            a[i, rng.integers(0, n)] = 1.0
    cost = 0.1 + rng.random(n)
    return sp.csr_matrix(a), np.ones(m), np.full(m, np.inf), cost


def _check(a, rlo, rhi, x):
    ax = a @ x
    assert ((ax >= rlo - 1e-9) & (ax <= rhi + 1e-9)).all()
    assert set(np.unique(x)) <= {0.0, 1.0}


def test_device_fj_finds_cover():
    a, rlo, rhi, _ = _set_cover_system()
    res = device_feasibility_jump(a, rlo, rhi, n_seeds=16,
                                  steps_per_round=64, max_rounds=10,
                                  seed=3, device="cpu")
    assert res.solutions, "no feasible cover found"
    for x in res.solutions:
        _check(a, rlo, rhi, x)
    assert res.rounds_run >= 1 and res.moves_per_second > 0


def test_device_fj_objective_descent_improves():
    a, rlo, rhi, cost = _set_cover_system(seed=5)
    # start from the all-ones (feasible, expensive) cover and ask for
    # anything strictly cheaper via the cutoff row
    x_all = np.ones(a.shape[1])
    ub = float(cost @ x_all)
    a2, lb2, ub2 = objective_descent_system(a, rlo, rhi, cost,
                                            cutoff=ub * 0.5)
    res = device_feasibility_jump(a2, lb2, ub2, n_seeds=16,
                                  steps_per_round=64, max_rounds=20,
                                  seed=7, x0=x_all, device="cpu")
    assert res.solutions, "no improving cover found"
    for x in res.solutions:
        assert float(cost @ x) <= ub * 0.5 + 1e-6
        _check(a, rlo, rhi, x)


def test_device_fj_respects_deadline():
    a, rlo, rhi, _ = _set_cover_system(n=40, m=15, seed=9)
    t0 = time.perf_counter()
    device_feasibility_jump(a, rlo, rhi, n_seeds=8, steps_per_round=32,
                            max_rounds=10**6,
                            deadline=time.perf_counter() + 3.0,
                            device="cpu")
    assert time.perf_counter() - t0 < 30.0  # one round past deadline max


def _state(seed, n_seeds=6, n=30, m=14):
    """A random system with two-sided rows and a random point per seed."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.normal(size=(m, n)) * 2) * (rng.random((m, n)) < 0.3)
    x = (rng.random((n_seeds, n)) < 0.5).astype(np.float32)
    ax = x[0] @ a.T
    rlo = np.where(rng.random(m) < 0.5, ax - rng.integers(0, 3, m), -np.inf)
    rhi = np.where(rng.random(m) < 0.7, ax + rng.integers(0, 3, m), np.inf)
    a32 = a.astype(np.float32)
    act = (x @ a32.T).astype(np.float32)
    w = (1.0 + rng.integers(0, 4, (n_seeds, m))).astype(np.float32)
    return a32, rlo, rhi, x, act, w


def _np_one_step(a, rlo, rhi, x, act, w, u, jk, plateau_prob):
    """ortools_tpu/sat/fj_device.py:94-122 for one seed, in numpy f32."""
    f = np.float32
    lo = np.where(np.isfinite(rlo), rlo, -F._BIG).astype(f)
    hi = np.where(np.isfinite(rhi), rhi, F._BIG).astype(f)

    def viol(v):
        return np.maximum(lo - v, f(0)) + np.maximum(v - hi, f(0))

    delta = f(1) - f(2) * x
    new_act = act[:, None] + a * delta[None, :]
    new_v = (np.maximum(lo[:, None] - new_act, f(0))
             + np.maximum(new_act - hi[:, None], f(0)))
    cur_v = viol(act)
    gain = np.einsum("m,mn->n", w, cur_v[:, None] - new_v)
    j = int(np.argmax(gain))
    best = gain[j]
    do_move = (best > 1e-6) or ((best > -1e-6) and (u < plateau_prob))
    x2, act2 = x.copy(), act.copy()
    if do_move:
        x2[j] = f(1) - x[j]
        act2 = act + a[:, j] * delta[j]
    w2 = w + (f(0) if do_move else f(1)) * (cur_v > 1e-6)
    if not do_move:
        d = f(1) - f(2) * x2[jk]
        x2[jk] = f(1) - x2[jk]
        act2 = act2 + a[:, jk] * d
    return gain, x2, act2, w2


@pytest.mark.parametrize("seed", range(4))
def test_flip_gains_match_numpy(seed):
    a, rlo, rhi, x, act, w = _state(seed)
    sys_ = F.make_system(a, rlo, rhi, "cpu")
    act_t = torch.tensor(act)
    gain = F.flip_gains(sys_, torch.tensor(x), act_t, torch.tensor(w),
                        F.violation(sys_, act_t)).numpy()
    assert gain.dtype == np.float32
    for s in range(x.shape[0]):
        ref = _np_one_step(a, rlo, rhi, x[s], act[s], w[s], 1.0, 0, 0.3)[0]
        np.testing.assert_allclose(gain[s], ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_one_step_matches_numpy(seed):
    """One batched step (flip, weight bump and kick) against the JAX
    module's step for each seed, given the same draws; the draws are made
    so that some seeds move, some take a plateau and some are kicked."""
    a, rlo, rhi, x, act, w = _state(seed)
    n_seeds, n = x.shape
    rng = np.random.default_rng(100 + seed)
    u = rng.random(n_seeds).astype(np.float32)
    jk = rng.integers(0, n, n_seeds)
    sys_ = F.make_system(a, rlo, rhi, "cpu")
    st = F.FjState(torch.tensor(x), torch.tensor(act), torch.tensor(w))
    F.one_step(sys_, st, torch.tensor(u), torch.tensor(jk), 0.3)
    moved = kicked = 0
    for s in range(n_seeds):
        _, x2, act2, w2 = _np_one_step(a, rlo, rhi, x[s], act[s], w[s],
                                       u[s], jk[s], 0.3)
        np.testing.assert_array_equal(st.x[s].numpy(), x2)
        np.testing.assert_allclose(st.act[s].numpy(), act2, rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(st.w[s].numpy(), w2)
        kicked += int((w2 != w[s]).any())
        moved += int((x2 != x[s]).any())
    assert moved == n_seeds and kicked < n_seeds


def test_a_round_keeps_activities_consistent():
    """After a round of steps the activities are A x of the points."""
    a, rlo, rhi, cost = _set_cover_system(seed=2)
    a2, lb2, ub2 = objective_descent_system(a, rlo, rhi, cost, 10.0)
    a_d = np.asarray(a2.todense(), dtype=np.float32)
    sys_ = F.make_system(a_d, lb2, ub2, "cpu")
    gen = torch.Generator().manual_seed(0)
    st = F.initial_state(sys_, 8, gen, np.ones(a.shape[1]))
    F.run_round(sys_, st, gen, 50, 0.3)
    x = st.x.numpy()
    assert set(np.unique(x)) <= {0.0, 1.0}
    np.testing.assert_allclose(st.act.numpy(), x @ a_d.T, rtol=1e-5,
                               atol=1e-4)
    assert (st.w.numpy() >= 1.0).all()
