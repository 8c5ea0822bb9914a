"""The ``node_batches`` traffic kind: the node layer of a branch-and-bound.

One ``mip.node_lp.PdhgNodeBackend`` at ``batch`` nodes on the
configuration's first instance is kept for the run, as ``mip.solve`` keeps
one.  Set-up solves the root through it.  The nodes are ``pool_batches``
batches drawn once for the instance, never from ``--seed``: each node closes
``close_min`` to ``close_max`` of the instance's branching columns (an arc's
design, its upper bound set to 0), drawn from all of them.  Each unit is one
of those batches, warm-started from the root, in an order drawn from the
seed, pass after pass; the window ends with a pass, so that every run does
the same work.  A node ends proven optimal, proven infeasible, or unproven
at the iteration limit.

Judged: the share of nodes (root and window) left unproven; for ``sample``
nodes a batch, drawn from the seed, and the root: the residuals and gap of
the returned pair under the node's bounds (``reference/kkt.py``) and the
claimed Lagrangian bound against the reference's from the same duals; and
up to ``infeasible_sample`` of the window's infeasibility claims, drawn from
the seed, against the reference's own decision (``reference/
feasibility.py``).
"""

from __future__ import annotations

import numpy as np

from lpbench import instances
from lpbench.instances import UNIT_ROUNDOFF
from lpbench.judge import Judgement, bound_error
from reference import feasibility, kkt

# Counts of wrong answers are exact; the ratios meet the configuration's
# tolerance at 1 (reference/kkt.py); unproven_share is in % of the nodes.
LIMITS = {"unproven_share": 50.0, "wrong_infeasible": 0, "primal_res": 1.0,
          "dual_res": 1.0, "gap": 1.0, "bound_err": 1.0}
_RATIOS = ("primal_res", "dual_res", "gap")


class Mix:
    kind = "node_batches"

    def __init__(self, cell, seed, device):
        self.config, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.bench_dir = cell.bench_dir
        self.device = device
        self.params = instances.solver_params(self.config)
        self.batch = int(self.traffic["batch"])
        self.flags = []  # (optimal, infeasible) arrays of every batch
        self.kept = []  # (closed, x, y, dual bound, optimal) sampled
        self.claims = []  # closed sets of the nodes claimed infeasible

    def setup(self) -> None:
        from ortools_tpu_torch.mip.node_lp import PdhgNodeBackend

        self.inst = inst = instances.make_instance(self.bench_dir,
                                                   self.config, 0)
        draws = instances.rng(0, 2)  # the instance's nodes, not the seed's
        self.pool = [self._draw(draws)
                     for _ in range(int(self.traffic["pool_batches"]))]
        self.order = instances.rng(self.seed, 2)
        self.passes = []  # batch indices, pass after pass
        self.samples = instances.rng(self.seed, 3)
        self.backend = PdhgNodeBackend(instances.to_program(inst), self.params,
                                       self.batch, device=self.device)
        self.root = self.backend.solve(inst.var_lo[None], inst.var_hi[None])
        self.warm_x = np.repeat(self.root.primal_solution[:1], self.batch, 0)
        self.warm_y = np.repeat(self.root.dual_solution[:1], self.batch, 0)
        self.lbs = np.repeat(inst.var_lo[None], self.batch, axis=0)
        self.ubs = np.repeat(inst.var_hi[None], self.batch, axis=0)

    def shape(self) -> dict:
        inst = self.inst
        return dict(m=inst.m, n=inst.n, nnz=inst.nnz, batch=self.batch)

    def _draw(self, draws) -> list:
        lo = int(self.traffic["close_min"])
        hi = int(self.traffic["close_max"])
        branch = self.inst.branch_columns.size
        return [np.sort(draws.choice(
                    branch, size=lo + int(draws.integers(0, hi - lo + 1)),
                    replace=False))
                for _ in range(self.batch)]

    def at_pass_end(self) -> bool:
        return not self.passes

    def unit(self) -> int:
        if not self.passes:
            self.passes = list(self.order.permutation(len(self.pool)))
        closed = self.pool[self.passes.pop(0)]
        cols = [self.inst.branch_columns[c] for c in closed]
        for i, c in enumerate(cols):
            self.ubs[i, c] = 0.0
        try:
            res = self.backend.solve(self.lbs, self.ubs, self.warm_x,
                                     self.warm_y)
        finally:
            for i, c in enumerate(cols):
                self.ubs[i, c] = self.inst.var_hi[c]
        self.flags.append((res.optimal.copy(), res.primal_infeasible.copy()))
        self.claims += [closed[i] for i in np.nonzero(res.primal_infeasible)[0]]
        keep = self.samples.choice(self.batch,
                                   size=int(self.traffic["sample"]),
                                   replace=False)
        for i in keep:
            self.kept.append((closed[i], res.primal_solution[i].copy(),
                              res.dual_solution[i].copy(),
                              float(res.dual_bound[i]), bool(res.optimal[i])))
        return self.batch

    def window_info(self) -> dict:
        opt = sum(int(o.sum()) for o, _ in self.flags)
        inf = sum(int(f.sum()) for _, f in self.flags)
        total = sum(o.size for o, _ in self.flags)
        return {"nodes": total, "optimal": opt, "infeasible": inf,
                "unproven": total - opt - inf}

    def release(self) -> None:
        self.backend = None

    def _node_ub(self, closed) -> np.ndarray:
        ub = self.inst.var_hi.copy()
        ub[self.inst.branch_columns[closed]] = 0.0
        return ub

    def judge(self, control: str = "") -> Judgement:
        """Judge every node's flags, the root's and the sampled nodes'
        answers, and a sample of the infeasibility claims.  With ``control``
        (a dtype name) the answers are first rounded to it."""
        j = Judgement(LIMITS)
        inst, p = self.inst, self.params
        u = UNIT_ROUNDOFF[self.config["params"]["dtype"]]
        cert = instances.certificate(self.bench_dir, self.config)
        root = self.root
        none = np.zeros(0, dtype=np.int64)
        nodes = [(root.optimal[:1], root.primal_infeasible[:1])] + self.flags
        unproven = sum(int((~o & ~f).sum()) for o, f in nodes)
        total = sum(o.size for o, _ in nodes)
        j.ratio("unproven_share", 100.0 * unproven / total)
        j.attempted = total
        j.window_passed = sum(int((o | f).sum()) for o, f in self.flags)
        bad = unproven

        claims = list(self.claims)
        k = min(len(claims), int(self.traffic["infeasible_sample"]))
        judged_claims = [(True, claims[i]) for i in np.sort(
            self.samples.choice(len(claims), size=k, replace=False))]
        if root.primal_infeasible[0]:
            judged_claims.insert(0, (False, none))
        for in_window, closed in judged_claims:
            if feasibility.is_feasible(inst, inst.var_lo, self._node_ub(closed),
                                       cert, closed):
                j.count("wrong_infeasible")
                bad += 1
                j.window_passed -= in_window

        answers = [(False, (none, root.primal_solution[0],
                            root.dual_solution[0], float(root.dual_bound[0]),
                            bool(root.optimal[0])))]
        answers += [(True, kept) for kept in self.kept]
        for in_window, (closed, x, y, bound, opt) in answers:
            if not opt:
                continue  # unproven, or a claim judged above
            ub = self._node_ub(closed)
            if control:
                x, y = kkt.round_to(x, control), kkt.round_to(y, control)
                bound = float(kkt.round_to(np.array([bound]), control)[0])
            r = kkt.judge(inst, x, y, inst.var_lo, ub, p.eps_optimal_absolute,
                          p.eps_optimal_relative, u)
            ok = all([j.ratio(k, r[k]) for k in _RATIOS])
            ok &= j.ratio("bound_err", bound_error(bound, r["lagrangian"],
                                                   r["tol_gap"]))
            if not ok:
                bad += 1
                j.window_passed -= in_window
        j.failed = bad
        return j
