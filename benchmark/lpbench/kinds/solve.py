"""The ``solve`` traffic kind: one caller, closed loop, calling
``pdlp.solve(qp, params, device)`` on each of the configuration's first
``pool`` instances, in an order drawn from the seed, pass after pass.  Every
call gets its own copy of the instance and pays everything a user pays:
host set-up, power iteration, capture, the majors and the read.  The window
ends with a pass, so that every run does the same work.  A warm-up solve of
one more instance is set-up, and is judged too.

Judged, for every solve: the status (OPTIMAL, the only right one where the
generator's certificate proves the instance feasible), the residuals and gap
of the returned pair in the original space (``reference/kkt.py``), and the
objectives the program reports against the reference's.
"""

from __future__ import annotations

import numpy as np

from lpbench import instances
from lpbench.instances import UNIT_ROUNDOFF
from lpbench.judge import Judgement
from reference import kkt

# Counts of wrong answers are exact; the residuals and gap meet the
# configuration's tolerance at 1 (reference/kkt.py); obj_err's limit lies
# between what sound runs and the control read (PERF.md).
LIMITS = {"not_optimal": 0, "primal_res": 1.0, "dual_res": 1.0, "gap": 1.0,
          "obj_err": 0.1}
_RATIOS = ("primal_res", "dual_res", "gap")


class Mix:
    kind = "solve"

    def __init__(self, cell, seed, device):
        self.config, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.bench_dir = cell.bench_dir
        self.device = device
        self.params = instances.solver_params(self.config)
        self.records = []  # (pool index, result) of the window's solves
        self.warm = None

    def setup(self) -> None:
        from ortools_tpu_torch import pdlp

        size = int(self.traffic["pool"])
        self.pool = [instances.make_instance(self.bench_dir, self.config, i)
                     for i in range(size + 1)]
        self.programs = [instances.to_program(inst) for inst in self.pool]
        self.order = instances.rng(self.seed, 1).permutation(size)
        self.next = 0
        self.warm = pdlp.solve(instances.fresh_copy(self.programs[size]),
                               self.params, device=self.device)

    def shape(self) -> dict:
        inst = self.pool[0]
        return dict(m=inst.m, n=inst.n, nnz=inst.nnz, batch=1)

    def at_pass_end(self) -> bool:
        return self.next % len(self.order) == 0

    def unit(self) -> int:
        from ortools_tpu_torch import pdlp

        i = int(self.order[self.next % len(self.order)])
        self.next += 1
        res = pdlp.solve(instances.fresh_copy(self.programs[i]), self.params,
                         device=self.device)
        self.records.append((i, res))
        return 1

    def window_info(self) -> dict:
        return {"iterations": [r.iterations for _, r in self.records]}

    def release(self) -> None:
        self.programs = None

    def judge(self, control: str = "") -> Judgement:
        """Judge the warm-up's and every window solve's answer.  With
        ``control`` (a dtype name) the answers are first rounded to it."""
        from ortools_tpu_torch.utils.status import TerminationReason

        j = Judgement(LIMITS)
        p = self.params
        u = UNIT_ROUNDOFF[self.config["params"]["dtype"]]
        size = len(self.order)
        for n, (i, res) in enumerate([(size, self.warm), *self.records]):
            inst = self.pool[i]
            x, y = res.primal_solution, res.dual_solution
            pobj, dobj = res.primal_objective, res.dual_objective
            if control:
                x, y = kkt.round_to(x, control), kkt.round_to(y, control)
                pobj, dobj = (float(kkt.round_to(np.array([v]), control)[0])
                              for v in (pobj, dobj))
            ok = res.termination_reason == TerminationReason.OPTIMAL
            if not ok:
                j.count("not_optimal")
            r = kkt.judge(inst, x, y, inst.var_lo, inst.var_hi,
                          p.eps_optimal_absolute, p.eps_optimal_relative, u)
            for k in _RATIOS:
                ok &= j.ratio(k, r[k])
            err = max(abs(pobj - r["primal_objective"]),
                      abs(dobj - r["dual_objective"])) / r["tol_gap"]
            ok &= j.ratio("obj_err", err)
            j.attempted += 1
            j.failed += not ok
            j.window_passed += ok and n > 0
        return j
