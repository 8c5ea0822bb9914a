"""Process-parallel CP portfolio: real wall-clock parallelism.

Capability parity: the reference's ``NonDeterministicLoop``
(``ortools/sat/subsolver.cc:170``) — N workers each running a full solver
with diverse parameters, sharing the incumbent and objective bound.  The
reference uses C++ threads over one address space; the engine here is
Python, so workers are forked PROCESSES holding persistent engine state,
exchanging slices over pipes (the ``Shared*`` manager role lives in the
parent).  The deterministic interleaved portfolio (sat/portfolio.py)
remains the reproducible mode (``interleave_search=True``, A.10).

Soundness notes:

- the objective bound only ever tightens, so a worker exhausting its tree
  under an OLDER (looser) bound still proves no better solution exists;
- every candidate solution is re-checked by the caller against the
  original model (runtime self-verification contract), so worker results
  are advisory.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import pickle
import time
from typing import Callable, List, Optional

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat.portfolio import (
    LnsWorker,
    PortfolioOutcome,
    SLICE_BRANCHES,
    WORKER_CONFIGS,
)


def _worker_main(conn, work_bytes: bytes, cfg, deadline_wall: float,
                 max_branches: int, slice_branches: int) -> None:
    """Stateful worker process: holds a resumable Engine between slices."""
    from ortools_tpu_torch.sat.engine import Engine

    work = pickle.loads(work_bytes)
    name, var_rule, value_rule, seed = cfg
    engine = None
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                return
            _, extra_bytes, reset = msg
            if engine is None or reset:
                cts = list(work.constraints)
                if extra_bytes is not None:
                    cts.extend(pickle.loads(extra_bytes))
                model = dataclasses.replace(work, constraints=cts)
                engine = Engine(
                    model, deadline=deadline_wall,
                    max_branches=max_branches, var_rule=var_rule,
                    value_rule=value_rule, seed=seed,
                    value_hints=dict(work.solution_hint),
                )
                doms = engine.initial_domains()
                if not engine.root_propagate(doms):
                    conn.send(("res", "root_infeasible", None,
                               engine.num_branches, engine.num_conflicts))
                    engine = None
                    continue
                engine.start_search(doms)
            found: List[Optional[List[int]]] = [None]

            def cb(values: List[int]) -> bool:
                found[0] = list(values)
                return False  # pause; parent decides

            outcome = engine.search_budget(cb, slice_branches)
            conn.send(("res", outcome, found[0],
                       engine.num_branches, engine.num_conflicts))
    except (EOFError, KeyboardInterrupt, BrokenPipeError):
        return


class SharedTree:
    """Parent-side open-leaf set of ONE shared search tree (reference
    ``work_assignment.h:139`` SharedTreeManager + ProtoTrail): a leaf is
    a disjoint subtree described by unit domain constraints along a
    branching prefix.  Splitting replaces a leaf by its two engine-rule
    branch children (which partition the propagated domain, so the
    leaves always cover the root); closing every leaf proves root
    exhaustion."""

    def __init__(self, work: ir.CpModelIR) -> None:
        self.work = work
        self.leaves: dict = {0: []}  # leaf id -> list[ConstraintIR]
        self._next = 1

    def split(self, leaf_id: int) -> List[int]:
        """Replace a leaf by its branch children.  Returns the new ids:
        ``[]`` = the leaf was closed by root propagation, ``[leaf_id]``
        = fully fixed, cannot split (a worker must still check it)."""
        from ortools_tpu_torch.sat.engine import Engine

        cts = self.leaves[leaf_id]
        model = dataclasses.replace(
            self.work, constraints=list(self.work.constraints) + cts)
        eng = Engine(model)
        doms = eng.initial_domains()
        if not eng.root_propagate(doms):
            del self.leaves[leaf_id]
            return []
        v = eng._pick_variable(doms)
        if v is None:
            return [leaf_id]
        left, right = eng._branch_domains(doms[v], v)
        del self.leaves[leaf_id]
        out: List[int] = []
        for d in (left, right):
            if d.is_empty():
                continue
            nid = self._next
            self._next += 1
            self.leaves[nid] = cts + [
                ir.ConstraintIR("linear", ir.LinearArgs([v], [1], d))]
            out.append(nid)
        return out

    def grow(self, target: int, max_splits: int = 64) -> None:
        """BFS-split shallow leaves until >= target leaves exist."""
        splits = 0
        unsplittable: set = set()
        while len(self.leaves) < target and splits < max_splits:
            cands = [l for l in self.leaves if l not in unsplittable]
            if not cands:
                break
            leaf = min(cands, key=lambda l: len(self.leaves[l]))
            if self.split(leaf) == [leaf]:
                unsplittable.add(leaf)
            splits += 1


class ParallelPortfolio:
    """Same .run() interface as InterleavedPortfolio, but each tree worker
    is a forked process advancing concurrently; LNS workers run in the
    parent between collection rounds.  With ``shared_tree=True`` the
    workers split one search tree (SharedTree) instead of diversifying
    over the full tree."""

    def __init__(self, work: ir.CpModelIR, num_workers: int,
                 deadline: float, max_branches: int,
                 num_lns: int = 0, shared_tree: bool = False) -> None:
        self.work = work
        self.n_tree = max(1, num_workers - num_lns)
        self.shared_tree = shared_tree
        self.lns_workers = [
            LnsWorker(work, deadline, seed=100 + k) for k in range(num_lns)
        ]
        self.deadline = deadline
        self.max_branches = max_branches
        self.num_branches = 0
        self.num_conflicts = 0
        self._procs: List[mp.Process] = []
        self._conns = []

    def _spawn(self) -> None:
        ctx = mp.get_context("fork")
        work_bytes = pickle.dumps(self.work)
        for i in range(self.n_tree):
            cfg = WORKER_CONFIGS[i % len(WORKER_CONFIGS)]
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main,
                args=(child, work_bytes, cfg, self.deadline,
                      self.max_branches, SLICE_BRANCHES),
                daemon=True,
            )
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)

    def _shutdown(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        self._procs = []
        self._conns = []

    def run(self, on_candidate: Callable[[List[int]], bool],
            bound_ct_builder: Callable[[], Optional[ir.ConstraintIR]],
            stop_on_first: bool = False,
            best_provider: Optional[Callable[[], Optional[List[int]]]]
            = None,
            best_obj_provider=None) -> PortfolioOutcome:
        self._spawn()
        try:
            if self.shared_tree:
                return self._run_shared_tree(on_candidate, bound_ct_builder,
                                             stop_on_first, best_provider)
            return self._run(on_candidate, bound_ct_builder, stop_on_first,
                             best_provider)
        finally:
            self._shutdown()

    def _send_slice(self, wi: int, reset: bool,
                    extra_cts: Optional[List[ir.ConstraintIR]]) -> None:
        extra = (pickle.dumps([ct for ct in (extra_cts or [])
                               if ct is not None])
                 if reset else None)
        self._conns[wi].send(("slice", extra, reset))

    def _run(self, on_candidate, bound_ct_builder, stop_on_first,
             best_provider) -> PortfolioOutcome:
        n = self.n_tree
        bound_ct = bound_ct_builder()
        for wi in range(n):
            self._send_slice(wi, True, [bound_ct])
        pending = set(range(n))
        stale = set()  # workers that must reset at their next dispatch
        counted = [0] * n  # branches already folded into totals

        while True:
            if time.perf_counter() > self.deadline or \
                    self.num_branches >= self.max_branches:
                return PortfolioOutcome("limit", self.num_branches,
                                        self.num_conflicts)
            ready = mp.connection.wait(
                [self._conns[i] for i in pending], timeout=1.0)
            if not ready:
                continue
            improved_any = False
            for conn in ready:
                wi = self._conns.index(conn)
                try:
                    _, outcome, sol, nb, nc = conn.recv()
                except EOFError:
                    pending.discard(wi)
                    continue
                self.num_branches += nb - counted[wi]
                self.num_conflicts += nc
                counted[wi] = nb
                pending.discard(wi)
                if sol is not None:
                    improved = on_candidate(sol)
                    if stop_on_first:
                        return PortfolioOutcome(
                            "stopped", self.num_branches, self.num_conflicts)
                    if improved:
                        improved_any = True
                elif outcome == "done":
                    # exhausted under a (possibly older, i.e. looser)
                    # bound: proves optimality/infeasibility either way
                    return PortfolioOutcome("optimal", self.num_branches,
                                            self.num_conflicts)
                elif outcome == "root_infeasible":
                    # With a bound ct: nothing better than the incumbent
                    # exists -> optimal.  Without one: model infeasible.
                    kind = "optimal" if bound_ct is not None else "infeasible"
                    return PortfolioOutcome(kind, self.num_branches,
                                            self.num_conflicts)
                elif outcome == "limit":
                    return PortfolioOutcome("limit", self.num_branches,
                                            self.num_conflicts)
            if improved_any:
                bound_ct = bound_ct_builder()
                stale.update(range(n))
            # LNS in the parent while children work
            if self.lns_workers and best_provider is not None \
                    and best_provider() is not None:
                found: List[Optional[List[int]]] = [None]

                def cb(values):
                    found[0] = list(values)
                    return False

                for lw in self.lns_workers:
                    lw.slice(best_provider(), bound_ct_builder(), cb)
                    self.num_branches += lw.num_branches
                    self.num_conflicts += lw.num_conflicts
                    lw.num_branches = lw.num_conflicts = 0
                    if found[0] is not None:
                        if on_candidate(found[0]):
                            bound_ct = bound_ct_builder()
                            stale.update(range(n))
                        found[0] = None
            # redispatch finished workers
            for wi in list(range(n)):
                if wi in pending or not self._procs[wi].is_alive():
                    continue
                reset = wi in stale
                stale.discard(wi)
                if reset:
                    counted[wi] = 0
                self._send_slice(wi, reset, [bound_ct])
                pending.add(wi)
            if not pending and not any(p.is_alive() for p in self._procs):
                return PortfolioOutcome("limit", self.num_branches,
                                        self.num_conflicts)

    # -- shared-tree mode ----------------------------------------------------
    def _run_shared_tree(self, on_candidate, bound_ct_builder, stop_on_first,
                         best_provider) -> PortfolioOutcome:
        """Work-splitting mode (work_assignment.h SharedTreeWorker): each
        tree worker owns one open leaf; a worker finishing its leaf takes
        another, or steal-splits a busy worker's leaf.  Optimality =
        every leaf closed.  Soundness: leaves always partition the root,
        closure under an older (looser) bound still closes the leaf, and
        a steal-split only ever duplicates work (the victim keeps
        searching the parent leaf until its next reset)."""
        n = self.n_tree
        tree = SharedTree(self.work)
        tree.grow(2 * n)
        bound_ct = bound_ct_builder()
        assigned: dict = {}  # wi -> leaf id, or None = roving full-tree

        def leaf_extra(lid: Optional[int]) -> List[ir.ConstraintIR]:
            cts = list(tree.leaves[lid]) if lid is not None else []
            if bound_ct is not None:
                cts.append(bound_ct)
            return cts

        open_ids = sorted(tree.leaves)
        for wi in range(n):
            lid = open_ids[wi] if wi < len(open_ids) else None
            assigned[wi] = lid
            self._send_slice(wi, True, leaf_extra(lid))
        pending = set(range(n))
        stale: set = set()
        counted = [0] * n

        while True:
            if time.perf_counter() > self.deadline or \
                    self.num_branches >= self.max_branches:
                return PortfolioOutcome("limit", self.num_branches,
                                        self.num_conflicts)
            if not tree.leaves:
                # every leaf closed: the root is exhausted
                kind = "optimal" if bound_ct is not None else "infeasible"
                return PortfolioOutcome(kind, self.num_branches,
                                        self.num_conflicts)
            ready = mp.connection.wait(
                [self._conns[i] for i in pending], timeout=1.0)
            improved_any = False
            for conn in ready:
                wi = self._conns.index(conn)
                try:
                    _, outcome, sol, nb, nc = conn.recv()
                except EOFError:
                    pending.discard(wi)
                    continue
                self.num_branches += nb - counted[wi]
                self.num_conflicts += nc
                counted[wi] = nb
                pending.discard(wi)
                lid = assigned.get(wi)
                if sol is not None:
                    if on_candidate(sol):
                        improved_any = True
                    if stop_on_first:
                        return PortfolioOutcome(
                            "stopped", self.num_branches, self.num_conflicts)
                elif outcome in ("done", "root_infeasible"):
                    if lid is None:
                        # a rover exhausted the FULL tree under a valid
                        # (possibly older = looser) bound: global proof
                        kind = ("optimal" if bound_ct is not None
                                else "infeasible")
                        return PortfolioOutcome(kind, self.num_branches,
                                                self.num_conflicts)
                    tree.leaves.pop(lid, None)
                    assigned[wi] = None
                    stale.add(wi)  # must be re-seeded with a new leaf
                elif outcome == "limit":
                    return PortfolioOutcome("limit", self.num_branches,
                                            self.num_conflicts)
            if improved_any:
                bound_ct = bound_ct_builder()
                stale.update(range(n))
            # LNS in the parent while children work
            if self.lns_workers and best_provider is not None \
                    and best_provider() is not None:
                found: List[Optional[List[int]]] = [None]

                def cb(values):
                    found[0] = list(values)
                    return False

                for lw in self.lns_workers:
                    lw.slice(best_provider(), bound_ct_builder(), cb)
                    self.num_branches += lw.num_branches
                    self.num_conflicts += lw.num_conflicts
                    lw.num_branches = lw.num_conflicts = 0
                    if found[0] is not None:
                        if on_candidate(found[0]):
                            bound_ct = bound_ct_builder()
                            stale.update(range(n))
                        found[0] = None
            # redispatch finished workers; reassign/steal-split as needed
            for wi in list(range(n)):
                if wi in pending or not self._procs[wi].is_alive():
                    continue
                lid = assigned.get(wi)
                if lid is not None and lid not in tree.leaves:
                    lid = None  # its leaf was closed or split away
                    assigned[wi] = None
                if lid is None and tree.leaves:
                    taken = {l for w, l in assigned.items()
                             if w != wi and l is not None}
                    free = [l for l in sorted(tree.leaves)
                            if l not in taken]
                    if free:
                        lid = free[0]
                    else:
                        # steal-split a busy worker's leaf: victim keeps
                        # searching the (superset) parent until its next
                        # reset — duplicated work only, never unsound
                        victim = next((w for w, l in assigned.items()
                                       if w != wi and l is not None), None)
                        if victim is not None:
                            children = tree.split(assigned[victim])
                            if len(children) == 2:
                                assigned[victim] = children[0]
                                stale.add(victim)
                                lid = children[1]
                            elif len(children) == 1:
                                lid = None  # unsplittable: rove instead
                            else:
                                # leaf closed by propagation
                                assigned[victim] = None
                                stale.add(victim)
                                lid = None
                    assigned[wi] = lid
                    stale.add(wi)
                reset = wi in stale
                stale.discard(wi)
                if reset:
                    counted[wi] = 0
                self._send_slice(wi, reset, leaf_extra(assigned.get(wi)))
                pending.add(wi)
            if not pending and not any(p.is_alive() for p in self._procs):
                return PortfolioOutcome("limit", self.num_branches,
                                        self.num_conflicts)