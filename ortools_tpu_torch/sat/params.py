"""CP-SAT solver parameters.

Capability parity: ``ortools/sat/sat_parameters.proto`` (221 fields) scoped
to the knobs this engine implements; unknown knobs can be added without
breaking callers since this is a plain dataclass.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class SatParameters:
    max_time_in_seconds: float = math.inf
    max_deterministic_time: float = math.inf
    max_number_of_conflicts: int = 2**62
    num_workers: int = 1  # >1 = portfolio over strategies
    # True (default): deterministic interleaved portfolio (reference
    # interleave_search / DeterministicLoop, the A.10 reproducibility
    # contract).  False: forked worker processes advancing concurrently
    # (reference NonDeterministicLoop) for wall-clock speedup.
    interleave_search: bool = True
    random_seed: int = 1
    log_search_progress: bool = False
    # Per-propagator timing tables printed at the end of the solve
    # (reference DemonProfiler / SCOPED_TIME_STAT tables).
    profile_propagators: bool = False
    enumerate_all_solutions: bool = False
    # search
    max_branches: int = 10_000_000
    # feasibility jump (local search) settings
    use_feasibility_jump: bool = True
    feasibility_jump_max_moves: int = 200_000
    # root LP relaxation propagation inside optimization: objective
    # bound + cut rounds + reduced-cost strengthening
    # (reference linear_programming_constraint.h; sat/lp_propagator.py)
    use_lp_relaxation: bool = True
    # core-guided (OLL) objective descent on the CDCL core for clause-like
    # boolean models (reference optimization.cc / "core" worker)
    use_core_guided: bool = True
    # which core algorithm: "oll" (totalizer descent) or "max_hs"
    # (implicit hitting set via the MIP layer; reference max_hs.h)
    core_algorithm: str = "oll"
    # lazy clause generation: general integer models on the native LCG
    # core — bound literals created lazily inside CDCL with explained
    # linear/precedence propagation (reference integer.h:453,722,
    # linear_propagation.h:176; sat/lcg.py + _native/lcg.cc).  Tried
    # before the eager encoding; falls through on unsupported fragments.
    use_lcg: bool = True
    # pure pseudo-Boolean models (all-boolean linear rows, e.g. the OPB
    # path) route to the cutting-planes PB-resolution core
    # (_native/pbsat.cc; reference pb_constraint.h:526 ResolvePBConflict)
    # whenever at least one true PB row is present
    use_pb_resolution: bool = True
    # exchange short learnt clauses (binary + units) between the
    # portfolio's LCG-core workers at synchronization points (reference
    # SharedClausesManager, synchronization.h:538); deterministic in
    # interleaved mode
    share_binary_clauses: bool = True
    # eager order-encoding of general integer models onto the CDCL core
    # (reference integer.h literal encoding + cp_model_loader.cc, done
    # eagerly; sat/integer_encoding.py)
    use_integer_cdcl: bool = True
    # size budget for the eager integer encoding (total CNF literals)
    integer_cdcl_budget: int = 4_000_000
    # presolve
    cp_model_presolve: bool = True
    # stop after first solution (feasibility problems)
    stop_after_first_solution: bool = False
    # shared-tree work splitting for the process portfolio (reference
    # shared_tree_num_workers / work_assignment.h SharedTreeManager);
    # applies when num_workers > 1 and interleave_search=False
    use_shared_tree_search: bool = False
