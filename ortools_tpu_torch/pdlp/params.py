"""PDHG solver parameters (port of ``ortools_tpu/pdlp/params.py``).

The JAX package's fields and defaults, with ``dtype`` a ``torch.dtype``.
Defaults reproduce the reference's proto defaults
(``ortools/pdlp/solvers.proto:102-395``) except the restart strategy,
ADAPTIVE_KKT (the cuPDLP scheme, PAPERS.md arXiv:2312.14832).  Left out:
``adaptive_step_size``, which no code of the JAX solver reads.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import torch


class RestartStrategy(enum.Enum):
    NO_RESTARTS = 1
    EVERY_MAJOR_ITERATION = 2
    ADAPTIVE_KKT = 3  # adaptive restart on weighted KKT error (cuPDLP)
    # reference default: trust-region localized-duality-gap criterion
    # (primal_dual_hybrid_gradient.cc:1904, pdlp/trust_region.py)
    ADAPTIVE_HEURISTIC = 4


class OptimalityNorm(enum.Enum):
    L_INF = 1
    L2 = 2


@dataclasses.dataclass
class PdhgParams:
    # -- termination criteria (solvers.proto:52-172) ---------------------
    eps_optimal_absolute: float = 1.0e-6
    eps_optimal_relative: float = 1.0e-6
    eps_primal_infeasible: float = 1.0e-8
    eps_dual_infeasible: float = 1.0e-8
    optimality_norm: OptimalityNorm = OptimalityNorm.L2
    time_sec_limit: float = math.inf
    iteration_limit: int = 2**31 - 1
    kkt_matrix_pass_limit: float = math.inf

    # -- main loop (solvers.proto:316-326) -------------------------------
    termination_check_frequency: int = 64
    restart_strategy: RestartStrategy = RestartStrategy.ADAPTIVE_KKT
    sufficient_reduction_for_restart: float = 0.1
    necessary_reduction_for_restart: float = 0.9
    # artificial restart when the current restart interval exceeds this
    # fraction of all iterations so far (cuPDLP-style).
    artificial_restart_threshold: float = 0.36

    # -- primal weight (solvers.proto:332-343) ---------------------------
    primal_weight_update_smoothing: float = 0.5
    initial_primal_weight: Optional[float] = None

    # -- rescaling (solvers.proto:367-371) -------------------------------
    l_inf_ruiz_iterations: int = 5
    l2_norm_rescaling: bool = True
    presolve: bool = False

    # -- step size (solvers.proto:184-189, 395) --------------------------
    step_size_reduction_exponent: float = 0.3
    step_size_growth_exponent: float = 0.6
    initial_step_size_scaling: float = 1.0
    max_step_attempts: int = 40  # cap on rejected retries per iteration
    power_iteration_steps: int = 40

    # -- device placement -------------------------------------------------
    dtype: torch.dtype = torch.float32
    block_shape: Optional[Tuple[int, int]] = None  # None = auto
    # The JAX package's field: the mesh passed to ``solve`` sets the
    # shards.  1 leaves it to the mesh; another value must be its size.
    num_shards: int = 1
    mesh_axis: str = "shards"  # the 1-D mesh axis the block list is split on
    # Block-row kernel layout (ops/tiled_spmv.py).  On a card the layout
    # is always attached, because the CUDA kernels are the only SpMV there;
    # False leaves out the bf16 copy and so the fast stream.  On the CPU,
    # None leaves the layout out (plain block-COO product) and True
    # attaches it, so the wrappers' plain versions and the mixed-precision
    # controller run there too.
    use_tiled_spmv: Optional[bool] = None
    # "auto"/"mixed": PDHG majors over the bf16 matrix copy while every
    # termination/restart decision is recomputed with the exact kernel;
    # the host controller switches to the exact stream for good once the
    # exactly measured KKT error stops improving.  "exact": exact only.
    stream_precision: str = "auto"
    # "adaptive" (reference ADAPTIVE_LINESEARCH_RULE) or "malitsky_pock"
    # (arXiv:1608.08883, reference TakeMalitskyPockStep :2211).
    linesearch_rule: str = "adaptive"
    mp_step_downscaling: float = 0.7  # solvers.proto MalitskyPockParams
    mp_contraction: float = 0.99
    mp_interpolation: float = 1.0
    # Once the objective gap is met, solve primal- and dual-feasibility
    # subproblems warm-started from the average iterate (reference
    # use_feasibility_polishing, primal_dual_hybrid_gradient.cc:2442).
    use_feasibility_polishing: bool = False

    # -- logging ----------------------------------------------------------
    verbosity: int = 0
    record_iteration_stats: bool = False
    # Seeds of Gaussian random projections of the iterates, logged as
    # point metadata (reference random_projection_seeds, solvers.proto:403)
    random_projection_seeds: Tuple[int, ...] = ()

    def validate(self) -> list[str]:
        errs = []
        if self.eps_optimal_absolute < 0 or self.eps_optimal_relative < 0:
            errs.append("eps_optimal must be >= 0")
        if self.termination_check_frequency <= 0:
            errs.append("termination_check_frequency must be positive")
        if not (0 <= self.primal_weight_update_smoothing <= 1):
            errs.append("primal_weight_update_smoothing must be in [0,1]")
        if self.l_inf_ruiz_iterations < 0 or self.l_inf_ruiz_iterations > 100:
            errs.append("l_inf_ruiz_iterations must be in [0,100]")
        if not (0 < self.sufficient_reduction_for_restart <= 1):
            errs.append("sufficient_reduction_for_restart must be in (0,1]")
        if not (self.sufficient_reduction_for_restart
                <= self.necessary_reduction_for_restart <= 1):
            errs.append("necessary_reduction_for_restart must be in "
                        "[sufficient_reduction_for_restart, 1]")
        if self.iteration_limit < 0:
            errs.append("iteration_limit must be >= 0")
        if self.stream_precision not in ("auto", "mixed", "exact"):
            errs.append("stream_precision must be auto|mixed|exact")
        return errs
