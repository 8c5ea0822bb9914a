"""PyTorch / CUDA port of ``ortools_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout module for module, so each
ported function has a findable counterpart (``ortools_tpu_torch.pdlp.solver``
beside ``ortools_tpu.pdlp.solver``).  It imports torch, numpy and scipy
only.  Entry points take a ``device`` argument that defaults to ``"cuda"``;
they raise when no card is present unless the caller asks for the CPU.

The whole JAX package is ported (``tests/test_torch_surface.py`` checks
that every module and public name has its counterpart):

- the device code: the single-device PDLP solve (``pdlp.solve``) with both
  of its block-sparse SpMV kernels (``ops/csrc/block_spmv.cu``), the
  batched solve (``pdlp.batched.solve_batch``,
  ``mip.node_lp.PdhgNodeBackend``) with its block and row SpMM kernels
  (``ops/csrc/block_spmm.cu``), the multi-device solve on
  ``torch.distributed`` (``parallel``, ``graft_entry``), the batched
  branch-and-bound MIP solve (``mip.solve``) and the device feasibility
  jump (``sat.fj_device``);
- the modelling front end over them: MPS and CPLEX LP-format I/O
  (``models.mps``, ``models.lp_format``), the LP decomposer
  (``models.lp_decomposer``), the MPSolver-style
  ``linear_solver.Model``/``Solver``, ``math_opt``, the knapsack and
  set-cover solvers (``algorithms``) and the command line,
  ``python -m ortools_tpu_torch solve --input X.mps`` (``cli``);
- the host solvers, copies of the JAX package's modules with the native
  cores of ``_native/``: glop, bin packing, BOP, CP-SAT (``sat``, with its
  portfolios and ``python -m ortools_tpu_torch.sat.runner``), the graph
  algorithms, routing, scheduling, FlatZinc
  (``python -m ortools_tpu_torch.flatzinc``), the classic CP facade
  (``constraint_solver.pywrapcp``) and the utils.

Examples on the port are in ``examples_torch/``.
"""

import torch

# The exact stream must never run in TF32 (about three decimal digits):
# pin full float32 for matmuls and cuDNN, in every process that imports
# the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from ortools_tpu_torch.utils.status import (  # noqa: E402,F401
    TerminationReason,
    SolveStatus,
)
