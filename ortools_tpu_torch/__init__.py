"""PyTorch / CUDA port of ``ortools_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout module for module, so each
ported function has a findable counterpart (``ortools_tpu_torch.pdlp.solver``
beside ``ortools_tpu.pdlp.solver``).  It imports torch, numpy and scipy
only.  Entry points take a ``device`` argument that defaults to ``"cuda"``;
they raise when no card is present unless the caller asks for the CPU.

Ported so far: the single-device PDLP solve (``pdlp.solve``) with both of
its block-sparse SpMV kernels (``ops/csrc/block_spmv.cu``), and the batched
solve (``pdlp.batched.solve_batch``, ``mip.node_lp.PdhgNodeBackend``) with
its block SpMM kernel (``ops/csrc/block_spmm.cu``), and the batched
branch-and-bound MIP solve (``mip.solve``) with the device feasibility jump
(``sat.fj_device``) and the host modules it needs (copies of the JAX
package's, with the native small-LP core ``_native/smalllp.cc``).

The modelling front end over them: MPS I/O (``models.mps``, a copy), the
MPSolver-style ``linear_solver.Model``/``Solver`` (pdlp, glop and mip
routes; ``Solver(solver_id, device=...)``), ``math_opt``, the knapsack
and set-cover solvers (``algorithms``, with ``dp_knapsack_torch``) and the
command line, ``python -m ortools_tpu_torch solve --input X.mps``
(``cli``, ``__main__``).
"""

import torch

# The exact stream must never run in TF32 (about three decimal digits):
# pin full float32 for matmuls and cuDNN, in every process that imports
# the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
