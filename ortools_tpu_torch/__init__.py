"""PyTorch / CUDA port of ``ortools_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout module for module, so each
ported function has a findable counterpart (``ortools_tpu_torch.pdlp.solver``
beside ``ortools_tpu.pdlp.solver``).  It imports torch, numpy and scipy
only.  Entry points take a ``device`` argument that defaults to ``"cuda"``;
they raise when no card is present unless the caller asks for the CPU.

Ported so far: the single-device PDLP solve (``pdlp.solve``) and both of
its block-sparse SpMV kernels (``ops/csrc/block_spmv.cu``).
"""

import torch

# The exact stream must never run in TF32 (about three decimal digits):
# pin full float32 for matmuls and cuDNN, in every process that imports
# the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
