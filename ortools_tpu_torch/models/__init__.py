from ortools_tpu_torch.models.lp import QuadraticProgram  # noqa: F401
from ortools_tpu_torch.models.mps import read_mps, write_mps  # noqa: F401
