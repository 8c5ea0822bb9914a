from ortools_tpu_torch.pdlp.params import PdhgParams  # noqa: F401
from ortools_tpu_torch.pdlp.solver import SolveResult, solve  # noqa: F401
