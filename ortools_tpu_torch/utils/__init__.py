from ortools_tpu_torch.utils.status import TerminationReason, SolveStatus  # noqa: F401
from ortools_tpu_torch.utils.domain import Domain  # noqa: F401
from ortools_tpu_torch.utils.timers import WallTimer, TimeLimit  # noqa: F401
