from ortools_tpu_torch.algorithms.knapsack import KnapsackSolver  # noqa: F401
from ortools_tpu_torch.algorithms.set_cover import SetCoverModel, greedy_set_cover  # noqa: F401
