from ortools_tpu_torch.routing.index_manager import RoutingIndexManager  # noqa: F401
from ortools_tpu_torch.routing.model import (  # noqa: F401
    Assignment,
    FirstSolutionStrategy,
    LocalSearchMetaheuristic,
    RoutingModel,
    RoutingSearchParameters,
    default_routing_search_parameters,
)
from ortools_tpu_torch.routing.parsers import parse_tsplib  # noqa: F401
