"""The graph algorithms: max flow, min cost flow, shortest paths and
assignment on the native core (``_native/graph.cc``), the blossom matchers
and ``matching.py``, whose MIP fallback solves on the card."""

from ortools_tpu_torch.graph.max_flow import SimpleMaxFlow  # noqa: F401
from ortools_tpu_torch.graph.min_cost_flow import SimpleMinCostFlow  # noqa: F401
from ortools_tpu_torch.graph.shortest_paths import dijkstra_shortest_path  # noqa: F401
from ortools_tpu_torch.graph.assignment import LinearSumAssignment  # noqa: F401
from ortools_tpu_torch.graph.blossom import (  # noqa: F401
    max_weight_matching,
    min_weight_perfect_matching_blossom,
)
from ortools_tpu_torch.graph.matching import (  # noqa: F401
    max_cardinality_matching,
    min_weight_perfect_matching,
)
