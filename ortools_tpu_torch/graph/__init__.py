"""Matching, the part of ``ortools_tpu/graph`` that the port has: the
blossom matchers (``blossom.py``, a copy) and ``matching.py``, whose MIP
fallback solves on the card."""

from ortools_tpu_torch.graph.blossom import (  # noqa: F401
    max_weight_matching,
    min_weight_perfect_matching_blossom,
)
from ortools_tpu_torch.graph.matching import (  # noqa: F401
    max_cardinality_matching,
    min_weight_perfect_matching,
)
