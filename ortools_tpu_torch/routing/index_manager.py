"""Node <-> index mapping for routing models.

Capability parity: ``ortools/constraint_solver/routing_index_manager.h`` —
user "nodes" map to internal indices where each vehicle gets its own start
and end copies of the depot(s).
"""

from __future__ import annotations

from typing import List, Sequence, Union


class RoutingIndexManager:
    def __init__(self, num_nodes: int, num_vehicles: int,
                 depot: Union[int, Sequence[int]],
                 ends: Sequence[int] = None) -> None:
        self.num_nodes = int(num_nodes)
        self.num_vehicles = int(num_vehicles)
        if isinstance(depot, (list, tuple)):
            starts = list(depot)
        else:
            starts = [int(depot)] * num_vehicles
        if ends is None:
            ends = list(starts)
        assert len(starts) == num_vehicles and len(ends) == num_vehicles
        self._starts = starts
        self._ends = ends
        # internal layout: 0..num_nodes-1 are "visit" copies of nodes that
        # are not vehicle terminals; then per-vehicle start and end indices.
        self._index_to_node: List[int] = list(range(num_nodes))
        self._vehicle_start = {}
        self._vehicle_end = {}
        nxt = num_nodes
        for v in range(num_vehicles):
            self._vehicle_start[v] = nxt
            self._index_to_node.append(starts[v])
            nxt += 1
        for v in range(num_vehicles):
            self._vehicle_end[v] = nxt
            self._index_to_node.append(ends[v])
            nxt += 1
        self._size = nxt

    def get_number_of_nodes(self) -> int:
        return self.num_nodes

    GetNumberOfNodes = get_number_of_nodes

    def get_number_of_vehicles(self) -> int:
        return self.num_vehicles

    GetNumberOfVehicles = get_number_of_vehicles

    def get_number_of_indices(self) -> int:
        return self._size

    GetNumberOfIndices = get_number_of_indices

    def index_to_node(self, index: int) -> int:
        return self._index_to_node[index]

    IndexToNode = index_to_node

    def node_to_index(self, node: int) -> int:
        # visit index of a node (terminal copies are separate)
        return int(node)

    NodeToIndex = node_to_index

    def vehicle_start(self, vehicle: int) -> int:
        return self._vehicle_start[vehicle]

    def vehicle_end(self, vehicle: int) -> int:
        return self._vehicle_end[vehicle]
