"""Graph samples (parity: graph/samples simple_max_flow_program +
assignment_linear_sum_assignment)."""

import argparse

from ortools_tpu_torch.graph import LinearSumAssignment, SimpleMaxFlow
from ortools_tpu_torch.utils.device import resolve_device


def main(device="cuda"):
    # host code: the device is checked, and used nowhere
    resolve_device(device)
    mf = SimpleMaxFlow()
    starts = [0, 0, 0, 1, 1, 2, 2, 3, 3]
    ends = [1, 2, 3, 2, 4, 3, 4, 2, 4]
    caps = [20, 30, 10, 40, 30, 10, 20, 5, 20]
    for s, e, c in zip(starts, ends, caps):
        mf.add_arc_with_capacity(s, e, c)
    status = mf.solve(0, 4)
    print(f"Max flow: {mf.optimal_flow()} ({status.name})")
    assert mf.optimal_flow() == 60

    assignment = LinearSumAssignment()
    costs = [[90, 76, 75, 70], [35, 85, 55, 65],
             [125, 95, 90, 105], [45, 110, 95, 115]]
    for worker, row in enumerate(costs):
        for task, cost in enumerate(row):
            assignment.add_arc_with_cost(worker, task, cost)
    status = assignment.solve()
    print(f"Assignment cost: {assignment.optimal_cost()} ({status.name})")
    for w in range(4):
        print(f"  worker {w} -> task {assignment.right_mate(w)}")
    assert assignment.optimal_cost() == 265


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
