"""Jobshop scheduling sample (parity: examples/cpp/jobshop_sat.cc)."""

import argparse

from ortools_tpu_torch.scheduling import parse_jobshop, solve_jobshop

FT06 = """\
6 6
2 1 0 3 1 6 3 7 5 3 4 6
1 8 2 5 4 10 5 10 0 10 3 4
2 5 3 4 5 8 0 9 1 1 4 7
1 5 0 5 2 5 3 3 4 8 5 9
2 9 1 3 4 5 5 4 0 3 3 1
1 3 3 3 5 9 0 10 4 4 2 1
"""


def main(budget_sec: float = 8.0, device="cuda"):
    instance = parse_jobshop(FT06, is_text=True, name="ft06")
    solution = solve_jobshop(instance, max_time_in_seconds=budget_sec,
                             device=device)
    assert solution is not None
    print(f"ft06 makespan: {solution.makespan} "
          f"({'proven optimal' if solution.optimal else 'best found'})")
    for j, starts in enumerate(solution.starts):
        ops = " ".join(
            f"m{m}@{s}+{d}" for (m, d), s in zip(instance.jobs[j], starts)
        )
        print(f"  job {j}: {ops}")
    assert solution.makespan == 55  # known optimum
    assert solution.optimal  # proven via disjunctive branching
    return solution.makespan


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
