"""RCPSP parser (PSPLIB .sm single-mode format) + CP model.

Capability parity: ``ortools/scheduling/rcpsp_parser.h:34`` /
``rcpsp.proto`` scoped to single-mode PSPLIB instances: precedence graph,
renewable resources, durations and per-resource demands; solved with
cumulative constraints on the CP layer.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional


@dataclasses.dataclass
class RcpspInstance:
    name: str
    num_resources: int
    capacities: List[int]
    durations: List[int]  # per task (incl. dummy source/sink)
    demands: List[List[int]]  # [task][resource]
    successors: List[List[int]]  # per task, 0-based


def parse_rcpsp(path_or_text: str, is_text: bool = False) -> RcpspInstance:
    text = path_or_text if is_text else open(path_or_text).read()
    lines = text.splitlines()
    njobs = 0
    nres = 0
    successors: List[List[int]] = []
    durations: List[int] = []
    demands: List[List[int]] = []
    capacities: List[int] = []
    i = 0
    while i < len(lines):
        ln = lines[i]
        if "jobs (incl. supersource" in ln:
            njobs = int(re.findall(r"(\d+)", ln)[-1])
        elif "- renewable" in ln:
            nres = int(re.findall(r"(\d+)", ln)[0])
        elif ln.strip().startswith("PRECEDENCE RELATIONS"):
            i += 2  # header line
            for _ in range(njobs):
                parts = lines[i].split()
                i += 1
                nsucc = int(parts[2])
                successors.append([int(x) - 1 for x in parts[3:3 + nsucc]])
            continue
        elif ln.strip().startswith("REQUESTS/DURATIONS"):
            i += 3  # header + separator
            for _ in range(njobs):
                parts = lines[i].split()
                i += 1
                durations.append(int(parts[2]))
                demands.append([int(x) for x in parts[3:3 + nres]])
            continue
        elif ln.strip().startswith("RESOURCEAVAILABILITIES"):
            i += 2
            capacities = [int(x) for x in lines[i].split()[:nres]]
        i += 1
    assert njobs and durations and successors, "not a PSPLIB .sm file"
    return RcpspInstance(
        name="", num_resources=nres, capacities=capacities,
        durations=durations, demands=demands, successors=successors,
    )


@dataclasses.dataclass
class RcpspSolution:
    makespan: int
    starts: List[int]
    optimal: bool


def solve_rcpsp(instance: RcpspInstance,
                max_time_in_seconds: float = 60.0, *, device="cuda") -> Optional[RcpspSolution]:
    from ortools_tpu_torch.sat import CpModel, CpSolver, FEASIBLE, OPTIMAL
    from ortools_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)

    n = len(instance.durations)
    horizon = sum(instance.durations)
    m = CpModel()
    starts = [m.new_int_var(0, horizon, f"s{i}") for i in range(n)]
    ivs = [
        m.new_fixed_size_interval_var(starts[i], instance.durations[i],
                                      f"iv{i}")
        for i in range(n)
    ]
    for i, succs in enumerate(instance.successors):
        for j in succs:
            m.add(starts[j] >= starts[i] + instance.durations[i])
    for r in range(instance.num_resources):
        tasks = [i for i in range(n)
                 if instance.durations[i] > 0 and instance.demands[i][r] > 0]
        if tasks:
            m.add_cumulative(
                [ivs[i] for i in tasks],
                [instance.demands[i][r] for i in tasks],
                instance.capacities[r],
            )
    makespan = m.new_int_var(0, horizon, "mk")
    m.add_max_equality(
        makespan, [starts[i] + instance.durations[i] for i in range(n)]
    )
    m.minimize(makespan)
    s = CpSolver(device=device)
    s.parameters.max_time_in_seconds = max_time_in_seconds
    status = s.solve(m)
    if status not in (OPTIMAL, FEASIBLE):
        return None
    return RcpspSolution(
        makespan=int(s.objective_value),
        starts=[s.value(x) for x in starts],
        optimal=status == OPTIMAL,
    )
