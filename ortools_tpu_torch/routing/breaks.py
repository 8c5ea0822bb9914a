"""Vehicle breaks on a routing dimension.

Capability parity: ``RoutingDimension::SetBreakIntervalsOfVehicle``
(reference ``routing.h:2849`` + break handling in
``routing_lp_scheduling.cc``) — each break is an interval of fixed
duration with a start-time window that must be scheduled DURING the
vehicle's route without overlapping travel: time accumulates as
cumul[b] >= cumul[a] + transit(a,b) + sum(durations of breaks taken on
arc (a,b)).

Scheduling along a FIXED route is a small CP model (cumul integers +
break-to-arc assignment booleans + conditional bounds) solved by this
framework's CP solver; the routing search calls it as a feasibility
check / post-optimization, mirroring how the reference re-optimizes
cumuls with an LP/MIP per route.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class BreakInterval:
    duration: int
    start_min: int
    start_max: int


def schedule_route_with_breaks(
    model, route: List[int], dimension_name: str,
    breaks: Sequence[BreakInterval], vehicle: int = 0, *, device="cuda",
) -> Optional[Dict[str, object]]:
    """Cumuls + break starts for one fixed route, or None if infeasible.

    Returns {"cumuls": {index: value}, "break_starts": [int, ...],
    "break_arcs": [position, ...]} where position p means the break is
    taken between seq[p] and seq[p+1].
    """
    from ortools_tpu_torch.sat.cp_model import CpModel, CpSolver
    from ortools_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    dim = model.get_dimension_or_die(dimension_name)
    transit = model._callbacks[dim.evaluator_index]
    seq = [model.start(vehicle)] + list(route) + [model.end(vehicle)]
    narc = len(seq) - 1
    cap = dim.capacities[vehicle] if vehicle < len(dim.capacities) else None
    horizon = int(cap) if cap is not None else 1 << 20

    m = CpModel()
    cum = []
    for pos, idx in enumerate(seq):
        lo = int(dim.cumul_lb.get(idx, 0))
        hi = int(dim.cumul_ub.get(idx, horizon))
        if pos == 0 and dim.fix_start_cumul_to_zero:
            lo = hi = 0
        cum.append(m.new_int_var(lo, hi, f"cum{pos}"))
    take = []  # take[k][p]: break k on arc p
    starts = []
    for k, br in enumerate(breaks):
        row = [m.new_bool_var(f"b{k}_arc{p}") for p in range(narc)]
        m.add_exactly_one(row)
        take.append(row)
        starts.append(m.new_int_var(int(br.start_min), int(br.start_max),
                                    f"b{k}_start"))
    for p in range(narc):
        t = int(transit(seq[p], seq[p + 1]))
        extra = sum(
            int(br.duration) * take[k][p] for k, br in enumerate(breaks)
        )
        if breaks:
            m.add(cum[p + 1] >= cum[p] + t + extra)
        else:
            m.add(cum[p + 1] >= cum[p] + t)
        if dim.slack_max < (1 << 20):
            m.add(cum[p + 1] <= cum[p] + t + int(dim.slack_max)
                  + sum(int(br.duration) * take[k][p]
                        for k, br in enumerate(breaks)))
        # a break on arc p fits inside the gap after leaving seq[p]
        for k, br in enumerate(breaks):
            m.add(starts[k] >= cum[p]).only_enforce_if(take[k][p])
            m.add(starts[k] + int(br.duration) <= cum[p + 1]
                  ).only_enforce_if(take[k][p])
    # non-overlapping breaks (sequential on the same vehicle)
    for k in range(len(breaks)):
        for k2 in range(k + 1, len(breaks)):
            b = m.new_bool_var(f"ord_{k}_{k2}")
            m.add(starts[k] + int(breaks[k].duration) <= starts[k2]
                  ).only_enforce_if(b)
            m.add(starts[k2] + int(breaks[k2].duration) <= starts[k]
                  ).only_enforce_if(b.negated())
    m.minimize(cum[-1])
    s = CpSolver(device=device)
    s.parameters.max_time_in_seconds = 10.0
    st = s.solve(m)
    if s.status_name(st) not in ("OPTIMAL", "FEASIBLE"):
        return None
    out_cum = {idx: int(s.value(cum[pos])) for pos, idx in enumerate(seq)}
    out_starts = [int(s.value(v)) for v in starts]
    out_arcs = [
        next(p for p in range(narc) if s.boolean_value(take[k][p]))
        for k in range(len(breaks))
    ]
    return {"cumuls": out_cum, "break_starts": out_starts,
            "break_arcs": out_arcs}
