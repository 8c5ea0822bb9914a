"""PDLP at scale: sharded solve of a multi-commodity-flow LP
(parity: pdlp/samples/simple_pdlp_program + BASELINE config 5 shape).

On one card (or the CPU) this runs the single-device path; in a process
group of more than one rank (torch.distributed, every rank running
``main``) it runs the block-sharded mesh path."""

import argparse

import torch
import torch.distributed as dist

from ortools_tpu_torch.models.generators import multicommodity_flow_lp
from ortools_tpu_torch.parallel import make_mesh
from ortools_tpu_torch.pdlp import PdhgParams, solve
from ortools_tpu_torch.utils.device import resolve_device


def main(device="cuda"):
    device = resolve_device(device)
    qp = multicommodity_flow_lp(num_nodes=30, num_arcs=120,
                                num_commodities=4, seed=1)
    print(f"LP: {qp.num_constraints} rows x {qp.num_variables} cols, "
          f"{qp.num_nonzeros} nnz")
    params = PdhgParams(
        dtype=torch.float64 if device.type == "cpu" else torch.float32,
        eps_optimal_absolute=1e-6, eps_optimal_relative=1e-6,
        iteration_limit=200_000,
    )
    ranks = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    mesh = make_mesh(device=device) if ranks > 1 else None
    result = solve(qp, params, device=device, mesh=mesh)
    print(f"Status: {result.termination_reason.name}")
    print(f"Objective: {result.primal_objective:.6f} "
          f"(gap {result.relative_gap:.2e}, "
          f"{result.iterations} iterations, "
          f"{result.solve_time_sec:.1f}s, "
          f"{ranks} device(s))")
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
