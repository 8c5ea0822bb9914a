"""What the mesh tests run inside their gloo ranks.

The ranks are spawned processes (``graft_entry.start_ranks``) that import
their target by name, so it lives in this module, which imports no JAX:
each rank runs ``run_tasks`` on a list of ``(fn, kwargs)``.
"""

import dataclasses
import importlib.util
from pathlib import Path
from typing import Any, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

from ortools_tpu_torch.parallel import make_mesh
from ortools_tpu_torch.pdlp import solver as S


class MeshSpec(NamedTuple):
    """A mesh to make in each rank: ``make_mesh(shape, axis_names)``."""

    shape: tuple
    axis_names: tuple = ("shards",)

    def make(self, device: str):
        """The mesh on ``device``, over the default group's backend."""
        return make_mesh(self.shape, self.axis_names, device=device,
                         backend=dist.get_backend())


def run_tasks(device: str, tasks: Sequence[tuple]) -> List[Any]:
    """A rank's list of tasks, each ``(fn, kwargs)`` with ``fn`` an
    importable function; a kwarg that is a ``MeshSpec`` becomes that mesh
    on ``device``.  Returns each task's result, or, where it raised a
    ValueError or RuntimeError, the exception (every rank raises alike: a
    task that fails on one rank alone leaves the others in a collective,
    and the launcher's timeout ends them)."""
    out = []
    for fn, kwargs in tasks:
        try:
            kw = {k: v.make(device) if isinstance(v, MeshSpec) else v
                  for k, v in kwargs.items()}
            out.append(fn(**kw))
        except (ValueError, RuntimeError) as e:
            out.append(e)
    return out


def mesh_layout(mesh) -> dict:
    """What a rank's mesh is: its shape, axis names, device, backend, this
    rank's coordinates, and the ranks of each axis's group."""
    return dict(
        shape=mesh.shape, axis_names=mesh.axis_names,
        device=str(mesh.device), backend=mesh.backend, coords=mesh.coords,
        groups={a: dist.get_process_group_ranks(mesh.get_group(a))
                for a in mesh.axis_names})


def mesh_products(qp, params, mesh, x, y, device="cpu"):
    """(A x, Aᵀ y) through this rank's part of ``qp``'s scaled matrix on
    ``mesh`` (numpy in, numpy out; x and y padded as the mesh pads)."""
    prob, psum = S.build_mesh_problem(qp.as_minimization(), params, mesh,
                                      device)
    mv = S._make_matvecs(prob.a, prob.at, psum)
    as_t = dict(dtype=prob.c.dtype, device=prob.c.device)
    return (mv.matvec(torch.as_tensor(x, **as_t)).cpu().numpy(),
            mv.rmatvec(torch.as_tensor(y, **as_t)).cpu().numpy())


def timed_solve(qp, params, mesh, device="cpu", margin=3.0):
    """``params``' time-limited solve on ``mesh``, with a limit that its
    set-up cannot eat.

    The solve's clock starts before the rank scales and splits the
    problem, as the JAX package's does, so on a loaded host set-up alone
    can outlast a fixed limit and the ranks stop at iteration 0.  A
    warm-up solve of one major (no time limit) first measures set-up plus
    a major on every rank; the timed solve then gets ``margin`` times the
    slowest rank's warm-up, or ``params.time_sec_limit`` if that is more.
    Every rank gets the same limit.  Returns ``(result, limit)``."""
    warm = S.solve(qp, dataclasses.replace(
        params, iteration_limit=params.termination_check_frequency,
        time_sec_limit=float("inf")), device=device, mesh=mesh)
    slowest = torch.tensor([warm.solve_time_sec], dtype=torch.float64)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    limit = max(params.time_sec_limit, margin * float(slowest[0]))
    return S.solve(qp, dataclasses.replace(params, time_sec_limit=limit),
                   device=device, mesh=mesh), limit


def run_example(stem: str, device: str) -> tuple:
    """``examples_torch/<stem>.py``'s ``main(device=device)`` in this rank:
    (the group's size, the termination reason's name, the objective, the
    iterations)."""
    path = Path(__file__).resolve().parents[1] / "examples_torch" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    r = mod.main(device=device)
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    return ranks, r.termination_reason.name, r.primal_objective, r.iterations
