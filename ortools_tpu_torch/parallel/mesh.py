"""Device meshes over ``torch.distributed`` (port of
``ortools_tpu/parallel/mesh.py``).

The JAX package partitions work over a named ``jax.sharding.Mesh`` axis and
combines partial results with XLA collectives under one controller.  Here
every rank of an initialised ``torch.distributed`` default group is one
device of the mesh and runs the same host program (multi-controller);
``Mesh`` holds, for each named axis, the process group of the ranks that
differ only in that axis's coordinate, and offers the collectives the
solver needs under JAX's names: ``psum`` (``all_reduce``),
``all_gather`` (tiled, in the axis's order) and ``axis_index``.

Why a class of the port's own and not ``torch.distributed.device_mesh``:
the solver needs one more choice than ``init_device_mesh`` offers, gloo
groups over CUDA tensors (several ranks sharing one card, which NCCL
refuses), and the collectives' forms depend on the backend.  A
``DeviceMesh`` of device type "cuda" always takes NCCL.  The groups here
are plain ``new_group``s.

Backends: NCCL across cards, gloo for CPU tensors.  Gloo over CUDA
tensors is taken only when the caller asks for it (``backend="gloo"``
with ``device="cuda"``); nothing picks it silently.

The forms: NCCL runs ``all_reduce`` and ``all_gather_into_tensor`` on the
device, which CUDA graphs can capture.  Under gloo the pieces go through
the host: each rank sends its piece to each other rank of the axis and
receives theirs, all at once, and every rank sums (or concatenates) them
in the axis's order.  That is one exchange where gloo's ring
``all_reduce`` takes 2(n - 1) steps in turn (at 8 CPU ranks on an 8-core
host, about 1.3 ms against 4-5 ms for a 2 KB vector), gloo has no gather
of CUDA tensors, and every rank gets the same bits by construction.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ortools_tpu_torch.utils.device import resolve_device


class Mesh:
    """The ranks of the default group laid out as an array of ``shape``
    (rank order is row-major), with one name per axis.  Made by
    ``make_mesh``."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device: torch.device, backend: str, groups: dict,
                 group_ranks: dict, world_group):
        self.shape = shape
        self.axis_names = axis_names
        self.device = device
        self.backend = backend
        self._groups = groups
        self._ranks = group_ranks  # each axis group's global ranks, in order
        self._world = world_group
        self.coords = tuple(int(c) for c in np.unravel_index(
            dist.get_rank(), shape))
        # Collective calls made from the host (psum, all_gather).  A call
        # made while a CUDA graph is captured counts once, at the capture;
        # the graph's replays make no more.
        self.calls = 0

    @property
    def size(self) -> int:
        """The number of devices (ranks) of the mesh."""
        return math.prod(self.shape)

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r}; the mesh has "
                             f"{self.axis_names}")
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[self._axis(axis)]

    def get_group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis``."""
        return self._groups[self._axis(axis)]

    # -- collectives ------------------------------------------------------
    def _exchange(self, t: torch.Tensor, axis: str) -> list:
        """Every rank's ``t`` along ``axis`` on the host, in the axis's
        order (gloo): one round of sends and receives between each pair."""
        ax = self._axis(axis)
        group, ranks, k = self._groups[ax], self._ranks[ax], self.coords[ax]
        mine = t.cpu()
        parts = [mine if j == k else torch.empty_like(mine)
                 for j in range(len(ranks))]
        ops = []
        for j, peer in enumerate(ranks):
            if j != k:
                ops.append(dist.P2POp(dist.isend, mine, peer, group))
                ops.append(dist.P2POp(dist.irecv, parts[j], peer, group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return parts

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``t`` over ``axis``, in place (``t`` is returned).  An
        axis of one rank still runs the collective (an identity), so a
        one-rank mesh makes the calls a larger one makes."""
        self.calls += 1
        if self.backend == "nccl":
            dist.all_reduce(t, group=self.get_group(axis))
            return t
        return t.copy_(torch.stack(self._exchange(t, axis)).sum(0))

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The 1-D ``t`` of every rank along ``axis``, concatenated in the
        axis's order (``jax.lax.all_gather(..., tiled=True)``)."""
        self.calls += 1
        if self.backend == "nccl":
            out = torch.empty(self.axis_size(axis) * t.shape[0],
                              dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=self.get_group(axis))
            return out
        return torch.cat(self._exchange(t, axis)).to(t.device)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on some rank: a host
        decision that may differ between ranks (a clock) made alike.
        Under NCCL the flag goes through the card (a device-to-host read
        that the caller counts); under gloo it stays on the host."""
        on = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor([1.0 if flag else 0.0], device=on)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._world)
        return bool(t.item() > 0)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"device={self.device}, backend={self.backend!r})")


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("shards",),
    device="cuda",
    backend: Optional[str] = None,
) -> Mesh:
    """A mesh over the ranks of the initialised default process group.

    Default: a 1-D mesh named "shards" over the whole world (the PDLP block
    sharding axis).  2-D shapes (rows, cols) are for the row x col
    partition of the constraint matrix.  ``prod(shape)`` must be the world
    size: every rank runs the solve.  ``device`` is where the rank's
    tensors live (on a card, this process's current CUDA device); the
    groups use ``backend``, by default NCCL for "cuda" and gloo for "cpu".

    Every rank must call this with the same arguments: the groups are
    created collectively, and one collective on each primes its
    communicator here, never inside a CUDA graph capture.
    """
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed default group "
            "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have "
                         f"{world}")
    names = tuple(axis_names[: len(shape)])
    if len(names) != len(shape) or len(set(names)) != len(names):
        raise ValueError(f"axis names {tuple(axis_names)} do not name the "
                         f"{len(shape)} axes of {shape} apart")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL takes CUDA tensors; a CPU mesh uses gloo")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ranks = np.arange(n).reshape(shape)
    me = np.unravel_index(dist.get_rank(), shape)
    groups, group_ranks = {}, {}
    for ax in range(len(shape)):
        # every rank creates every group, in the same order
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = dist.new_group(line.tolist(), backend=backend)
            if ranks[me] in line:
                groups[ax], group_ranks[ax] = g, line.tolist()
    world_group = (groups[0] if len(shape) == 1
                   else dist.new_group(list(range(n)), backend=backend))
    mesh = Mesh(shape, names, device, backend, groups, group_ranks,
                world_group)
    for ax in range(len(shape)):
        dist.all_reduce(torch.zeros(1, device=device), group=groups[ax])
    if len(shape) > 1:
        dist.all_reduce(torch.zeros(1, device=device), group=world_group)
    return mesh
