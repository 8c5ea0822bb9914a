"""Problem data and solver state carried across from plain arrays.

The JAX package's ``DeviceProblem``, ``PdhgState`` and
``BlockSparseMatrix`` hold arrays that convert to numpy; these functions
turn such numpy arrays into the port's objects, so that each ported
function can be held against its JAX twin on one shared problem and
state.  Integer arrays stay int32; float arrays keep their dtype.

A batch (the arrays of ``jax.vmap``: a leading axis B) goes across as it
is, except that JAX's per-instance scalars, of shape [B], become the
port's [B, 1] (``state_from_arrays(..., batched=True)``).  A batched
problem is the shared problem with [B, N] variable bounds, which
``device_problem_from_arrays`` takes as they are.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix
from ortools_tpu_torch.pdlp.solver import DeviceProblem, PdhgState
from ortools_tpu_torch.utils.device import resolve_device


def _tensor(v, device: torch.device) -> torch.Tensor:
    v = np.asarray(v)
    if v.dtype.kind in "iu":
        v = v.astype(np.int32)
    return torch.as_tensor(np.array(v, copy=True), device=device)


def block_sparse_from_arrays(
    data, block_rows, block_cols, shape: Tuple[int, int],
    padded_shape: Tuple[int, int], num_real_blocks: int, device="cuda",
) -> BlockSparseMatrix:
    """A BlockSparseMatrix over the given block-COO arrays (no layout)."""
    device = resolve_device(device)
    return BlockSparseMatrix(
        data=_tensor(data, device),
        block_rows=_tensor(block_rows, device),
        block_cols=_tensor(block_cols, device),
        shape=tuple(int(s) for s in shape),
        padded_shape=tuple(int(s) for s in padded_shape),
        num_real_blocks=int(num_real_blocks),
    )


def device_problem_from_arrays(arrays: Mapping, device="cuda"
                               ) -> DeviceProblem:
    """``arrays`` holds one entry per DeviceProblem field: for ``a`` and
    ``at`` a mapping with the keyword arguments of
    ``block_sparse_from_arrays``, else a numpy array (0-d for the norms)."""
    device = resolve_device(device)
    fields = {}
    for name in DeviceProblem._fields:
        v = arrays[name]
        if name in ("a", "at"):
            fields[name] = block_sparse_from_arrays(**v, device=device)
        else:
            fields[name] = _tensor(v, device)
    return DeviceProblem(**fields)


def state_from_arrays(arrays: Mapping, device="cuda",
                      batched: bool = False) -> PdhgState:
    """``arrays`` holds one numpy array per PdhgState field; with
    ``batched``, a batch whose scalars are [B] (made [B, 1])."""
    device = resolve_device(device)

    def field(v):
        t = _tensor(v, device)
        return t[:, None] if batched and t.dim() == 1 else t

    return PdhgState(**{name: field(arrays[name])
                        for name in PdhgState._fields})
