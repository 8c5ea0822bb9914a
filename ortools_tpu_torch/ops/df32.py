"""Reductions of the PDHG device functions over the last axis: accurate f32
sums (counterparts of ``sum_df32`` and ``vdot_df32`` of
``ortools_tpu/ops/df32.py``) and the plain dot, sum, max and norm.

The JAX package carries a compensated double-f32 sum because f64 is
emulated on the TPU.  The H100 has f64 natively, so the port keeps the
names and accumulates in float64, rounding the result to the input dtype
once.  The PDHG objective-gap reductions in f32 use these.

The JAX package runs a batch of instances by ``jax.vmap``; the port writes
the batch axis out.  A vector is ``[N]`` for one instance and ``[B, N]``
for B instances, and a reduction runs over the last axis.  On 1-D inputs
each function makes the same torch call as the single-instance code always
has (``torch.dot``, ``torch.sum``, ...), so that path keeps its numbers bit
for bit; on 2-D ones it keeps the reduced axis, so that a per-instance
scalar is ``[B, 1]`` and broadcasts against ``[B, N]``.  A 1-D operand of a
2-D one (a vector of the shared problem) broadcasts over the batch.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return (a * b).sum(-1, keepdim=True)


def vsum(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 1:
        return torch.sum(x)
    return x.sum(-1, keepdim=True)


def vmax(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 1:
        return torch.max(x)
    return x.amax(-1, keepdim=True)


def vnorm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm (``torch.linalg.vector_norm``)."""
    if x.dim() == 1:
        return torch.linalg.vector_norm(x)
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def sum_df32(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 1:
        return x.sum(dtype=torch.float64).to(x.dtype)
    return x.sum(-1, keepdim=True, dtype=torch.float64).to(x.dtype)


def vdot_df32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return dot(x.to(torch.float64), y.to(torch.float64)).to(x.dtype)
