"""Accurate f32 reductions (counterparts of ``sum_df32`` and ``vdot_df32``
of ``ortools_tpu/ops/df32.py``).

The JAX package carries a compensated double-f32 sum because f64 is
emulated on the TPU.  The H100 has f64 natively, so the port keeps the
names and accumulates in float64, rounding the result to the input dtype
once.  The PDHG objective-gap reductions in f32 use these.
"""

from __future__ import annotations

import torch


def sum_df32(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.float64).to(x.dtype)


def vdot_df32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.to(torch.float64), y.to(torch.float64)).to(x.dtype)
