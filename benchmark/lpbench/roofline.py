"""The yardstick of the kernel rooflines: the card's peaks and the work a
product needs.

Work is what the inputs need, so that a change of layout cannot move it:
each nonzero of the matrix read once, each vector element read or written
once, in the configuration's precision (``value_bytes`` in a kernel's file
names the launches that read the matrix in another).  The stored blocks
and their padding are not counted.  A launch's bound is the larger of its
bytes over the HBM rate and its operations over the peak rate; a kernel's
roofline share is the sum of its launches' bounds over the sum of their
times.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.  The float32
# peak is the 3xTF32 rate (495 / 3), above the 67 TFLOP/s of the plain
# float32 units, so that no exact float32 implementation can read over
# 100%.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 165e12, "bfloat16": 989e12}
DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2}


def spmv(shape: dict, value_bytes: int, vec_bytes: int):
    """y = A x or x = A^T y: (bytes, operations)."""
    return (shape["nnz"] * value_bytes + (shape["m"] + shape["n"]) * vec_bytes,
            2 * shape["nnz"])


def spmm(shape: dict, value_bytes: int, vec_bytes: int):
    """Y = A X over a batch of B vectors: (bytes, operations)."""
    b = shape["batch"]
    return (shape["nnz"] * value_bytes + b * (shape["m"] + shape["n"]) * vec_bytes,
            2 * shape["nnz"] * b)


WORK = {"spmv": spmv, "spmm": spmm}


def count_nonzeros(matrix) -> int:
    """The nonzeros of a scipy sparse matrix in any layout (CSR, BSR,
    COO): values stored as zeros do not count."""
    return int(np.count_nonzero(matrix.tocoo().data))


def launch_bound_s(name: str, kernel: dict, shape: dict, dtype: str) -> float:
    """The least time one launch of ``kernel`` (named ``name``) needs."""
    value_bytes = DTYPE_BYTES[dtype]
    for part, nbytes in kernel.get("value_bytes", {}).items():
        if part in name:
            value_bytes = nbytes
    nbytes, ops = WORK[kernel["work"]](shape, value_bytes, DTYPE_BYTES[dtype])
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def share(events: Iterable, kernel: dict, shape: dict,
          dtype: str) -> Optional[float]:
    """The roofline share in % of the launches in ``events`` ((name,
    start_s, seconds) of device operations) whose name matches the
    kernel's ``pattern``; None where none does."""
    pat = re.compile(kernel["pattern"])
    bound = spent = 0.0
    for name, _, seconds in events:
        if pat.search(name):
            bound += launch_bound_s(name, kernel, shape, dtype)
            spent += seconds
    if spent <= 0.0:
        return None
    return 100.0 * bound / spent
