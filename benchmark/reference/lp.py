"""An LP instance as the reference holds it: COO arrays and bound vectors,
so that judging needs NumPy alone.

    min c.x  s.t.  con_lo <= A x <= con_hi,  var_lo <= x <= var_hi.

A generator (``reference/generators/<name>.py``) makes it from a seed.
``branch_columns`` are the columns a branch-and-bound node may close (its
upper bound set to 0), empty where the instance has none; ``data`` keeps
what the generator's own feasibility certificate reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Instance:
    m: int
    n: int
    rows: np.ndarray  # int64 [nnz]
    cols: np.ndarray  # int64 [nnz]
    vals: np.ndarray  # float64 [nnz]
    c: np.ndarray
    con_lo: np.ndarray
    con_hi: np.ndarray
    var_lo: np.ndarray
    var_hi: np.ndarray
    name: str
    branch_columns: np.ndarray
    data: dict

    @property
    def nnz(self) -> int:
        return int(self.vals.size)


def matvec(inst: Instance, x: np.ndarray) -> np.ndarray:
    return np.bincount(inst.rows, weights=inst.vals * x[inst.cols],
                       minlength=inst.m)


def rmatvec(inst: Instance, y: np.ndarray) -> np.ndarray:
    return np.bincount(inst.cols, weights=inst.vals * y[inst.rows],
                       minlength=inst.n)
