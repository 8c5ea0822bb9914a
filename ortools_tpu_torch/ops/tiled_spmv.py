"""Block-row SpMV: the wrappers of the two CUDA kernels and their plain
PyTorch versions (port of ``ortools_tpu/ops/tiled_spmv.py``).

The TPU module packs blocks into chunked super-tiles and gathers and
scatters them with one-hot MXU matmuls, because the TPU has no cheap
dynamic indexing.  The card has, so the port keeps the matrix's own blocks
and adds a block-row CSR index over them (``BlockRowLayout``):

- blocks sorted by (block_row, block_col);
- ``row_ptr`` of length ``M/bm + 1``: the blocks of block-row ``r`` are
  ``row_ptr[r] .. row_ptr[r+1]``;
- ``block_cols`` and ``data [nb, bm, bn]`` as the matrix stores them, plus
  an optional bf16 copy of ``data`` for the fast stream.

``tiled_matvec`` launches ``block_spmv_exact`` (``csrc/block_spmv.cu``)
on a CUDA tensor and ``tiled_matvec_fast`` launches ``block_spmv_fast``.
On a CPU tensor each runs its plain version (gather + batched block
mat-vec + ``index_add_``), which is also what the tests and
``chip_smoke.py`` hold the kernels against.  Each wrapper counts its
kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

# Block dims the CUDA kernels are instantiated for (csrc/block_spmv.cu).
KERNEL_BLOCK_DIMS = (8, 32, 128)
_MAX_GROUPS = 8


class BlockRowLayout(NamedTuple):
    """Block-row CSR index over a matrix's (sorted) blocks; the tensors are
    shared with the BlockSparseMatrix, not copied."""

    row_ptr: torch.Tensor  # int32 [num_block_rows + 1]
    block_rows: torch.Tensor  # int32 [nb], sorted (plain version)
    block_cols: torch.Tensor  # int32 [nb]
    data: torch.Tensor  # [nb, bm, bn]
    data_hi: Optional[torch.Tensor]  # bf16 [nb, bm, bn]: the fast stream
    groups: int  # 128-thread groups sharing one block-row in the kernel
    num_block_cols: int  # x has num_block_cols * bn entries

    @property
    def block_shape(self):
        return int(self.data.shape[1]), int(self.data.shape[2])

    @property
    def num_block_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1


def block_row_order(block_rows: np.ndarray,
                    block_cols: np.ndarray) -> np.ndarray:
    """Stable permutation sorting blocks by (block_row, block_col)."""
    return np.lexsort((block_cols, block_rows))


def make_layout(data: torch.Tensor, block_rows: torch.Tensor,
                block_cols: torch.Tensor, padded_shape, hi: bool = False,
                ) -> BlockRowLayout:
    """Layout over blocks already sorted by (row, col); with ``hi`` also
    the bf16 copy of the blocks (round to nearest even, as the TPU
    module's ``with_hi``)."""
    bm, bn = int(data.shape[1]), int(data.shape[2])
    num_block_rows = padded_shape[0] // bm
    rows = block_rows.detach().cpu().numpy().astype(np.int64)
    nb = int(rows.shape[0])
    counts = np.bincount(rows, minlength=num_block_rows)
    row_ptr = np.zeros(num_block_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    per_row = -(-nb // max(1, num_block_rows))
    groups = 1
    while groups < min(per_row, _MAX_GROUPS):
        groups *= 2
    return BlockRowLayout(
        row_ptr=torch.as_tensor(row_ptr, device=data.device),
        block_rows=block_rows,
        block_cols=block_cols,
        data=data,
        data_hi=data.to(torch.bfloat16) if hi else None,
        groups=groups,
        num_block_cols=padded_shape[1] // bn,
    )


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def block_product(data: torch.Tensor, block_rows: torch.Tensor,
                  block_cols: torch.Tensor, x: torch.Tensor,
                  num_block_rows: int) -> torch.Tensor:
    """y = A x over block-COO arrays: gather each block's x segment,
    batched (bm x bn) mat-vec, scatter-add into the block rows (the
    PyTorch form of ``ortools_tpu/ops/block_sparse.py::_block_matvec``)."""
    bm, bn = int(data.shape[1]), int(data.shape[2])
    xb = x.reshape(-1, bn).index_select(0, block_cols)  # [nb, bn]
    prod = torch.bmm(data, xb.unsqueeze(-1)).squeeze(-1)  # [nb, bm]
    y = torch.zeros(num_block_rows, bm, dtype=x.dtype, device=x.device)
    y.index_add_(0, block_rows, prod)
    return y.reshape(num_block_rows * bm)


def tiled_matvec_plain(t: BlockRowLayout, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_spmv_exact``."""
    return block_product(t.data, t.block_rows, t.block_cols, x,
                         t.num_block_rows)


def tiled_matvec_fast_plain(t: BlockRowLayout,
                            x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_spmv_fast``: bf16 blocks and bf16-rounded
    x, multiplied and summed in f32."""
    xr = x.to(torch.bfloat16).to(torch.float32)
    return block_product(t.data_hi.to(torch.float32), t.block_rows,
                         t.block_cols, xr, t.num_block_rows)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(t: BlockRowLayout, data: torch.Tensor, x: torch.Tensor,
           x_dtype: torch.dtype) -> None:
    bm, bn = t.block_shape
    if bm not in KERNEL_BLOCK_DIMS or bn not in KERNEL_BLOCK_DIMS:
        raise ValueError(
            f"block shape {(bm, bn)} has no CUDA kernel; block dims must be "
            f"in {KERNEL_BLOCK_DIMS}")
    if x.dtype != x_dtype:
        raise TypeError(f"x is {x.dtype}, the kernel takes {x_dtype}")
    if x.dim() != 1 or x.shape[0] != t.num_block_cols * bn:
        raise ValueError(f"x must be the padded length-{t.num_block_cols * bn}"
                         f" vector, got shape {tuple(x.shape)}")
    for name, v in (("x", x), ("data", data), ("row_ptr", t.row_ptr),
                    ("block_cols", t.block_cols)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t.row_ptr.dtype != torch.int32 or t.block_cols.dtype != torch.int32:
        raise TypeError("row_ptr and block_cols must be int32")


def _launch(fn, t: BlockRowLayout, data: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> None:
    bm, bn = t.block_shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.c_void_p(t.row_ptr.data_ptr()),
             ctypes.c_void_p(t.block_cols.data_ptr()),
             ctypes.c_void_p(data.data_ptr()),
             ctypes.c_void_p(x.data_ptr()),
             ctypes.c_void_p(y.data_ptr()),
             t.num_block_rows, bm, bn, t.groups, x.device.index,
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def tiled_matvec(t: BlockRowLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A x, exact, in the matrix's dtype (f32 or f64); x is the padded
    length-N vector, y the padded length-M vector."""
    if x.device.type == "cpu":
        return tiled_matvec_plain(t, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from ortools_tpu_torch.ops import _build

    lib = _build.library()
    if t.data.dtype == torch.float32:
        fn = lib.block_spmv_exact_f32
    elif t.data.dtype == torch.float64:
        fn = lib.block_spmv_exact_f64
    else:
        raise TypeError(f"no exact kernel for {t.data.dtype}")
    _check(t, t.data, x, t.data.dtype)
    y = torch.empty(t.num_block_rows * t.block_shape[0], dtype=x.dtype,
                    device=x.device)
    _launch(fn, t, t.data, x, y)
    tiled_matvec.launches += 1
    return y


def tiled_matvec_fast(t: BlockRowLayout, x: torch.Tensor) -> torch.Tensor:
    """y ~= A x through the bf16 copy of the blocks (requires data_hi);
    x is f32, rounded to bf16 inside; y is f32."""
    if t.data_hi is None:
        raise ValueError("the layout has no bf16 copy (make_layout(hi=True))")
    if x.device.type == "cpu":
        return tiled_matvec_fast_plain(t, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from ortools_tpu_torch.ops import _build

    lib = _build.library()
    _check(t, t.data_hi, x, torch.float32)
    y = torch.empty(t.num_block_rows * t.block_shape[0], dtype=x.dtype,
                    device=x.device)
    _launch(lib.block_spmv_fast_bf16, t, t.data_hi, x, y)
    tiled_matvec_fast.launches += 1
    return y


tiled_matvec.launches = 0
tiled_matvec_fast.launches = 0
