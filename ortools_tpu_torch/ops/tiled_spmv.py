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
  an optional bf16 copy of ``data`` for the fast stream;
- ``schedule``, the order in which the kernels take the block-rows: the
  long rows first, then the short ones, each longest first
  (``row_schedule``), one (block-row, first block, end block, 0) entry
  each, so that a kernel finds a row's blocks in one 16-byte load.  A
  short row goes to one warp, a long one to one thread block;
- ``spmm_schedule``, the SpMM kernel's work items (``spmm_schedule``):
  short block-rows grouped, tall blocks split into slices of rows.

``tiled_matvec`` launches ``block_spmv_exact`` (``csrc/block_spmv.cu``)
on a CUDA tensor and ``tiled_matvec_fast`` launches ``block_spmv_fast``;
``tiled_matmat``, the product of a batch of vectors (``[B, N]`` in,
``[B, M]`` out), launches ``block_spmm_exact`` (``csrc/block_spmm.cu``).
On a CPU tensor each runs its plain version (gather + batched block
mat-vec + ``index_add_``), which is also what the tests and
``chip_smoke.py`` hold the kernels against.  Each wrapper counts its
kernel launches in ``.launches``; a CUDA graph that captured launches adds
them there at each replay (``count_launches``).

A matrix of low fill also gets a row layout of its nonzeros alone
(``RowLayout``: CSR values in the matrix's dtype, int32 column indices,
int32 row pointers over the padded rows, and the rows binned by length
for teams of 1 to 32 lanes), where it reads at most half the bytes of the
stored blocks (``prefer_rows``).  ``rows_matvec`` launches
``block_spmv_rows`` (``csrc/block_spmv.cu``) on it, the exact 1-D product;
its plain version gathers x and sums each row with ``index_add_``.
``rows_matmat`` launches ``block_spmm_rows`` (``csrc/block_spmm.cu``), the
product of a batch of vectors over the same layout, where it moves fewer
bytes than the block SpMM (``prefer_rows_batched``); its plain version
gathers the columns of X and sums each row with ``index_add_``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

# Block dims the CUDA kernels are instantiated for (csrc/block_spmv.cu).
KERNEL_BLOCK_DIMS = (8, 32, 128)
# A block-row goes to one warp when its blocks are at most WARP_BLOCK_BYTES
# each (the kernel's limit: 8 loads of 16 bytes per lane per block) and at
# most WARP_ROW_BYTES in all; otherwise it is long and goes to a thread
# block of 256 threads.
WARP_BLOCK_BYTES = 4096
WARP_ROW_BYTES = 65536
# The SpMM's work items (``spmm_schedule``, csrc/block_spmm.cu): an item
# takes at most SPMM_ROWS rows of each of its blocks, so a block-row of
# taller blocks is split into row slices, one item each.  Block-rows of
# blocks at most SPMM_ROWS tall are grouped, consecutive, into items of at
# most SPMM_ITEM_ENTRIES stored entries or one block (a longer row is an
# item of its own) and at most SPMM_ITEM_ROWS block-rows.
SPMM_ROWS = 32
SPMM_ITEM_ENTRIES = 2 * 1024
SPMM_ITEM_ROWS = 64
# The row kernel's teams (csrc/block_spmv.cu, block_spmv_kernel_rows): a
# row of the row layout goes to a team of ROW_LANES[i] lanes, the fewest
# that leave each lane at most ROW_LANE_NNZ of its nonzeros (32 at most);
# the bins are in this order, widest first.
ROW_LANES = (32, 16, 8, 4, 2, 1)
ROW_LANE_NNZ = 4


class BlockRowLayout(NamedTuple):
    """Block-row CSR index over a matrix's (sorted) blocks; the tensors are
    shared with the BlockSparseMatrix, not copied."""

    row_ptr: torch.Tensor  # int32 [num_block_rows + 1]
    block_rows: torch.Tensor  # int32 [nb], sorted (plain version)
    block_cols: torch.Tensor  # int32 [nb]
    data: torch.Tensor  # [nb, bm, bn]
    data_hi: Optional[torch.Tensor]  # bf16 [nb, bm, bn]: the fast stream
    schedule: torch.Tensor  # int32 [num_block_rows, 4]: long, then short
    num_long: int  # the first num_long rows of the schedule are long
    num_block_cols: int  # x has num_block_cols * bn entries
    spmm_schedule: torch.Tensor  # int32 [num_items, 4]: the SpMM's items

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


def row_schedule(counts: np.ndarray, block_bytes: int):
    """The kernels' order of the block-rows, from their lengths in blocks
    (``counts``) and the bytes of one block: returns ``(schedule,
    num_long)``.  A row is long when a warp should not take it (see
    ``WARP_BLOCK_BYTES``, ``WARP_ROW_BYTES``); long rows come first, then
    short ones, each longest first (a stable sort, so the schedule is a
    function of ``counts``)."""
    counts = np.asarray(counts, dtype=np.int64)
    long_rows = ((counts * block_bytes > WARP_ROW_BYTES)
                 | (block_bytes > WARP_BLOCK_BYTES))
    order = np.lexsort((-counts, ~long_rows))
    return order.astype(np.int32), int(long_rows.sum())


def schedule_table(order: np.ndarray, row_ptr: np.ndarray) -> np.ndarray:
    """The kernels' schedule: (block-row, first block, end block, 0) for
    each block-row in ``order``; int32 [len(order), 4]."""
    order = np.asarray(order, dtype=np.int64)
    table = np.zeros((order.size, 4), dtype=np.int32)
    table[:, 0] = order
    table[:, 1] = row_ptr[order]
    table[:, 2] = row_ptr[order + 1]
    return table


def spmm_schedule(counts: np.ndarray, block_shape) -> np.ndarray:
    """The SpMM kernel's work items, from the block-rows' lengths in blocks
    (``counts``) and the block shape: int32 [num_items, 4] of (first
    block-row, end block-row, first row within the blocks, 0).  An item
    covers every row of its block-rows from its first row on, at most
    ``SPMM_ROWS`` of them, and all their blocks; every row of the matrix
    lies in exactly one item.

    - Blocks taller than ``SPMM_ROWS``: one item per block-row and slice of
      ``SPMM_ROWS`` rows, so that a long row of tall blocks keeps several
      SMs busy; the slices of a row read its blocks' x segments again, from
      L2.
    - Otherwise consecutive block-rows are grouped: an item closes before
      the row that would take it past ``SPMM_ITEM_ENTRIES`` stored entries
      (one block, where a block holds more) or ``SPMM_ITEM_ROWS`` rows, so
      each item pays one start-up for several short rows.

    Items are ordered by their blocks, most first (a stable sort, so the
    table is a function of ``counts`` and the block shape), so that the
    longest start first."""
    counts = np.asarray(counts, dtype=np.int64)
    bm, bn = block_shape
    rows = min(bm, SPMM_ROWS)
    if counts.size == 0:
        return np.zeros((0, 4), dtype=np.int32)
    if rows < bm:
        slices = np.arange(0, bm, rows)
        first = np.repeat(np.arange(counts.size), slices.size)
        items = np.stack([first, first + 1, np.tile(slices, counts.size)], 1)
        blocks = counts[first]
    else:
        limit = max(1, SPMM_ITEM_ENTRIES // (bm * bn))
        starts, blocks, held, start = [], [], 0, 0
        for r, c in enumerate(counts.tolist()):
            if r > start and (held + c > limit
                              or r - start == SPMM_ITEM_ROWS):
                starts.append(start)
                blocks.append(held)
                start, held = r, 0
            held += c
        starts.append(start)
        blocks.append(held)
        first = np.asarray(starts, dtype=np.int64)
        end = np.append(first[1:], counts.size)
        items = np.stack([first, end, np.zeros_like(first)], 1)
        blocks = np.asarray(blocks, dtype=np.int64)
    table = np.zeros((len(items), 4), dtype=np.int32)
    table[:, :3] = items[np.argsort(-blocks, kind="stable")]
    return table


def make_layout(data: torch.Tensor, block_rows: torch.Tensor,
                block_cols: torch.Tensor, padded_shape, hi: bool = False,
                ) -> BlockRowLayout:
    """Layout over blocks already sorted by (row, col); with ``hi`` also
    the bf16 copy of the blocks (round to nearest even, as the TPU
    module's ``with_hi``).  The schedule is worked out for ``data``'s
    element size; the bf16 copy's blocks are half as large, so it holds
    for them too."""
    bm, bn = int(data.shape[1]), int(data.shape[2])
    num_block_rows = padded_shape[0] // bm
    rows = block_rows.detach().cpu().numpy().astype(np.int64)
    counts = np.bincount(rows, minlength=num_block_rows)
    row_ptr = np.zeros(num_block_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    order, num_long = row_schedule(
        counts, bm * bn * data.element_size())
    return BlockRowLayout(
        row_ptr=torch.as_tensor(row_ptr, device=data.device),
        block_rows=block_rows,
        block_cols=block_cols,
        data=data,
        data_hi=data.to(torch.bfloat16) if hi else None,
        schedule=torch.as_tensor(schedule_table(order, row_ptr),
                                 device=data.device),
        num_long=num_long,
        num_block_cols=padded_shape[1] // bn,
        spmm_schedule=torch.as_tensor(spmm_schedule(counts, (bm, bn)),
                                      device=data.device),
    )


# ---------------------------------------------------------------------------
# The row layout
# ---------------------------------------------------------------------------


class RowLayout(NamedTuple):
    """A matrix's nonzeros alone, row by row (CSR), over its padded rows,
    the rows stored in the row kernel's order: bin by bin
    (``row_bins``), so that the rows of a bin are one run of memory."""

    row_ptr: torch.Tensor  # int32 [M + 1] over the stored rows
    cols: torch.Tensor  # int32 [nnz]
    values: torch.Tensor  # [nnz], the matrix's dtype
    order: torch.Tensor  # int32 [M]: the matrix row of each stored row
    bin_rows: Tuple[int, ...]  # rows in each bin, one a ROW_LANES entry
    num_cols: int  # x has num_cols entries

    @property
    def num_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])


def row_bins(lengths: np.ndarray):
    """The row kernel's schedule, from the rows' lengths in nonzeros:
    returns ``(order, bin_rows)``.  Row r goes to the bin of the fewest
    ``ROW_LANES`` that leave each lane at most ``ROW_LANE_NNZ`` nonzeros
    (the widest bin takes the rest); ``order`` lists the rows bin by bin,
    widest first, each bin in row order (a stable sort, so the schedule is
    a function of the lengths), and ``bin_rows`` counts each bin's rows.
    Empty rows go to the one-lane bin, which writes their zeros."""
    lengths = np.asarray(lengths, dtype=np.int64)
    need = -(-lengths // ROW_LANE_NNZ)  # lanes at ROW_LANE_NNZ each
    bins = np.zeros(lengths.size, dtype=np.int64)  # index into ROW_LANES
    for i, lanes in enumerate(ROW_LANES[1:], start=1):
        bins[need <= lanes] = i
    order = np.argsort(bins, kind="stable").astype(np.int32)
    counts = np.bincount(bins, minlength=len(ROW_LANES))
    return order, tuple(int(c) for c in counts)


def prefer_rows(nnz: int, num_rows: int, num_blocks: int, block_shape,
                value_bytes: int) -> bool:
    """Whether the row layout reads at most half the bytes of the stored
    blocks: values and column indices of each nonzero and the row
    pointers, against every stored entry of every block.

    The half comes from both exact kernels timed on the same 8x128-block
    matrices at and around it (``chip_smoke.py::boundary_times``; H100,
    L2-cold; two calls).  At the half, the row kernel took 0.36-0.70 of
    the block kernel's time on matrices of many rows, and 1.13-1.20 on
    1,024 rows of about 2,700 nonzeros, one warp each.  Those rows reach the block
    kernel's time at about 0.42 of its bytes, the others at 0.8 to past 1.
    In f32 the blocks' bf16 stream reads half their bytes again, and the
    row kernel reached its time at 0.2-0.55.  At 1, the long rows took 2.0
    times the block kernel's time and 1.5-3.3 times the bf16 stream's; at
    0.4, matrices of many rows would keep blocks that take 1.5-2.7 times
    the row kernel's."""
    bm, bn = block_shape
    return (nnz * (value_bytes + 4) + 4 * (num_rows + 1)
            <= num_blocks * bm * bn * value_bytes / 2)


# The batched row kernel against the block SpMM: the row layout is taken
# where its bytes through L2 are at most ROWS_BATCHED_SHARE of the blocks'
# (``prefer_rows_batched``).
ROWS_BATCHED_SHARE = 1.0


def prefer_rows_batched(nnz: int, num_rows: int, num_blocks: int,
                        block_shape, value_bytes: int, batch: int) -> bool:
    """Whether the batched row kernel should take a product of ``batch``
    vectors: its bytes through L2 against the block SpMM's, times
    ``ROWS_BATCHED_SHARE``.  The blocks: every stored entry, and each
    block's x segment for every instance (``bn * batch`` values), which
    the block kernel gathers.  The rows: values and column indices of the
    nonzeros, the row pointers, and for each nonzero the ``batch`` values
    of its column of X, one row of the kernel's Xᵀ.  Both write Y once,
    and the rows' staging reads X once more, neither counted.

    The share comes from both kernels timed on the same matrices of 8x128
    blocks and their transposes at fills of 1/16 to 1/2, at B = 8 and 64,
    in f32 and f64 (``chip_smoke.py::boundary_times``; H100, L2-cold).
    On rows of up to 64 nonzeros the times meet where the rows' bytes are
    0.6-1.0 of the 8x128 blocks' (0.55-1.0 for their transposes at B = 8,
    but 2.7-3.5 at B = 64: the block kernel's time on 128x8 blocks does
    not follow their bytes).  A share of 0.75 would lose the least over
    the matrices swept, but it would give the blocks to the Aᵀ of a
    multicommodity flow LP (30 nodes, 520 arcs, 100 commodities) at
    B = 64, whose bytes read 0.78 and whose rows take 0.34 of the blocks'
    time; at 1.0 the short rows swept lose at most 1.43 times (a 128x8
    transpose at B = 8), as at 0.75.  On 1,024 rows of 512 to 4,096
    nonzeros, one warp each, the row kernel took 1.0-2.0 times the block
    SpMM's time already at a third to a half of its bytes, and 2.0-2.5
    times at 0.9 of them: no share keeps those on the blocks without
    giving up the others.  The node LPs' relaxation reads 0.09 (A) and
    0.52 (Aᵀ) at B = 64, and its row kernel takes 0.20 and 0.08 of the
    block SpMM's time."""
    bm, bn = block_shape
    s = value_bytes
    blocks = num_blocks * bn * (bm + batch) * s
    rows = nnz * (s + 4 + batch * s) + 4 * (num_rows + 1)
    return rows <= ROWS_BATCHED_SHARE * blocks


def make_row_layout(csr, num_rows: int, num_cols: int, dtype: torch.dtype,
                    device) -> RowLayout:
    """The row layout of a scipy sparse matrix of at most ``num_rows`` x
    ``num_cols`` (the padded shape; the rows past the matrix's are empty),
    its values cast to ``dtype``.  Duplicates are summed and stored zeros
    dropped first, as the block layout holds them."""
    csr = csr.tocsr(copy=True)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    m, n = csr.shape
    if m > num_rows or n > num_cols:
        raise ValueError(f"a {m} x {n} matrix does not fit {num_rows} x "
                         f"{num_cols}")
    if csr.nnz >= 2 ** 31:
        raise ValueError(f"{csr.nnz} nonzeros overflow the int32 indices")
    indptr = np.full(num_rows + 1, csr.nnz, dtype=np.int64)
    indptr[:m + 1] = csr.indptr
    order, bin_rows = row_bins(np.diff(indptr))
    stored = sp.csr_matrix((csr.data, csr.indices, indptr),
                           shape=(num_rows, num_cols))[order]
    return RowLayout(
        row_ptr=torch.as_tensor(stored.indptr.astype(np.int32),
                                device=device),
        cols=torch.as_tensor(stored.indices.astype(np.int32), device=device),
        values=torch.as_tensor(stored.data, dtype=dtype, device=device),
        order=torch.as_tensor(order, device=device),
        bin_rows=bin_rows,
        num_cols=num_cols,
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


def block_product_batched(data: torch.Tensor, block_rows: torch.Tensor,
                          block_cols: torch.Tensor, x: torch.Tensor,
                          num_block_rows: int) -> torch.Tensor:
    """Y[b] = A X[b] for X [B, N] over block-COO arrays: gather each
    block's segment of every instance, one (bm x bn) by (bn x B) product
    per block, scatter-add into the block rows; returns [B, M] (the
    PyTorch form of ``ortools_tpu/ops/block_sparse.py::_block_matmat``,
    with the batch leading)."""
    bm, bn = int(data.shape[1]), int(data.shape[2])
    batch = int(x.shape[0])
    xb = x.reshape(batch, -1, bn).index_select(1, block_cols)  # [B, nb, bn]
    prod = torch.bmm(data, xb.permute(1, 2, 0))  # [nb, bm, B]
    y = torch.zeros(num_block_rows, bm, batch, dtype=x.dtype,
                    device=x.device)
    y.index_add_(0, block_rows, prod)
    return y.reshape(num_block_rows * bm, batch).t().contiguous()


def tiled_matvec_plain(t: BlockRowLayout, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_spmv_exact``."""
    return block_product(t.data, t.block_rows, t.block_cols, x,
                         t.num_block_rows)


def tiled_matmat_plain(t: BlockRowLayout, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_spmm_exact``."""
    return block_product_batched(t.data, t.block_rows, t.block_cols, x,
                                 t.num_block_rows)


def tiled_matvec_fast_plain(t: BlockRowLayout,
                            x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_spmv_fast``: bf16 blocks and bf16-rounded
    x, multiplied and summed in f32."""
    xr = x.to(torch.bfloat16).to(torch.float32)
    return block_product(t.data_hi.to(torch.float32), t.block_rows,
                         t.block_cols, xr, t.num_block_rows)


def rows_matvec_plain(t: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_spmv_rows``: each nonzero times its x
    entry, summed into its row."""
    lengths = (t.row_ptr[1:] - t.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(t.order.long(), lengths)
    y = torch.zeros(t.num_rows, dtype=x.dtype, device=x.device)
    y.index_add_(0, rows, t.values * x.index_select(0, t.cols.long()))
    return y


def rows_matmat_plain(t: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_spmm_rows``: for X [B, N], each nonzero
    times its column of X, summed into its row; returns [B, M]."""
    lengths = (t.row_ptr[1:] - t.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(t.order.long(), lengths)
    y = torch.zeros(int(x.shape[0]), t.num_rows, dtype=x.dtype,
                    device=x.device)
    y.index_add_(1, rows, x.index_select(1, t.cols.long()) * t.values)
    return y


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(t: BlockRowLayout, data: torch.Tensor, x: torch.Tensor,
           x_dtype: torch.dtype, batched: bool = False) -> None:
    """Raise on what the kernels do not take; the SpMV kernels read the
    row schedule, the SpMM its work items and ``row_ptr``."""
    schedule = t.spmm_schedule if batched else t.schedule
    bm, bn = t.block_shape
    if bm not in KERNEL_BLOCK_DIMS or bn not in KERNEL_BLOCK_DIMS:
        raise ValueError(
            f"block shape {(bm, bn)} has no CUDA kernel; block dims must be "
            f"in {KERNEL_BLOCK_DIMS}")
    if x.dtype != x_dtype:
        raise TypeError(f"x is {x.dtype}, the kernel takes {x_dtype}")
    n = t.num_block_cols * bn
    if batched:
        if x.dim() != 2 or x.shape[1] != n:
            raise ValueError(f"x must be [B, {n}] (B padded vectors), got "
                             f"shape {tuple(x.shape)}")
    elif x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"x must be the padded length-{n} vector, got "
                         f"shape {tuple(x.shape)}")
    index = [("block_cols", t.block_cols), ("schedule", schedule)]
    if batched:
        index.append(("row_ptr", t.row_ptr))
    for name, v in [("x", x), ("data", data)] + index:
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(v.dtype != torch.int32 for _, v in index):
        raise TypeError("block_cols, schedule and row_ptr must be int32")
    for name, v in (("x", x), ("data", data), ("schedule", schedule)):
        if v.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             f"read it in 16-byte chunks)")


def _launch(fn, t: BlockRowLayout, data: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> None:
    bm, bn = t.block_shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.c_void_p(t.schedule.data_ptr()),
             ctypes.c_void_p(t.block_cols.data_ptr()),
             ctypes.c_void_p(data.data_ptr()),
             ctypes.c_void_p(x.data_ptr()),
             ctypes.c_void_p(y.data_ptr()),
             t.num_block_rows, t.num_long, bm, bn, x.device.index,
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

    lib = _build.library("block_spmv")
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

    lib = _build.library("block_spmv")
    _check(t, t.data_hi, x, torch.float32)
    y = torch.empty(t.num_block_rows * t.block_shape[0], dtype=x.dtype,
                    device=x.device)
    _launch(lib.block_spmv_fast_bf16, t, t.data_hi, x, y)
    tiled_matvec_fast.launches += 1
    return y


def tiled_matmat(t: BlockRowLayout, x: torch.Tensor) -> torch.Tensor:
    """Y = X Aᵀ, that is Y[b] = A X[b], exact, in the matrix's dtype (f32
    or f64); x is [B, N] (B padded vectors, contiguous), y is [B, M]."""
    if x.device.type == "cpu":
        return tiled_matmat_plain(t, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from ortools_tpu_torch.ops import _build

    lib = _build.library("block_spmm")
    if t.data.dtype == torch.float32:
        fn = lib.block_spmm_exact_f32
    elif t.data.dtype == torch.float64:
        fn = lib.block_spmm_exact_f64
    else:
        raise TypeError(f"no exact kernel for {t.data.dtype}")
    _check(t, t.data, x, t.data.dtype, batched=True)
    items = t.spmm_schedule
    bm, bn = t.block_shape
    batch, m = int(x.shape[0]), t.num_block_rows * bm
    y = torch.empty(batch, m, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.c_void_p(items.data_ptr()),
             ctypes.c_void_p(t.row_ptr.data_ptr()),
             ctypes.c_void_p(t.block_cols.data_ptr()),
             ctypes.c_void_p(t.data.data_ptr()),
             ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
             int(items.shape[0]), t.num_block_rows, bm, bn, batch,
             int(x.shape[1]), m, x.device.index, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    tiled_matmat.launches += 1
    return y


def _check_rows(t: RowLayout, x: torch.Tensor, batched: bool) -> None:
    """Raise on what the row kernels do not take: x of the layout's dtype,
    the padded length-N vector (or [B, N] with ``batched``), everything
    contiguous on x's device, int32 indices."""
    if x.dtype != t.values.dtype:
        raise TypeError(f"x is {x.dtype}, the kernel takes {t.values.dtype}")
    if batched:
        if x.dim() != 2 or x.shape[1] != t.num_cols:
            raise ValueError(f"x must be [B, {t.num_cols}] (B padded "
                             f"vectors), got shape {tuple(x.shape)}")
    elif x.dim() != 1 or x.shape[0] != t.num_cols:
        raise ValueError(f"x must be the padded length-{t.num_cols} vector, "
                         f"got shape {tuple(x.shape)}")
    for name, v in (("x", x), ("values", t.values), ("row_ptr", t.row_ptr),
                    ("cols", t.cols), ("order", t.order)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(v.dtype != torch.int32 for v in (t.row_ptr, t.cols, t.order)):
        raise TypeError("row_ptr, cols and order must be int32")


def rows_matvec(t: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A x over the row layout, exact, in the matrix's dtype (f32 or
    f64); x is the padded length-N vector, y the padded length-M
    vector."""
    if x.device.type == "cpu":
        return rows_matvec_plain(t, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from ortools_tpu_torch.ops import _build

    lib = _build.library("block_spmv")
    if t.values.dtype == torch.float32:
        fn = lib.block_spmv_rows_f32
    elif t.values.dtype == torch.float64:
        fn = lib.block_spmv_rows_f64
    else:
        raise TypeError(f"no row kernel for {t.values.dtype}")
    _check_rows(t, x, batched=False)
    y = torch.empty(t.num_rows, dtype=x.dtype, device=x.device)
    bins = (ctypes.c_int * len(ROW_LANES))(*t.bin_rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.c_void_p(t.order.data_ptr()),
             ctypes.c_void_p(t.row_ptr.data_ptr()),
             ctypes.c_void_p(t.cols.data_ptr()),
             ctypes.c_void_p(t.values.data_ptr()),
             ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
             ctypes.cast(bins, ctypes.c_void_p), t.num_rows, x.device.index,
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    rows_matvec.launches += 1
    return y


def rows_matmat(t: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """Y = X Aᵀ over the row layout, that is Y[b] = A X[b], exact, in the
    matrix's dtype (f32 or f64); x is [B, N] (B padded vectors,
    contiguous), y is [B, M]."""
    if x.device.type == "cpu":
        return rows_matmat_plain(t, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from ortools_tpu_torch.ops import _build

    lib = _build.library("block_spmm")
    if t.values.dtype == torch.float32:
        fn = lib.block_spmm_rows_f32
    elif t.values.dtype == torch.float64:
        fn = lib.block_spmm_rows_f64
    else:
        raise TypeError(f"no row kernel for {t.values.dtype}")
    _check_rows(t, x, batched=True)
    batch = int(x.shape[0])
    y = torch.empty(batch, t.num_rows, dtype=x.dtype, device=x.device)
    # the kernel's Xᵀ, [N, B]
    xt = torch.empty(t.num_cols * batch, dtype=x.dtype, device=x.device)
    bins = (ctypes.c_int * len(ROW_LANES))(*t.bin_rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.c_void_p(t.order.data_ptr()),
             ctypes.c_void_p(t.row_ptr.data_ptr()),
             ctypes.c_void_p(t.cols.data_ptr()),
             ctypes.c_void_p(t.values.data_ptr()),
             ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(xt.data_ptr()),
             ctypes.c_void_p(y.data_ptr()),
             ctypes.cast(bins, ctypes.c_void_p), t.num_rows, batch,
             t.num_cols, x.device.index, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    rows_matmat.launches += 1
    return y


tiled_matvec.launches = 0
tiled_matvec_fast.launches = 0
tiled_matmat.launches = 0
rows_matvec.launches = 0
rows_matmat.launches = 0


def launch_counts() -> Tuple[int, int, int, int, int]:
    """(exact, fast, SpMM, row, row SpMM) kernel launches counted so
    far."""
    return (tiled_matvec.launches, tiled_matvec_fast.launches,
            tiled_matmat.launches, rows_matvec.launches,
            rows_matmat.launches)


def count_launches(exact: int, fast: int, spmm: int, rows: int,
                   rows_spmm: int) -> None:
    """Add launches that the wrappers' code did not make itself: a CUDA
    graph's replay launches the kernels it captured, while the capture,
    which ran the wrappers, launched none (its counts are taken back with
    negative numbers)."""
    tiled_matvec.launches += exact
    tiled_matvec_fast.launches += fast
    tiled_matmat.launches += spmm
    rows_matvec.launches += rows
    rows_matmat.launches += rows_spmm
