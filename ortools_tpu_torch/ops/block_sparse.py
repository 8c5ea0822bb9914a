"""Block-sparse constraint matrices (port of
``ortools_tpu/ops/block_sparse.py``).

The logical m x n matrix is padded to M x N (multiples of the block shape)
and tiled into (bm, bn) dense blocks; only nonzero blocks are stored, in a
block-COO layout:

    data:       f32/f64 [num_blocks, bm, bn]
    block_rows: int32   [num_blocks]
    block_cols: int32   [num_blocks]

The host packing is the JAX package's, so the arrays are the same.  A 1-D
``matvec`` goes through the block-row kernel (``ops/tiled_spmv.py``) once
its layout is attached (``with_tiled``), or through the row kernel where a
row layout of the nonzeros is attached as well (``with_rows``, for
matrices of low fill); on a CUDA tensor that is the only way, because
nothing on the card runs the plain product.  Without a layout, on the
CPU, it is the plain gather + batched mat-vec + ``index_add_`` of
``_block_matvec``.  ``matvec`` of a batch of vectors
(``[B, N]``, the layout of the batched solve) is the block SpMM in the same
way: the ``block_spmm_exact`` kernel on a card, its plain version on the
CPU; or, where the row layout is attached and moves fewer bytes at that
batch (``tiled_spmv.prefer_rows_batched``), the batched row kernel
``block_spmm_rows``.  ``matmat`` takes the JAX method's ``[N, k]`` layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ortools_tpu_torch.ops import tiled_spmv
from ortools_tpu_torch.ops.tiled_spmv import BlockRowLayout, RowLayout
from ortools_tpu_torch.utils.device import resolve_device


def _ceil_to(x: int, k: int) -> int:
    return -(-x // k) * k


@dataclasses.dataclass(frozen=True)
class BlockSparseMatrix:
    """Static-shape block-COO sparse matrix on one device."""

    data: torch.Tensor  # [num_blocks, bm, bn]
    block_rows: torch.Tensor  # int32 [num_blocks]
    block_cols: torch.Tensor  # int32 [num_blocks]
    shape: Tuple[int, int]  # logical (m, n)
    padded_shape: Tuple[int, int]  # (M, N), multiples of block shape
    num_real_blocks: int  # blocks before padding
    # Block-row kernel layout (ops/tiled_spmv.py); when present, 1-D
    # matvec launches the CUDA kernel (its plain version on the CPU).
    tiled: Optional[BlockRowLayout] = None
    # Row layout of the nonzeros (ops/tiled_spmv.py); when present, 1-D
    # matvec launches the row kernel instead, and the batched product
    # takes the batched row kernel where it moves fewer bytes than the
    # blocks (tiled_spmv.prefer_rows_batched).
    rows: Optional[RowLayout] = None

    # -- properties -----------------------------------------------------
    @property
    def block_shape(self) -> Tuple[int, int]:
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def num_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- construction ---------------------------------------------------
    @staticmethod
    def from_scipy(
        a: sp.spmatrix,
        block_shape: Tuple[int, int] = (8, 128),
        dtype: torch.dtype = torch.float32,
        pad_blocks_to_multiple_of: int = 1,
        padded_shape: Optional[Tuple[int, int]] = None,
        device="cuda",
    ) -> "BlockSparseMatrix":
        """``padded_shape`` overrides the default round-up-to-block padding —
        used to make A and its separately-stored transpose agree on padded
        vector lengths (each dim must be a multiple of the block dim)."""
        device = resolve_device(device)
        m, n = a.shape
        bm, bn = block_shape
        if padded_shape is not None:
            mm, nn = padded_shape
            if mm % bm or nn % bn or mm < m or nn < n:
                raise ValueError(
                    f"padded_shape {padded_shape} does not fit {a.shape} "
                    f"at block shape {block_shape}")
        else:
            mm, nn = _ceil_to(max(m, 1), bm), _ceil_to(max(n, 1), bn)
        coo = sp.coo_matrix(a)
        br = coo.row // bm
        bc = coo.col // bn
        key = br.astype(np.int64) * (nn // bn) + bc
        uniq, inv = np.unique(key, return_inverse=True)
        nblocks = max(1, len(uniq))
        nblocks_padded = _ceil_to(nblocks, max(1, pad_blocks_to_multiple_of))
        data = np.zeros((nblocks_padded, bm, bn), dtype=np.float64)
        if len(uniq):
            np.add.at(data, (inv, coo.row % bm, coo.col % bn), coo.data)
            block_rows = (uniq // (nn // bn)).astype(np.int32)
            block_cols = (uniq % (nn // bn)).astype(np.int32)
        else:
            # an empty matrix stores one all-zero block at (0, 0)
            block_rows = np.zeros(1, dtype=np.int32)
            block_cols = np.zeros(1, dtype=np.int32)
        if nblocks_padded > len(block_rows):
            pad = nblocks_padded - len(block_rows)
            # Padding blocks are all-zero and point at (0, 0): harmless adds.
            block_rows = np.concatenate([block_rows, np.zeros(pad, np.int32)])
            block_cols = np.concatenate([block_cols, np.zeros(pad, np.int32)])
        return BlockSparseMatrix(
            data=torch.as_tensor(data, dtype=dtype, device=device),
            block_rows=torch.as_tensor(block_rows, device=device),
            block_cols=torch.as_tensor(block_cols, device=device),
            shape=(m, n),
            padded_shape=(mm, nn),
            num_real_blocks=nblocks,
        )

    def block_transpose(self) -> "BlockSparseMatrix":
        """Aᵀ at block shape (bn, bm) by transposing each stored block.

        Tile (J, I) of Aᵀ is tile (I, J) of A transposed, so the transpose
        has the same number of stored blocks and no extra fill-in.  Its
        blocks keep A's order, which is not sorted by their new row:
        ``with_tiled`` sorts them.
        """
        return BlockSparseMatrix(
            data=self.data.transpose(1, 2).contiguous(),
            block_rows=self.block_cols,
            block_cols=self.block_rows,
            shape=(self.shape[1], self.shape[0]),
            padded_shape=(self.padded_shape[1], self.padded_shape[0]),
            num_real_blocks=self.num_real_blocks,
        )

    # -- padded vector helpers -------------------------------------------
    def pad_x(self, x, value: float = 0.0) -> torch.Tensor:
        """Pad a length-n vector to N."""
        return _pad_to(x, self.shape[1], self.padded_shape[1], value,
                       self.dtype, self.device)

    def pad_y(self, y, value: float = 0.0) -> torch.Tensor:
        return _pad_to(y, self.shape[0], self.padded_shape[0], value,
                       self.dtype, self.device)

    def unpad_y(self, y: torch.Tensor) -> torch.Tensor:
        return y[..., : self.shape[0]]

    def unpad_x(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., : self.shape[1]]

    def with_tiled(self, hi: bool = False) -> "BlockSparseMatrix":
        """Attach the block-row kernel layout, with ``hi`` also the bf16
        copy of the blocks (the fast stream).  Blocks not yet in
        (row, col) order are sorted; the matrix then holds the sorted
        copy alone, so the layout adds only ``row_ptr`` (and the bf16
        copy) to device memory."""
        order = tiled_spmv.block_row_order(
            self.block_rows.cpu().numpy(), self.block_cols.cpu().numpy())
        mat = self
        if np.any(order != np.arange(len(order))):
            perm = torch.as_tensor(order, device=self.device)
            mat = dataclasses.replace(
                self, data=self.data.index_select(0, perm),
                block_rows=self.block_rows.index_select(0, perm),
                block_cols=self.block_cols.index_select(0, perm))
        layout = tiled_spmv.make_layout(
            mat.data, mat.block_rows, mat.block_cols, self.padded_shape,
            hi=hi)
        return dataclasses.replace(mat, tiled=layout)

    @property
    def has_fast_stream(self) -> bool:
        return self.tiled is not None and self.tiled.data_hi is not None

    def with_rows(self, csr: Optional[sp.spmatrix] = None
                  ) -> "BlockSparseMatrix":
        """Attach the row layout of the nonzeros of ``csr``, the matrix
        these blocks hold (by default read back from the blocks)."""
        return dataclasses.replace(self, rows=tiled_spmv.make_row_layout(
            self.to_csr() if csr is None else csr, self.padded_shape[0],
            self.padded_shape[1], self.dtype, self.device))

    def without_tiled(self) -> "BlockSparseMatrix":
        """The matrix without its kernel layouts."""
        if self.tiled is None and self.rows is None:
            return self
        return dataclasses.replace(self, tiled=None, rows=None)

    # -- products --------------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x with x padded to N; returns padded length-M vector.  For
        x of [B, N] (B vectors), returns [B, M]: row b is A @ x[b]."""
        if x.dim() == 2:
            if self.rows is not None and tiled_spmv.prefer_rows_batched(
                    self.rows.nnz, self.rows.num_rows, self.num_blocks,
                    self.block_shape, self.data.element_size(),
                    int(x.shape[0])):
                return tiled_spmv.rows_matmat(self.rows, x)
            if self.tiled is not None:
                return tiled_spmv.tiled_matmat(self.tiled, x)
            self._require_cpu(x)
            return tiled_spmv.block_product_batched(
                self.data, self.block_rows, self.block_cols, x,
                self.padded_shape[0] // self.block_shape[0])
        if self.rows is not None:
            return tiled_spmv.rows_matvec(self.rows, x)
        if self.tiled is not None:
            return tiled_spmv.tiled_matvec(self.tiled, x)
        self._require_cpu(x)
        return _block_matvec(self.data, self.block_rows, self.block_cols, x,
                             self.padded_shape[0])

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """A @ X with X padded [N, k] (the JAX method's layout); returns
        [M, k].  The product runs batch-leading, as ``matvec(X.T)``."""
        return self.matvec(x.t().contiguous()).t()

    @staticmethod
    def _require_cpu(x: torch.Tensor) -> None:
        if x.device.type != "cpu":
            raise ValueError(
                "on a card the product runs only through the block-row "
                "kernels: attach their layout with with_tiled()")

    def matvec_fast(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x through the bf16 stream when attached (~2^-9 relative
        rounding on matrix entries), exact ``matvec`` otherwise."""
        if self.has_fast_stream:
            return tiled_spmv.tiled_matvec_fast(self.tiled, x)
        return self.matvec(x)

    # -- conversion back -------------------------------------------------
    def to_csr(self) -> sp.csr_matrix:
        """The padded M x N matrix the blocks hold, their nonzeros alone,
        as a scipy CSR matrix in float64."""
        bm, bn = self.block_shape
        data = self.data.detach().cpu().double().numpy()
        b, i, j = np.nonzero(data)
        rows = self.block_rows.cpu().numpy().astype(np.int64)[b] * bm + i
        cols = self.block_cols.cpu().numpy().astype(np.int64)[b] * bn + j
        return sp.csr_matrix((data[b, i, j], (rows, cols)),
                             shape=self.padded_shape)

    def to_dense(self) -> np.ndarray:
        bm, bn = self.block_shape
        mm, nn = self.padded_shape
        data = self.data.cpu().numpy()
        out = np.zeros((mm, nn), dtype=data.dtype)
        br = self.block_rows.cpu().numpy()
        bc = self.block_cols.cpu().numpy()
        for i in range(self.num_blocks):
            out[br[i] * bm: (br[i] + 1) * bm,
                bc[i] * bn: (bc[i] + 1) * bn] += data[i]
        return out[: self.shape[0], : self.shape[1]]


def _pad_to(v, logical: int, padded: int, value: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Pad the last axis (a vector, or a batch of vectors [B, n])."""
    v = torch.as_tensor(v, dtype=dtype, device=device)
    if v.shape[-1] == padded:
        return v
    if v.shape[-1] != logical:
        raise ValueError(f"length {v.shape[-1]}: expected {logical} or "
                         f"{padded}")
    out = torch.full(tuple(v.shape[:-1]) + (padded,), value, dtype=dtype,
                     device=device)
    out[..., :logical] = v
    return out


def _block_matvec(data, block_rows, block_cols, x, m_padded: int):
    """Plain block-COO product (``ortools_tpu`` ``_block_matvec``)."""
    return tiled_spmv.block_product(data, block_rows, block_cols, x,
                                    m_padded // int(data.shape[1]))


def auto_block_shape(m: int, n: int, nnz: int) -> Tuple[int, int]:
    """Block shape trading padding waste against index count: density
    above 5% -> (128, 128); above 0.5% -> (32, 128); else (8, 128)."""
    density = nnz / max(1, m * n)
    if density > 0.05:
        return (128, 128)
    if density > 0.005:
        return (32, 128)
    return (8, 128)
