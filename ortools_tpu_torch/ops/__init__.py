"""Block-sparse matrices and the CUDA SpMV kernels of the port."""

from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix  # noqa: F401
