"""Block-sparse matrices and the CUDA SpMV kernels of the port."""
