"""Share in % of its roofline of the block SpMV kernel
(``kernels/block_spmv.json``) in the traced slice: the launches' least
times (``lpbench/roofline.py``) over their profiled times."""

from lpbench import roofline


def read(t):
    return roofline.share(t.device_ops, t.kernel("block_spmv"), t.shape,
                          t.dtype)
