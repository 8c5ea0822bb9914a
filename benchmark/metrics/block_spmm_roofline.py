"""Share in % of its roofline of the batched block SpMM kernel
(``kernels/block_spmm.json``) in the traced slice: the launches' least
times (``lpbench/roofline.py``) over their profiled times."""

from lpbench import roofline


def read(t):
    return roofline.share(t.device_ops, t.kernel("block_spmm"), t.shape,
                          t.dtype)
