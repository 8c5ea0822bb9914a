"""The roofline arithmetic and the idle share, on synthetic inputs."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

from lpbench import roofline
from lpbench.trace import _busy_and_gaps, short_name
from conftest import tiny_instance
from reference.generators import mcnd_c


def test_spmv_and_spmm_work():
    shape = dict(m=100, n=300, nnz=1000, batch=64)
    assert roofline.spmv(shape, 8, 8) == (1000 * 8 + 400 * 8, 2000)
    assert roofline.spmm(shape, 4, 4) == (1000 * 4 + 64 * 400 * 4, 2000 * 64)


@pytest.mark.parametrize("blocksize", [(8, 128), (4, 16), (1, 1)])
def test_block_and_csr_layouts_give_the_same_bound(blocksize):
    inst = mcnd_c.make(**tiny_instance("relaxation"), seed=1)
    a = sp.csr_matrix((inst.vals, (inst.rows, inst.cols)), shape=(inst.m, inst.n))
    mm = -(-inst.m // blocksize[0]) * blocksize[0]
    nn = -(-inst.n // blocksize[1]) * blocksize[1]
    padded = sp.csr_matrix((inst.vals, (inst.rows, inst.cols)), shape=(mm, nn))
    blocks = sp.bsr_matrix(padded, blocksize=blocksize)
    assert blocks.data.size >= a.nnz  # the blocks store zeros
    kernel = {"pattern": "k", "work": "spmv"}
    bounds = []
    for mat in (a, blocks):
        shape = dict(m=inst.m, n=inst.n, nnz=roofline.count_nonzeros(mat), batch=1)
        bounds.append(roofline.launch_bound_s("k", kernel, shape, "float64"))
    assert bounds[0] == bounds[1]


def test_share_sums_bounds_over_times_and_reads_the_launch_precision():
    shape = dict(m=1000, n=1000, nnz=10**6, batch=1)
    kernel = {"pattern": "spmv_kernel", "work": "spmv",
              "value_bytes": {"FastBf16": 2}}
    exact = (10**6 * 4 + 2000 * 4) / roofline.HBM_BYTES_PER_S
    fast = (10**6 * 2 + 2000 * 4) / roofline.HBM_BYTES_PER_S
    events = [("spmv_kernel<ExactF32>", 0.0, 2 * exact),
              ("spmv_kernel<FastBf16>", 1.0, 4 * fast),
              ("other", 2.0, 1.0)]
    got = roofline.share(events, kernel, shape, "float32")
    assert got == pytest.approx(100 * (exact + fast) / (2 * exact + 4 * fast))
    assert roofline.share(events[2:], kernel, shape, "float32") is None


def test_bound_is_by_operations_where_they_dominate():
    shape = dict(m=1, n=1, nnz=10**6, batch=10**4)
    b, ops = roofline.spmm(shape, 8, 8)
    got = roofline.launch_bound_s("k", {"work": "spmm"}, shape, "float64")
    assert got == pytest.approx(ops / roofline.PEAK_FLOPS["float64"])
    assert ops / roofline.PEAK_FLOPS["float64"] > b / roofline.HBM_BYTES_PER_S


def test_busy_and_gaps_from_synthetic_intervals():
    ops = [("a", 1.0, 1.0), ("b", 1.5, 1.0), ("c", 4.0, 1.0), ("d", 9.5, 2.0)]
    host = [("call", 0.0, 10.0), ("capture", 2.5, 4.0), ("read", 5.0, 9.0)]
    busy, gaps = _busy_and_gaps(ops, host, 0.0, 10.0)
    # [1, 2.5] + [4, 5] + [9.5, 10] (clipped)
    assert busy == pytest.approx(3.0)
    assert gaps == [("host loop", 1.0), ("capture", 1.5), ("read", 4.5)]
    assert sum(g for _, g in gaps) + busy == pytest.approx(10.0)


def test_no_host_span_is_between_calls():
    busy, gaps = _busy_and_gaps([("k", 1.0, 1.0)], [], 0.0, 3.0)
    assert busy == 1.0 and [g[0] for g in gaps] == ["between calls"] * 2
    assert np.isclose(sum(g[1] for g in gaps), 2.0)


def test_short_names_keep_the_kernel_and_its_template():
    assert short_name(
        "void (anonymous namespace)::block_spmv_kernel<(anonymous namespace)"
        "::FastBf16, 8, 128>(int4 const*, int const*)") == \
        "block_spmv_kernel<FastBf16, 8, 128>"
