// Block-row SpMV kernels of the PDLP solve: y = A x, with A stored as dense
// (bm x bn) blocks in block-row CSR order (blocks sorted by (row, col),
// row_ptr[r] .. row_ptr[r+1] are the blocks of block-row r, block_cols
// gives each block's column, data is [num_blocks, bm, bn] row-major).
//
// block_spmv_exact<T> (T = float, double) replaces
//   ortools_tpu/ops/tiled_spmv.py::_spmv_tiled_kernel (the exact f32 stream)
//   and, on the card, the XLA block path ortools_tpu/ops/block_sparse.py::
//   _block_matvec (f64 solves).
// block_spmv_fast replaces
//   ortools_tpu/ops/tiled_spmv.py::_spmv_tiled_fast_kernel: bf16 matrix
//   copy, x rounded to bf16 (round to nearest), products and sums in f32.
//   The TPU kernel also rounds each block's partial sums to bf16 before its
//   scatter; that is an artifact of its MXU scatter and is not copied.
//
// Bound on an H100 (3.35 TB/s): the matrix bytes, each read once.  At the
// bench shape (16384^2, 4096 blocks of 8x128) the exact kernel moves
// 16.78 MB of f32 blocks plus 64 KB of x, 64 KB of y and ~25 KB of indices
// (about 5.1 us); the fast kernel moves 8.39 MB of bf16 blocks plus the
// same vectors (about 2.6 us).  The arithmetic (2 flops per stored entry)
// is two orders of magnitude below the card's rate.
//
// Design against that bound: one thread block per block-row, so every y
// entry is written once by one thread and the sum needs no atomics (y is
// bit-identical from run to run).  128 threads share one (bm x bn) block:
// thread t owns row t / (128/bm) of the block and strides over its columns,
// so neighbouring threads read neighbouring addresses of the block and the
// x segment (cached, read-only).  A block-row with many blocks (the
// transpose's tall (128 x bn) rows) is split over up to 8 such groups,
// each taking every groups-th block; their partial sums meet in shared
// memory in a fixed order.  No TMA or tensor cores: the matrix is streamed
// once and each entry is used once, so the kernel can only approach the
// bytes bound by keeping enough loads in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupThreads = 128;  // threads that share one block
constexpr int kMaxGroups = 8;

template <typename T>
__device__ __forceinline__ T to_acc(T v) { return v; }

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x as the kernel multiplies it: as stored (exact), or rounded to bf16 to
// nearest and widened back to f32 (fast).
template <bool kRoundX, typename T>
__device__ __forceinline__ T load_x(const T* p) {
  T v = __ldg(p);
  if constexpr (kRoundX) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <typename DataT, typename VecT, bool kRoundX, int BM, int BN>
__global__ void __launch_bounds__(kGroupThreads * kMaxGroups)
block_spmv_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ block_cols,
                  const DataT* __restrict__ data,
                  const VecT* __restrict__ x, VecT* __restrict__ y) {
  static_assert(BM <= kGroupThreads && kGroupThreads % BM == 0, "bm");
  constexpr int S = kGroupThreads / BM;  // threads per block row
  static_assert(S <= 32, "the threads of one row must share a warp");
  constexpr int kCols = (BN + S - 1) / S;  // columns per thread per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  VecT* partial = reinterpret_cast<VecT*>(smem_raw);  // [groups][BM]

  const int groups = blockDim.x / kGroupThreads;
  const int g = threadIdx.x / kGroupThreads;
  const int t = threadIdx.x % kGroupThreads;
  const int i = t / S;  // row inside the block
  const int s = t % S;  // first column of this thread
  const int r = blockIdx.x;
  const int begin = __ldg(row_ptr + r);
  const int end = __ldg(row_ptr + r + 1);

  VecT acc = VecT(0);
  for (int b = begin + g; b < end; b += groups) {
    const int col = __ldg(block_cols + b);
    const DataT* blk = data + static_cast<size_t>(b) * (BM * BN) + i * BN;
    const VecT* xs = x + static_cast<size_t>(col) * BN;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int j = s + jj * S;
      if (BN % S == 0 || j < BN) {
        acc += to_acc(__ldg(blk + j)) * load_x<kRoundX>(xs + j);
      }
    }
  }
  // Sum the S threads of row i (an aligned run of lanes in one warp); the
  // butterfly gives lane s == 0 the same order of additions every run.
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (groups == 1) {
    if (s == 0) y[static_cast<size_t>(r) * BM + i] = acc;
    return;
  }
  if (s == 0) partial[g * BM + i] = acc;
  __syncthreads();
  if (threadIdx.x < BM) {
    VecT sum = partial[threadIdx.x];
    for (int k = 1; k < groups; ++k) sum += partial[k * BM + threadIdx.x];
    y[static_cast<size_t>(r) * BM + threadIdx.x] = sum;
  }
}

template <typename DataT, typename VecT, bool kRoundX>
int launch(const int32_t* row_ptr, const int32_t* block_cols,
           const DataT* data, const VecT* x, VecT* y, int num_block_rows,
           int bm, int bn, int groups, int device, cudaStream_t stream) {
  if (groups < 1 || groups > kMaxGroups || num_block_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_block_rows == 0) return 0;
  // This library's CUDA runtime keeps its own current device: launch on
  // the card that holds the tensors.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(num_block_rows);
  const dim3 block(kGroupThreads * groups);
  const size_t smem = static_cast<size_t>(groups) * bm * sizeof(VecT);
#define OTT_BLOCK_SPMV_CASE(BM_, BN_)                                       \
  if (bm == BM_ && bn == BN_) {                                             \
    block_spmv_kernel<DataT, VecT, kRoundX, BM_, BN_>                       \
        <<<grid, block, smem, stream>>>(row_ptr, block_cols, data, x, y);   \
    return static_cast<int>(cudaGetLastError());                            \
  }
  OTT_BLOCK_SPMV_CASE(8, 8)
  OTT_BLOCK_SPMV_CASE(8, 32)
  OTT_BLOCK_SPMV_CASE(8, 128)
  OTT_BLOCK_SPMV_CASE(32, 8)
  OTT_BLOCK_SPMV_CASE(32, 32)
  OTT_BLOCK_SPMV_CASE(32, 128)
  OTT_BLOCK_SPMV_CASE(128, 8)
  OTT_BLOCK_SPMV_CASE(128, 32)
  OTT_BLOCK_SPMV_CASE(128, 128)
#undef OTT_BLOCK_SPMV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch: 0 when the kernel was launched.
extern "C" {

int block_spmv_exact_f32(const int32_t* row_ptr, const int32_t* block_cols,
                         const float* data, const float* x, float* y,
                         int num_block_rows, int bm, int bn, int groups,
                         int device, void* stream) {
  return launch<float, float, false>(row_ptr, block_cols, data, x, y,
                                     num_block_rows, bm, bn, groups, device,
                                     static_cast<cudaStream_t>(stream));
}

int block_spmv_exact_f64(const int32_t* row_ptr, const int32_t* block_cols,
                         const double* data, const double* x, double* y,
                         int num_block_rows, int bm, int bn, int groups,
                         int device, void* stream) {
  return launch<double, double, false>(row_ptr, block_cols, data, x, y,
                                       num_block_rows, bm, bn, groups, device,
                                       static_cast<cudaStream_t>(stream));
}

int block_spmv_fast_bf16(const int32_t* row_ptr, const int32_t* block_cols,
                         const void* data, const float* x, float* y,
                         int num_block_rows, int bm, int bn, int groups,
                         int device, void* stream) {
  return launch<__nv_bfloat16, float, true>(
      row_ptr, block_cols, static_cast<const __nv_bfloat16*>(data), x, y,
      num_block_rows, bm, bn, groups, device,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
