// Block-row SpMM of the batched PDLP solve: Y = X A^T, that is
// Y[b, :] = A X[b, :] for B instances at once.  X is [B, N] and Y is [B, M],
// both contiguous with the batch leading (the layout of the batched state).
// A is the block-row layout of block_spmv.cu: dense (bm x bn) blocks sorted
// by (row, col), data [num_blocks, bm, bn] row-major, block_cols per block,
// and make_layout's schedule of (block-row, first block, end block, 0)
// entries, longest rows first.
//
// What it replaces: ortools_tpu/ops/block_sparse.py::_block_matmat, the XLA
// block einsum (gather, "bij,bjk->bik", segment_sum) that the JAX package's
// batched solve (jax.vmap of the single-device functions) runs for every
// product.  It is not a Pallas kernel; the port runs no product on a card
// except through its own kernels.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores,
// at 700 W), the same for any implementation: the blocks once plus X and Y
// once each, against 2 flops per stored entry per instance.  At the bench
// shape (16384^2, 4096 blocks of 8x128) and B = 64 in f32: 16.8 MB + 2 x
// 4.2 MB = 25.2 MB, 7.5 us; 2 x 4096 x 1024 x 64 = 0.54 GFLOP, 8.0 us.  So
// the work sits at the ridge of the f32 cores: a kernel has to reuse each
// block across the batch (one read per tile of instances, not one per
// instance) and keep the FMA units fed.
//
// This first design is simple and right; tensor cores, TMA and a tuned tile
// are later work.
// - A thread block takes one block-row of the schedule and a tile of 32
//   instances (gridDim.y tiles); lane l of every warp owns instance
//   b0 + l.  The warps split the block's rows (R rows each) and, where a
//   block has few rows, its columns (KS ways), so that each stored block is
//   read from device memory once per tile.
// - For each round of G blocks the thread block stages the tile's x
//   segments in shared memory (16-byte loads, neighbouring threads on
//   neighbouring addresses; rows padded by 16 bytes, so that a warp's
//   16-byte reads of 32 instances hit every bank once).  Each thread then
//   reads its rows of the block as 16-byte broadcast loads (all lanes of a
//   warp read the same address) and accumulates R sums with FMAs.
// - The KS column parts of a row meet in shared memory in a fixed order,
//   and the tile's Y entries leave with the row index fastest (32 or more
//   contiguous bytes per instance).
//
// Deterministic output: each Y entry is written by exactly one thread, each
// thread sums its blocks and columns in a fixed order, and the column parts
// meet in a fixed order.  No atomics, so repeated launches are
// bit-identical.  The kernel launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;          // instances of a thread block: one a lane
constexpr int kStageBytes = 40960; // x staged per round, at most

template <class T>
struct Vec16;
template <>
struct Vec16<float> {
  using V = float4;
  static __device__ __forceinline__ float dot(float4 a, float4 x, float acc) {
    acc = fmaf(a.x, x.x, acc);
    acc = fmaf(a.y, x.y, acc);
    acc = fmaf(a.z, x.z, acc);
    return fmaf(a.w, x.w, acc);
  }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};
template <>
struct Vec16<double> {
  using V = double2;
  static __device__ __forceinline__ double dot(double2 a, double2 x,
                                               double acc) {
    acc = fma(a.x, x.x, acc);
    return fma(a.y, x.y, acc);
  }
  static __device__ __forceinline__ double2 zero() {
    return make_double2(0.0, 0.0);
  }
};

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The work split of one (bm x bn) block shape.
template <class T, int BM, int BN>
struct Shape {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int R = cmin(BM, 16);           // rows of a thread
  static constexpr int WR = BM / R;                // warps along the rows
  static constexpr int KS = cmin(8 / WR, BN / VEC);  // warps along the columns
  static constexpr int WARPS = WR * KS;
  static constexpr int JC = BN / KS;               // columns of a warp
  static constexpr int XS = BN + VEC;              // staged row stride
  static constexpr int TILE = kTile * XS;          // values of a staged block
  static constexpr int G = cmax(
      1, cmin(16, kStageBytes / (TILE * static_cast<int>(sizeof(T)))));
  static constexpr int RS = kTile + 1;             // partial-sum row stride
  static constexpr int SMEM =
      cmax(G * TILE, KS * BM * RS) * static_cast<int>(sizeof(T));
  static_assert(BM % R == 0 && WR <= 8 && JC % VEC == 0, "shape");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

template <class T, int BM, int BN>
__global__ void __launch_bounds__(Shape<T, BM, BN>::WARPS * 32)
block_spmm_kernel(const int4* __restrict__ schedule,
                  const int32_t* __restrict__ block_cols,
                  const T* __restrict__ data, const T* __restrict__ x,
                  T* __restrict__ y, int batch, int n, int m) {
  using S = Shape<T, BM, BN>;
  using VT = Vec16<T>;
  using V = typename VT::V;
  constexpr int CPR = BN / S::VEC;  // 16-byte chunks of one x segment
  constexpr int THREADS = S::WARPS * 32;
  __shared__ __align__(16) unsigned char smem[S::SMEM];
  T* xs = reinterpret_cast<T*>(smem);

  const int4 task = __ldg(schedule + blockIdx.x);
  const int b0 = blockIdx.y * kTile;
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const int row0 = (w / S::KS) * S::R, col0 = (w % S::KS) * S::JC;

  T acc[S::R];
#pragma unroll
  for (int r = 0; r < S::R; ++r) acc[r] = T(0);

  for (int p0 = task.y; p0 < task.z; p0 += S::G) {
    const int g = min(S::G, task.z - p0);
    __syncthreads();  // the previous round's reads of xs are done
    for (int e = t; e < g * kTile * CPR; e += THREADS) {
      const int q = e % CPR, bb = (e / CPR) % kTile, k = e / (CPR * kTile);
      V v = VT::zero();
      if (b0 + bb < batch) {
        const size_t col = static_cast<size_t>(__ldg(block_cols + p0 + k));
        v = __ldg(reinterpret_cast<const V*>(
            x + static_cast<size_t>(b0 + bb) * n + col * BN + q * S::VEC));
      }
      *reinterpret_cast<V*>(xs + k * S::TILE + bb * S::XS + q * S::VEC) = v;
    }
    __syncthreads();
    for (int k = 0; k < g; ++k) {
      const T* a = data + static_cast<size_t>(p0 + k) * BM * BN +
                   static_cast<size_t>(row0) * BN + col0;
      const T* xr = xs + k * S::TILE + lane * S::XS + col0;
#pragma unroll 4
      for (int j = 0; j < S::JC; j += S::VEC) {
        const V xv = *reinterpret_cast<const V*>(xr + j);
#pragma unroll
        for (int r = 0; r < S::R; ++r) {
          const V av = __ldg(reinterpret_cast<const V*>(a + r * BN + j));
          acc[r] = VT::dot(av, xv, acc[r]);
        }
      }
    }
  }

  // Column parts to shared memory, then each Y entry summed in part order.
  __syncthreads();
  T* part = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int r = 0; r < S::R; ++r) {
    part[((w % S::KS) * BM + row0 + r) * S::RS + lane] = acc[r];
  }
  __syncthreads();
  T* yr = y + static_cast<size_t>(task.x) * BM;
  for (int e = t; e < BM * kTile; e += THREADS) {
    const int i = e % BM, bb = e / BM;
    T sum = part[i * S::RS + bb];
#pragma unroll
    for (int k = 1; k < S::KS; ++k) sum += part[(k * BM + i) * S::RS + bb];
    if (b0 + bb < batch) yr[static_cast<size_t>(b0 + bb) * m + i] = sum;
  }
}

template <class T>
int launch(const int4* schedule, const int32_t* block_cols, const T* data,
           const T* x, T* y, int num_block_rows, int bm, int bn, int batch,
           int n, int m, int device, cudaStream_t stream) {
  if (num_block_rows < 0 || batch < 0 || n < 0 || m != num_block_rows * bm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(schedule) % 16 != 0 ||
      (static_cast<size_t>(n) * sizeof(T)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (num_block_rows == 0 || batch == 0) return 0;
  // This library's CUDA runtime keeps its own current device: launch on
  // the card that holds the tensors.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(num_block_rows, (batch + kTile - 1) / kTile);
#define OTT_BLOCK_SPMM_CASE(BM_, BN_)                                       \
  if (bm == BM_ && bn == BN_) {                                             \
    block_spmm_kernel<T, BM_, BN_>                                          \
        <<<grid, Shape<T, BM_, BN_>::WARPS * 32, 0, stream>>>(              \
            schedule, block_cols, data, x, y, batch, n, m);                 \
    return static_cast<int>(cudaGetLastError());                            \
  }
  OTT_BLOCK_SPMM_CASE(8, 8)
  OTT_BLOCK_SPMM_CASE(8, 32)
  OTT_BLOCK_SPMM_CASE(8, 128)
  OTT_BLOCK_SPMM_CASE(32, 8)
  OTT_BLOCK_SPMM_CASE(32, 32)
  OTT_BLOCK_SPMM_CASE(32, 128)
  OTT_BLOCK_SPMM_CASE(128, 8)
  OTT_BLOCK_SPMM_CASE(128, 32)
  OTT_BLOCK_SPMM_CASE(128, 128)
#undef OTT_BLOCK_SPMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the launch's CUDA
// error: 0 when the kernel was launched (or there was nothing to do).  data,
// x and the schedule must be 16-byte aligned, and so must each row of x
// (n * sizeof(T) a multiple of 16); m is num_block_rows * bm.
extern "C" {

int block_spmm_exact_f32(const void* schedule, const int32_t* block_cols,
                         const float* data, const float* x, float* y,
                         int num_block_rows, int bm, int bn, int batch, int n,
                         int m, int device, void* stream) {
  return launch<float>(static_cast<const int4*>(schedule), block_cols, data,
                       x, y, num_block_rows, bm, bn, batch, n, m, device,
                       static_cast<cudaStream_t>(stream));
}

int block_spmm_exact_f64(const void* schedule, const int32_t* block_cols,
                         const double* data, const double* x, double* y,
                         int num_block_rows, int bm, int bn, int batch, int n,
                         int m, int device, void* stream) {
  return launch<double>(static_cast<const int4*>(schedule), block_cols, data,
                        x, y, num_block_rows, bm, bn, batch, n, m, device,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
