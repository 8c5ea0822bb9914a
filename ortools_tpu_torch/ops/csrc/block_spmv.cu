// Block-row SpMV kernels of the PDLP solve: y = A x, with A stored as dense
// (bm x bn) blocks in block-row CSR order (blocks sorted by (row, col),
// row_ptr[r] .. row_ptr[r+1] are the blocks of block-row r, block_cols
// gives each block's column, data is [num_blocks, bm, bn] row-major, so the
// blocks of one block-row are one contiguous run of memory).
//
// What each function replaces:
// - block_spmv_exact<T> (T = float, double) replaces
//   ortools_tpu/ops/tiled_spmv.py::_spmv_tiled_kernel (the exact f32
//   stream) and, on the card, the XLA block path ortools_tpu/ops/
//   block_sparse.py::_block_matvec (f64 solves).
// - block_spmv_fast replaces ortools_tpu/ops/tiled_spmv.py::
//   _spmv_tiled_fast_kernel: bf16 matrix copy, x rounded to bf16 (round to
//   nearest even), products and sums in f32.  The TPU kernel also rounds
//   each block's partial sums to bf16 before its scatter; that is an
//   artifact of its MXU scatter and is not copied.
// - block_spmv_rows<T> (T = float, double) replaces none: the exact
//   product over a row layout of the nonzeros alone, for matrices whose
//   blocks are mostly zeros (its own section, below).
//
// Bound on an H100 SXM (3.35 TB/s at 700 W): the matrix bytes, each read
// once.  At the bench shape (16384^2, 4096 blocks of 8x128, and its
// transpose, 4096 blocks of 128x8) the exact kernel moves 16.78 MB of f32
// blocks plus 64 KB of x, 64 KB of y and ~25 KB of indices (about 5.1 us);
// the fast kernel moves 8.39 MB of bf16 blocks plus the same vectors (about
// 2.6 us).  The work is 2 flops per stored entry: 0.5 flop per byte in f32
// and 1 in bf16, two orders of magnitude below the ridge point of the f32
// cores and further below that of the tensor cores.  So no tensor cores:
// the design is about bytes in flight.
//
// The design, against the four faults of the first (scalar) version.
// Numbers: NVIDIA H100 80GB HBM3 at 700 W, L2-cold, chip_smoke.py's
// timing method; PERF.md names the run of each.
// 1. Scalar loads.  Every load is 16 bytes: a float4 of f32, a double2 of
//    f64, or eight bf16 in a uint4.  A team (a warp, or a thread block for
//    blocks over 4 KB) streams a contiguous run of blocks: thread t reads
//    chunks t, t + team, ..., so neighbouring lanes read neighbouring
//    16-byte chunks.  Since bn and the team are powers of two, a thread's
//    column chunk inside every block is fixed (t % chunks-per-block-row).
//    The loads go to registers in rounds of 8 (16 for 4 KB f32 blocks) per
//    thread, each round issued before the previous one is used (register
//    double buffering), with no branch around a load.  A ring of bulk
//    asynchronous copies into shared memory (cp.async.bulk on an mbarrier,
//    4 stages of 8 KB) was measured and dropped: at bench A^T it took
//    13.7 us (exact) and 11.8 us (fast) where registers took 9.8 and 7.5.
// 2. x re-read per row.  A thread loads the x chunk its columns need once
//    per block (for the fast kernel: rounded to bf16 once) and reuses it
//    for every row of the block it covers: 8 rows of a 128x8 f32 block,
//    4 of a bf16 one.
// 3. Short rows.  make_layout (tiled_spmv.py) sorts the block-rows into a
//    schedule of (row, first block, end block) entries: long rows first,
//    then short ones, each longest first.  A short row (blocks of at most
//    4 KB, at most 64 KB in all) goes to one warp, eight per thread block,
//    so bench A (2048 rows of 0-10 blocks) is 256 thread blocks.  At 174
//    registers (exact f32 8x128: 16 loads in flight per lane) one thread
//    block fits an SM, so they run in two waves on 132 SMs.  One wave was
//    slower both ways: 8 loads a round (2 thread blocks per SM) took
//    11.3 us against 9.8, and __launch_bounds__(256, 2) spills 512 bytes
//    at 128 registers and took 18.6 us against 10.1.
//    The bm row sums leave the lanes by a fixed xor butterfly.
// 4. Tall rows.  A long row goes to one thread block of 256 threads: its
//    blocks are cut into 8 contiguous runs, one per warp, streamed as in 3,
//    and the warps' sums meet in shared memory in warp order (blocks over
//    4 KB: the thread block streams the row as one team).  Bench A^T is
//    128 such thread blocks of 8 warps, on 128 of the 132 SMs.  Splitting
//    a row over 2 or 4 thread blocks of a cluster, to fill more SMs, was
//    measured slower at bench A^T (2 ways: 10.3 us exact, 7.6 us fast; 4
//    ways: 14.0 and 12.4; unsplit 9.7 and 6.8) and is not done.
//
// Deterministic output: every y entry is written by one thread, each
// thread sums its chunks in stream order, and the sums meet in a fixed
// order (butterfly, then shared memory in warp order), so repeated
// launches are bit-identical.  No floating-point atomics.  Both variants
// run in one launch: the first num_long thread blocks take the long rows,
// the rest take the short rows eight at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // threads of a thread block
constexpr int kWarps = kThreads / 32;     // short rows per thread block
constexpr int kLoads = 8;                 // 16-byte loads per thread per round
constexpr int kWarpBlockChunks = 256;     // largest block a warp takes (4 KB)
constexpr int kPartials = kWarps * 128;  // row partials of a thread block

// ---------------------------------------------------------------------------
// The three instantiations: what a 16-byte chunk holds and how x is read.
// ---------------------------------------------------------------------------

struct ExactF32 {
  using Vec = float;
  static constexpr int V = 4;  // values per 16-byte chunk
  static __device__ __forceinline__ void load_x(const float* p, float (&v)[V]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ float dot(uint4 a, const float (&v)[V],
                                              float acc) {
    acc = fmaf(__uint_as_float(a.x), v[0], acc);
    acc = fmaf(__uint_as_float(a.y), v[1], acc);
    acc = fmaf(__uint_as_float(a.z), v[2], acc);
    return fmaf(__uint_as_float(a.w), v[3], acc);
  }
};

struct ExactF64 {
  using Vec = double;
  static constexpr int V = 2;
  static __device__ __forceinline__ void load_x(const double* p,
                                                double (&v)[V]) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
  static __device__ __forceinline__ double dot(uint4 a, const double (&v)[V],
                                               double acc) {
    acc = fma(__hiloint2double(static_cast<int>(a.y), static_cast<int>(a.x)),
              v[0], acc);
    return fma(__hiloint2double(static_cast<int>(a.w), static_cast<int>(a.z)),
               v[1], acc);
  }
};

struct FastBf16 {
  using Vec = float;
  static constexpr int V = 8;
  // x rounded to bf16 (nearest even) once per block and held as f32.
  static __device__ __forceinline__ void load_x(const float* p, float (&v)[V]) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    const float w[V] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[e] = __bfloat162float(__float2bfloat16_rn(w[e]));
    }
  }
  // bf16 2e is the low half of word e; widening to f32 is exact.
  static __device__ __forceinline__ float dot(uint4 a, const float (&v)[V],
                                              float acc) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc = fmaf(__uint_as_float(w[e] << 16), v[2 * e], acc);
      acc = fmaf(__uint_as_float(w[e] & 0xffff0000u), v[2 * e + 1], acc);
    }
    return acc;
  }
};

// ---------------------------------------------------------------------------
// Loads
// ---------------------------------------------------------------------------

// Volatile, so that the compiler keeps it where it stands (ahead of the
// first use, never sunk into a branch); callers issue it unconditionally.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  // Read once: keep it out of L1, where x lives.
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// A team of W threads streams the contiguous chunks [0, total) of a run of
// blocks that starts at block `first`: thread t takes chunks t + W i.  In
// rounds of L chunks per thread, each round's loads (and the x chunks they
// need) are issued before the previous round is used (register double
// buffering).  Chunk t + W c of a round lies at position (t % min(C, W)) +
// W (c % KPB) of its block: accumulator c % KPB, x chunk c / KPB, column
// chunk t % RC.  A chunk past the end loads the last chunk and the x of the
// last block and counts as zero, so no load sits under a branch.
template <class Tr, int BM, int BN, int W, int L>
struct Stream {
  using Vec = typename Tr::Vec;
  static constexpr int V = Tr::V;
  static constexpr int RC = BN / V;             // chunks per block row
  static constexpr int C = BM * RC;             // chunks per block
  static constexpr int R = W * L;               // chunks per round
  static constexpr int KPB = C > W ? C / W : 1;  // accumulators
  static constexpr int G = C > R ? C / R : 1;    // rounds per block
  static constexpr int NX = G * L / KPB;          // x chunks per G rounds
  static_assert(RC <= W && NX >= 1, "shape");

  static __device__ __forceinline__ void run(
      const int32_t* __restrict__ block_cols, const uint4* __restrict__ data,
      const Vec* __restrict__ x, int first, int total, int t,
      Vec (&acc)[KPB]) {
    const uint4* src = data + static_cast<size_t>(first) * C;
    const int last = total - 1;
    const int rounds = (total + R - 1) / R;
    auto load_round = [&](int s, uint4 (&a)[L]) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        a[i] = ld_stream(src + min(s * R + t + W * i, last));
      }
    };
    auto load_xs = [&](int s0, Vec (&xs)[NX][V]) {
#pragma unroll
      for (int piece = 0; piece < G; ++piece) {
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int c = piece * L + i;
          if (c % KPB == 0) {
            const int g = min((s0 + piece) * R + t + W * i, last);
            const int col = __ldg(block_cols + first + g / C);
            Tr::load_x(x + static_cast<size_t>(col) * BN + (t % RC) * V,
                       xs[c / KPB]);
          }
        }
      }
    };
#pragma unroll
    for (int k = 0; k < KPB; ++k) acc[k] = Vec(0);
    if (rounds == 0) return;
    uint4 a[L], an[L];
    Vec xv[NX][V], xn[NX][V];
    load_round(0, a);
    load_xs(0, xv);
    for (int s0 = 0; s0 < rounds; s0 += G) {
      if (s0 + G < rounds) load_xs(s0 + G, xn);
#pragma unroll
      for (int piece = 0; piece < G; ++piece) {
        const int s = s0 + piece;
        if (s + 1 < rounds) load_round(s + 1, an);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int c = piece * L + i;
          if (s * R + t + W * i > last) a[i] = make_uint4(0, 0, 0, 0);
          acc[c % KPB] = Tr::dot(a[i], xv[c / KPB], acc[c % KPB]);
        }
#pragma unroll
        for (int i = 0; i < L; ++i) a[i] = an[i];
      }
#pragma unroll
      for (int n = 0; n < NX; ++n) {
#pragma unroll
        for (int e = 0; e < V; ++e) xv[n][e] = xn[n][e];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// One warp over a run of blocks of at most 4 KB
// ---------------------------------------------------------------------------

// The warp's row sums of blocks [first, first + count): afterwards lane
// (lane < P, lane % RC == 0) holds rows lane / RC + (32 / RC) k in acc[k].
// The partial sums leave the lanes by a fixed xor butterfly: first over the
// lanes on other blocks (P < 32), then over the RC lanes of one row.
template <class Tr, int BM, int BN>
struct WarpRows {
  // 4 KB f32 blocks take 16 loads a round (two blocks, two x chunks per
  // lane); other blocks 8, which keeps every instantiation free of spills.
  static constexpr int L = Tr::V == 4 && BM * BN >= 512 ? 2 * kLoads : kLoads;
  using S = Stream<Tr, BM, BN, 32, L>;
  using Vec = typename Tr::Vec;
  static constexpr int RC = S::RC, C = S::C, KPB = S::KPB;
  static constexpr int P = C < 32 ? C : 32;  // lanes on distinct chunks
  static_assert(C <= kWarpBlockChunks && S::G == 1, "shape");

  static __device__ __forceinline__ void run(
      const int32_t* __restrict__ block_cols, const uint4* __restrict__ data,
      const Vec* __restrict__ x, int first, int count, int lane,
      Vec (&acc)[KPB]) {
    S::run(block_cols, data, x, first, count * C, lane, acc);
#pragma unroll
    for (int k = 0; k < KPB; ++k) {
#pragma unroll
      for (int off = 16; off >= P; off >>= 1) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
#pragma unroll
      for (int off = RC / 2; off > 0; off >>= 1) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
    }
  }
  static __device__ __forceinline__ bool holds(int lane) {
    return lane < P && lane % RC == 0;
  }
  static __device__ __forceinline__ int row(int lane, int k) {
    return lane / RC + (32 / RC) * k;
  }
};

// ---------------------------------------------------------------------------
// Short rows: one warp per block-row.
// ---------------------------------------------------------------------------

template <class Tr, int BM, int BN>
__device__ __forceinline__ void short_row(
    const int32_t* __restrict__ block_cols, const uint4* __restrict__ data,
    const typename Tr::Vec* __restrict__ x, typename Tr::Vec* __restrict__ y,
    int4 task, int lane) {
  using WR = WarpRows<Tr, BM, BN>;
  typename Tr::Vec acc[WR::KPB];
  WR::run(block_cols, data, x, task.y, task.z - task.y, lane, acc);
  if (WR::holds(lane)) {
    typename Tr::Vec* yr = y + static_cast<size_t>(task.x) * BM;
#pragma unroll
    for (int k = 0; k < WR::KPB; ++k) yr[WR::row(lane, k)] = acc[k];
  }
}

// ---------------------------------------------------------------------------
// Long rows: one thread block per block-row.
// ---------------------------------------------------------------------------

// The thread block's row sums of blocks [b0, b1), left in thread t < BM.
// Blocks of at most 4 KB: the row is cut into kWarps contiguous runs,
// one per warp (so that a lane reuses its x chunk for KPB rows of a block),
// and the warps' sums meet in shared memory in warp order.  Larger blocks:
// the thread block streams the row as one team (Stream, W = kThreads),
// and partial q = (t + W k) / RL of a butterfly over the RL lanes of a row
// goes to shared memory; row i sums, in order, the partials j (C / RL) +
// i (RC / RL) + e for the W / C block offsets j and the RC / RL warps e of
// a row.
template <class Tr, int BM, int BN>
__device__ __forceinline__ typename Tr::Vec segment_sum(
    const int32_t* __restrict__ block_cols, const uint4* __restrict__ data,
    const typename Tr::Vec* __restrict__ x, int b0, int b1,
    typename Tr::Vec* part) {
  using Vec = typename Tr::Vec;
  constexpr int W = kThreads, RC = BN / Tr::V, C = BM * RC;
  const int t = threadIdx.x;
  Vec sum = Vec(0);
  if constexpr (C <= kWarpBlockChunks) {
    using WR = WarpRows<Tr, BM, BN>;
    const int w = t / 32, lane = t % 32;
    const long long len = b1 - b0;
    const int first = b0 + static_cast<int>(len * w / kWarps);
    const int end = b0 + static_cast<int>(len * (w + 1) / kWarps);
    Vec acc[WR::KPB];
    WR::run(block_cols, data, x, first, end - first, lane, acc);
    if (WR::holds(lane)) {
#pragma unroll
      for (int k = 0; k < WR::KPB; ++k) part[w * BM + WR::row(lane, k)] = acc[k];
    }
    __syncthreads();
    if (t < BM) {
#pragma unroll
      for (int j = 0; j < kWarps; ++j) sum += part[j * BM + t];
    }
  } else {
    using S = Stream<Tr, BM, BN, W, kLoads>;
    constexpr int KPB = S::KPB;
    constexpr int RL = RC < 32 ? RC : 32;  // lanes of a row in one warp
    static_assert((C > W ? C : W) / RL <= kPartials, "shape");
    Vec acc[KPB];
    S::run(block_cols, data, x, b0, (b1 - b0) * C, t, acc);
#pragma unroll
    for (int k = 0; k < KPB; ++k) {
#pragma unroll
      for (int off = RL / 2; off > 0; off >>= 1) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
      if (t % RL == 0) part[(t + W * k) / RL] = acc[k];
    }
    __syncthreads();
    constexpr int JB = C < W ? W / C : 1;
    if (t < BM) {
#pragma unroll
      for (int j = 0; j < JB; ++j) {
#pragma unroll
        for (int e = 0; e < RC / RL; ++e) {
          sum += part[j * (C / RL) + t * (RC / RL) + e];
        }
      }
    }
  }
  return sum;
}

template <class Tr, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
block_spmv_kernel(const int4* __restrict__ schedule,
                  const int32_t* __restrict__ block_cols,
                  const uint4* __restrict__ data,
                  const typename Tr::Vec* __restrict__ x,
                  typename Tr::Vec* __restrict__ y, int num_long,
                  int num_short) {
  using Vec = typename Tr::Vec;
  const int b = blockIdx.x;
  if (b < num_long) {
    __shared__ Vec part[kPartials];
    const int4 task = __ldg(schedule + b);
    const Vec sum =
        segment_sum<Tr, BM, BN>(block_cols, data, x, task.y, task.z, part);
    if (threadIdx.x < BM) {
      y[static_cast<size_t>(task.x) * BM + threadIdx.x] = sum;
    }
    return;
  }
  constexpr int C = BM * (BN / Tr::V);
  if constexpr (C <= kWarpBlockChunks) {
    const int i = (b - num_long) * kWarps + threadIdx.x / 32;
    if (i < num_short) {
      short_row<Tr, BM, BN>(block_cols, data, x, y,
                            __ldg(schedule + num_long + i),
                            threadIdx.x % 32);
    }
  }
}

template <class Tr>
int launch(const int4* schedule, const int32_t* block_cols, const void* data,
           const typename Tr::Vec* x, typename Tr::Vec* y, int num_block_rows,
           int num_long, int bm, int bn, int device, cudaStream_t stream) {
  if (num_block_rows < 0 || num_long < 0 || num_long > num_block_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(schedule) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (num_block_rows == 0) return 0;
  // This library's CUDA runtime keeps its own current device: launch on
  // the card that holds the tensors.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_short = num_block_rows - num_long;
  const dim3 grid(num_long + (num_short + kWarps - 1) / kWarps);
  const uint4* blocks = static_cast<const uint4*>(data);
#define OTT_BLOCK_SPMV_CASE(BM_, BN_)                                      \
  if (bm == BM_ && bn == BN_) {                                            \
    if (num_short > 0 && BM_ * (BN_ / Tr::V) > kWarpBlockChunks) {         \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    block_spmv_kernel<Tr, BM_, BN_><<<grid, kThreads, 0, stream>>>(        \
        schedule, block_cols, blocks, x, y, num_long, num_short);          \
    return static_cast<int>(cudaGetLastError());                           \
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

// ---------------------------------------------------------------------------
// The row layout: y = A x over the nonzeros alone
// ---------------------------------------------------------------------------
//
// block_spmv_kernel_rows<Tr> (Tr = ExactF32, ExactF64) replaces no TPU
// kernel: the TPU module has no dynamic indexing, so it has only blocks.
// It serves matrices of low fill, where the blocks hold mostly zeros:
// tiled_spmv.make_row_layout keeps the values in the matrix's dtype, int32
// column indices and int32 row pointers over the padded rows (padded rows
// are empty, so they get 0), the rows stored bin by bin with the matrix
// row of each (order), and tiled_spmv.prefer_rows attaches it where it
// reads at most half the bytes of the stored blocks.  On the 12,700 x
// 280,000 flow LP of 840,000 nonzeros (47,360 blocks of 8x128, 1.73%
// fill) the blocks are 388 MB of f64 a product and the rows 10.1 MB.
//
// Bound: bytes (0.19 flop a byte in f64).  Each value and column index is
// read once, from device memory, out of L1 (ld_row<false>, as ld_stream);
// x is gathered through the read-only path, where it stays in L2 (the flow
// LP's x is 2.24 MB and its y 100 KB, in a 50 MB L2); y is written once.
//
// Teams: a row goes to a team of 1 to 32 lanes of one warp, by its length
// (tiled_spmv.row_bins: the fewest lanes that leave each at most 4
// nonzeros).  The rows are stored bin by bin, widest teams first, and run
// so in one launch: bin i takes thread blocks [start[i], start[i + 1]),
// each of kRowThreads / lanes rows.  A row's matrix row (order) is read
// beside its pointers and used only for the store, so it adds no step to
// the chain of loads.  Lane l of a team takes the row's nonzeros l, l +
// lanes, ...: neighbouring lanes read neighbouring values.  A pass makes
// kRowUnroll loads of values and indices per lane (the last index
// clamped, so no load sits under a branch), then their kRowUnroll gathers
// of x, then the sums.  Teams of 1 and 2 lanes keep their values in L1:
// the warp's lanes read neighbouring rows, so one line serves several
// loads of theirs.
//
// Numbers (NVIDIA H100 80GB HBM3, 700 W, L2-cold; PERF.md, Findings): the
// flow LP's A 10.1 us and A^T 7.9 us against 3.7 and 4.4 us for their
// bytes; the block kernel took 134 and 125 us on the same matrices, torch's
// CSR product 15.2 and 16.1.  Measured in one call against this design (A
// 10.1 us, A^T 8.6, the relaxation's A 4.5) and not kept: rows in matrix
// order with the order read first (A^T 9.1 us, the relaxation's A 5.0); 2
// or 8 nonzeros a lane (A 11.1 and 9.8 us, the relaxation's A 4.6 and
// 5.7); 16 loads a pass for the 32-lane teams (A 9.1 us, the relaxation's
// A 5.2); 256 threads a block (no change); every load kept in L1, or none
// (A 11.2 us; A^T 10.4).
//
// Deterministic output: each lane sums its nonzeros in order, the team's
// sums meet by a fixed xor butterfly, and lane 0 writes the row's y entry,
// once; no atomics, so repeated launches are bit-identical.

constexpr int kRowThreads = 128;  // threads of a thread block
constexpr int kRowBins = 6;       // teams of 32 >> i lanes, i < kRowBins
constexpr int kRowUnroll = 4;     // loads of each array per lane a pass

struct RowBins {
  int start[kRowBins + 1];  // bin i: thread blocks [start[i], start[i + 1])
  int first[kRowBins];      // its stored rows: [first[i], first[i] + rows[i])
  int rows[kRowBins];
};

// Loads of one scalar from the read-only path: kept out of L1 (kKeep
// false) or cached there.  Volatile, like ld_stream.
template <bool kKeep>
__device__ __forceinline__ double ld_row(const double* p) {
  double v;
  if constexpr (kKeep) {
    asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.f64 %0, [%1];"
                 : "=d"(v) : "l"(p));
  }
  return v;
}

template <bool kKeep>
__device__ __forceinline__ float ld_row(const float* p) {
  float v;
  if constexpr (kKeep) {
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
                 : "=f"(v) : "l"(p));
  }
  return v;
}

template <bool kKeep>
__device__ __forceinline__ int32_t ld_row(const int32_t* p) {
  int32_t v;
  if constexpr (kKeep) {
    asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.s32 %0, [%1];"
                 : "=r"(v) : "l"(p));
  }
  return v;
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The stored rows [first, first + rows) on teams of T lanes; this thread
// block is the bin's `block`-th.
template <class Vec, int T>
__device__ __forceinline__ void row_team(
    const int32_t* __restrict__ order, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ cols, const Vec* __restrict__ values,
    const Vec* __restrict__ x, Vec* __restrict__ y, int first, int rows,
    int block) {
  constexpr bool kKeep = T < 4;
  const int team =
      block * (kRowThreads / T) + static_cast<int>(threadIdx.x) / T;
  if (team >= rows) return;  // a team's lanes leave together
  const int lane = threadIdx.x % T;
  const int i = first + team;  // the stored row; r, the matrix's
  const int start = __ldg(row_ptr + i);
  const int end = __ldg(row_ptr + i + 1);
  const int r = __ldg(order + i);
  Vec acc = Vec(0);
  for (int k0 = start + lane; k0 < end; k0 += T * kRowUnroll) {
    Vec v[kRowUnroll];
    int32_t c[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int k = min(k0 + T * u, end - 1);
      v[u] = ld_row<kKeep>(values + k);
      c[u] = ld_row<kKeep>(cols + k);
    }
    Vec xv[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) xv[u] = ld_row<true>(x + c[u]);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (k0 + T * u < end) acc = fma_rn(v[u], xv[u], acc);
    }
  }
  if constexpr (T > 1) {
    unsigned mask = 0xffffffffu;  // the team's lanes of the warp
    if constexpr (T < 32) {
      mask = ((1u << T) - 1u) << ((threadIdx.x % 32) & ~(T - 1));
    }
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(mask, acc, off, T);
    }
  }
  if (lane == 0) y[r] = acc;
}

template <class Tr>
__global__ void __launch_bounds__(kRowThreads)
block_spmv_kernel_rows(const int32_t* __restrict__ order,
                       const int32_t* __restrict__ row_ptr,
                       const int32_t* __restrict__ cols,
                       const typename Tr::Vec* __restrict__ values,
                       const typename Tr::Vec* __restrict__ x,
                       typename Tr::Vec* __restrict__ y, RowBins bins) {
  using Vec = typename Tr::Vec;
  const int b = blockIdx.x;
  // The last bin that starts at or before b (an empty bin starts where
  // the next one does, so it is passed over).
  int bin = 0;
#pragma unroll
  for (int i = 1; i < kRowBins; ++i) bin += b >= bins.start[i];
#define OTT_ROW_BIN(I)                                                     \
  case I:                                                                  \
    row_team<Vec, (32 >> I)>(order, row_ptr, cols, values, x, y,           \
                             bins.first[I], bins.rows[I],                  \
                             b - bins.start[I]);                           \
    break;
  switch (bin) {
    OTT_ROW_BIN(0)
    OTT_ROW_BIN(1)
    OTT_ROW_BIN(2)
    OTT_ROW_BIN(3)
    OTT_ROW_BIN(4)
    OTT_ROW_BIN(5)
  }
#undef OTT_ROW_BIN
}

template <class Tr>
int launch_rows(const int32_t* order, const int32_t* row_ptr,
                const int32_t* cols, const typename Tr::Vec* values,
                const typename Tr::Vec* x, typename Tr::Vec* y,
                const int32_t* bin_rows, int num_rows, int device,
                cudaStream_t stream) {
  RowBins bins;
  long long blocks = 0;
  long long first = 0;
  bins.start[0] = 0;
  for (int i = 0; i < kRowBins; ++i) {
    if (bin_rows[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    bins.first[i] = static_cast<int>(first);
    bins.rows[i] = bin_rows[i];
    first += bin_rows[i];
    blocks += (static_cast<long long>(bin_rows[i]) * (32 >> i) +
               kRowThreads - 1) / kRowThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    bins.start[i + 1] = static_cast<int>(blocks);
  }
  if (num_rows < 0 || first != num_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  block_spmv_kernel_rows<Tr><<<static_cast<unsigned>(blocks), kRowThreads, 0,
                               stream>>>(order, row_ptr, cols, values, x, y,
                                         bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the launch's CUDA
// error: 0 when the kernel was launched.  data, x and the schedule must be
// 16-byte aligned; the schedule is make_layout's table of (block-row, first
// block, end block, 0), num_long long rows first, then the short ones.
extern "C" {

int block_spmv_exact_f32(const void* schedule, const int32_t* block_cols,
                         const float* data, const float* x, float* y,
                         int num_block_rows, int num_long, int bm, int bn,
                         int device, void* stream) {
  return launch<ExactF32>(static_cast<const int4*>(schedule), block_cols,
                          data, x, y, num_block_rows, num_long, bm, bn, device,
                          static_cast<cudaStream_t>(stream));
}

int block_spmv_exact_f64(const void* schedule, const int32_t* block_cols,
                         const double* data, const double* x, double* y,
                         int num_block_rows, int num_long, int bm, int bn,
                         int device, void* stream) {
  return launch<ExactF64>(static_cast<const int4*>(schedule), block_cols,
                          data, x, y, num_block_rows, num_long, bm, bn, device,
                          static_cast<cudaStream_t>(stream));
}

int block_spmv_fast_bf16(const void* schedule, const int32_t* block_cols,
                         const void* data, const float* x, float* y,
                         int num_block_rows, int num_long, int bm, int bn,
                         int device, void* stream) {
  return launch<FastBf16>(static_cast<const int4*>(schedule), block_cols,
                          data, x, y, num_block_rows, num_long, bm, bn, device,
                          static_cast<cudaStream_t>(stream));
}

// The row kernel: order, row_ptr, cols and values are make_row_layout's
// (device); bin_rows, the rows of each of the six bins (32, 16, 8, 4, 2
// and 1 lanes), is a host array, read before the launch.
int block_spmv_rows_f32(const int32_t* order, const int32_t* row_ptr,
                        const int32_t* cols, const float* values,
                        const float* x, float* y, const int32_t* bin_rows,
                        int num_rows, int device, void* stream) {
  return launch_rows<ExactF32>(order, row_ptr, cols, values, x, y, bin_rows,
                               num_rows, device,
                               static_cast<cudaStream_t>(stream));
}

int block_spmv_rows_f64(const int32_t* order, const int32_t* row_ptr,
                        const int32_t* cols, const double* values,
                        const double* x, double* y, const int32_t* bin_rows,
                        int num_rows, int device, void* stream) {
  return launch_rows<ExactF64>(order, row_ptr, cols, values, x, y, bin_rows,
                               num_rows, device,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
