// Block-row SpMM of the batched PDLP solve: Y = X A^T, that is
// Y[b, :] = A X[b, :] for B instances at once; and, at the end of the
// file, the same product over the row layout of a low-fill matrix
// (block_spmm_kernel_rows).  X is [B, N] and Y is [B, M],
// both contiguous with the batch leading (the layout of the batched state).
// A is the block-row layout of block_spmv.cu: dense (bm x bn) blocks sorted
// by (row, col), data [num_blocks, bm, bn] row-major, block_cols per block,
// row_ptr over the block-rows; and make_layout's SpMM work items
// (tiled_spmv.py::spmm_schedule), one (first block-row, end block-row,
// first row within the blocks, 0) entry each.
//
// What it replaces: ortools_tpu/ops/block_sparse.py::_block_matmat, the XLA
// block einsum (gather, "bij,bjk->bik", segment_sum) that the JAX package's
// batched solve (jax.vmap of the single-device functions) runs for every
// product.  It is not a Pallas kernel; the port runs no product on a card
// except through its own kernels.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 and 34 f64 outside the
// tensor cores, at 700 W): the blocks once plus X and Y once each, against
// 2 flops per stored entry per instance.  At the bench shape (16384^2, 4096
// blocks of 8x128) and B = 64 in f32: 25.2 MB, 7.5 us; 0.54 GFLOP, 8.0 us.
// A row-wise kernel also gathers each block's x segment for every instance
// through L2: nb * bn * B * 4 bytes, 134 MB for A (8x128 blocks) and 8.4 MB
// for A^T (128x8) at that shape, which the bound does not count.
//
// The design (it replaces a first kernel that took one block-row and 32
// instances per thread block, staged x, then computed with nothing in
// flight, and summed 8 column parts per row: 63-70 us at that shape):
// - Work items (tiled_spmv.py::spmm_schedule): an item takes up to 32 rows
//   of each of its blocks and 64 instances (gridDim.y tiles the batch).
//   Block-rows of blocks at most 32 tall are grouped into items of several
//   consecutive rows (at most 2048 stored entries, or one longer row), so
//   that each item pays one start-up for several short rows; taller blocks
//   are split into slices of 32 rows, one item per row and slice, so that
//   a long row of tall blocks keeps several SMs busy.  Items come longest
//   first.
// - Register tiles: each thread keeps 4 rows x 8 instances of sums in f32
//   (4 x 4 in f64).  Per 16 bytes of k it loads 4 A vectors and 8 (4) x
//   vectors from shared memory for 128 (32) FMAs.  Instances are strided
//   (ig + IG j) and rows padded by 16 bytes, so that a warp's x loads hit
//   distinct bank groups and its A loads are few broadcast addresses.
// - Where a block-row's tile has fewer threads' worth of work than the
//   thread block (8-row blocks), the thread block splits k KS ways; the KS
//   partial tiles meet at the end of each row in the stage just consumed
//   and are summed in a fixed order.
// - Pipelined staging: a ring of 2 stages in dynamic shared memory, each a
//   k-slice of one block (or several narrow blocks of one row): its rows
//   of A and the 64 instances' x segments, copied with cp.async (16 bytes
//   a thread, cached in L2 only) while the other stage is multiplied.  A
//   third stage, larger stages and a bulk-copy (TMA) ring for x each lost:
//   they cost resident thread blocks (PERF.md).
// What holds it back (PERF.md): for 8-row blocks the short steps (2 chunks
// of 16 bytes per thread between barriers) and the x gather, which alone
// adds about a third; for 128-row blocks the FMA and shared-memory issue
// rate.
//
// Deterministic output: each Y entry is written by exactly one thread, each
// thread sums its k range in a fixed order, and the partial tiles meet in a
// fixed order; no atomics, so repeated launches are bit-identical.  The
// kernel launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBatchTile = 64;  // instances of a work item
constexpr int kRows = 4;        // rows of a thread's register tile
constexpr int kInstF32 = 8;     // instances of a thread's register tile, f32
constexpr int kInstF64 = 4;     // and f64
constexpr int kMaxRows = 32;    // rows of its blocks an item takes (SPMM_ROWS)
constexpr int kItemRows = 64;   // block-rows of an item (SPMM_ITEM_ROWS)
constexpr int kStages = 2;      // of the ring
constexpr int kSlotBytes = 256;     // of a row of a stage's slot, at most
constexpr int kStageBytes = 20480;  // of a stage of narrow blocks, at most
constexpr int kMinThreads = 128;    // of a thread block
constexpr int kMinBlocks = 1;       // __launch_bounds__: no register cap
constexpr int kUnroll = 1;          // 16-byte k chunks per loop round

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int pow2_floor(int v) { return v < 2 ? 1 : 2 * pow2_floor(v / 2); }

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
  static __device__ __forceinline__ void store4(float* p, float a, float b,
                                                float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
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
  static __device__ __forceinline__ void store4(double* p, double a, double b,
                                                double c, double d) {
    reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
    reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
  }
  static __device__ __forceinline__ double2 zero() {
    return make_double2(0.0, 0.0);
  }
};

// 16 bytes from global to shared memory, cached in L2 only; with
// valid == false the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// The tiling of one (bm x bn) block shape.
template <class T, int BM, int BN>
struct Cfg {
  static constexpr int SZ = static_cast<int>(sizeof(T));
  static constexpr int VEC = 16 / SZ;              // values per 16 bytes
  static constexpr int RT = cmin(BM, kMaxRows);     // rows of an item
  static constexpr int RG = RT / kRows;             // row groups
  static constexpr int INST = SZ == 4 ? kInstF32 : kInstF64;
  static constexpr int IG = kBatchTile / INST;      // instance groups
  static constexpr int GS = RG * IG;                // threads of a k group
  static constexpr int THREADS = cmax(GS, kMinThreads);
  static constexpr int KS = THREADS / GS;           // k groups
  static constexpr int KC = cmin(BN, kSlotBytes / SZ);  // columns of a slot
  static constexpr int STEPS = BN / KC;             // slots of a block
  static constexpr int ACH = KC / VEC;              // 16-byte chunks of a row
  static constexpr int XS = KC + VEC;               // padded row of a slot
  static constexpr int A_SLOT = RT * XS;
  static constexpr int SLOT = A_SLOT + kBatchTile * XS;
  static constexpr int G =                          // blocks of a stage
      STEPS > 1 ? 1 : pow2_floor(cmax(1, kStageBytes / (SLOT * SZ)));
  static constexpr int STAGE = G * SLOT;
  static constexpr int CW = G * KC / KS;            // columns of a k group
  // The k groups' partial tiles [KS][64][PS]: in the stage just consumed
  // where they fit (rows padded where that still fits), else after the
  // ring.
  static constexpr int PS =
      KS * kBatchTile * (RT + VEC) <= STAGE ? RT + VEC : RT;
  static constexpr int PART = KS > 1 ? KS * kBatchTile * PS : 0;
  static constexpr bool PART_IN_RING = PART <= STAGE;
  static constexpr int SMEM =
      (kStages * STAGE + (PART_IN_RING ? 0 : PART)) * SZ;
  static_assert(BM % RT == 0 && RT % kRows == 0 && BN % KC == 0 &&
                    kRows % 4 == 0, "shape");
  static_assert(KC % VEC == 0 && CW % VEC == 0 && CW > 0, "k split");
  static_assert(THREADS % 32 == 0 && THREADS <= 1024 && THREADS % ACH == 0,
                "threads");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// Where a walk over an item's blocks stands: block p, column offset kc
// within it, and row r (an index into the item's row_ptr slice rp, whose
// row ends past p).
struct Cursor {
  int p, kc, r;
};

template <class T, int BM, int BN>
__global__ void __launch_bounds__(Cfg<T, BM, BN>::THREADS, kMinBlocks)
block_spmm_kernel(const int4* __restrict__ items,
                  const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ block_cols,
                  const T* __restrict__ data, const T* __restrict__ x,
                  T* __restrict__ y, int batch, int n, int m) {
  using C = Cfg<T, BM, BN>;
  using VT = Vec16<T>;
  using V = typename VT::V;
  constexpr int ACH = C::ACH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int rp[kItemRows + 1];

  const int4 item = __ldg(items + blockIdx.x);
  const int r0 = item.x, nrows = item.y - item.x, ro = item.z;
  const int b0 = blockIdx.y * kBatchTile;
  const int t = threadIdx.x;
  const int kg = t / C::GS, u = t % C::GS;
  const int rg = u / C::IG, ig = u % C::IG;

  for (int i = t; i <= nrows; i += C::THREADS) rp[i] = __ldg(row_ptr + r0 + i);
  __syncthreads();

  // Rows without blocks: zeros.
  for (int r = 0; r < nrows; ++r) {
    if (rp[r] != rp[r + 1]) continue;
    T* yr = y + static_cast<size_t>(r0 + r) * BM + ro;
    for (int e = t; e < kBatchTile * (C::RT / C::VEC); e += C::THREADS) {
      const int q = e % (C::RT / C::VEC), bb = e / (C::RT / C::VEC);
      if (b0 + bb < batch) {
        *reinterpret_cast<V*>(yr + static_cast<size_t>(b0 + bb) * m +
                              q * C::VEC) = VT::zero();
      }
    }
  }

  const int p_end = rp[nrows];
  // Blocks of the step at c: 1, or for narrow blocks up to G of its row.
  auto count = [&](const Cursor& c) {
    return C::G == 1 ? 1 : min(C::G, rp[c.r + 1] - c.p);
  };
  // Moves c past its step; true when that step ended c's row.
  auto advance = [&](Cursor& c) {
    if (C::STEPS > 1) {
      c.kc += C::KC;
      if (c.kc < BN) return false;
      c.kc = 0;
      c.p += 1;
    } else {
      c.p += count(c);
    }
    if (c.p < rp[c.r + 1]) return false;
    while (c.r < nrows - 1 && rp[c.r + 1] <= c.p) ++c.r;
    return true;
  };
  // Stage s gets the step at c: G slots, those past its row zero-filled
  // (their products add exact zeros).  The loops have fixed trip counts
  // and no branch around a copy (an address past the row is clamped), so
  // every copy of a step is in flight at once.
  auto issue = [&](int s, const Cursor& c) {
    T* st = smem + s * C::STAGE;
    const int g_n = count(c);
    const T* blk = data + static_cast<size_t>(c.p) * BM * BN +
                   static_cast<size_t>(ro) * BN + c.kc;
    constexpr int A_CH = C::G * C::RT * ACH;
#pragma unroll
    for (int i = 0; i < (A_CH + C::THREADS - 1) / C::THREADS; ++i) {
      const int e = t + i * C::THREADS;
      if (A_CH % C::THREADS == 0 || e < A_CH) {
        const int q = e % ACH, row = (e / ACH) % C::RT;
        const int g = e / (ACH * C::RT);
        const bool valid = g < g_n;
        cp_async16(st + g * C::SLOT + row * C::XS + q * C::VEC,
                   valid ? blk + static_cast<size_t>(g) * BM * BN +
                               row * BN + q * C::VEC
                         : data,
                   valid);
      }
    }
    // x: thread t copies chunk t % ACH of rows t / ACH, + RSTEP, ...
    constexpr int X_ROWS = C::G * kBatchTile, RSTEP = C::THREADS / ACH;
    const int q = t % ACH, rr0 = t / ACH;
    const T* xq = x + static_cast<size_t>(c.kc) + q * C::VEC;
    const int col0 = __ldg(block_cols + c.p);
#pragma unroll
    for (int i = 0; i < (X_ROWS + RSTEP - 1) / RSTEP; ++i) {
      const int rr = rr0 + i * RSTEP;
      if (X_ROWS % RSTEP == 0 || rr < X_ROWS) {
        const int bb = C::G == 1 ? rr : rr % kBatchTile;
        const int g = C::G == 1 ? 0 : rr / kBatchTile;
        const bool valid = g < g_n && b0 + bb < batch;
        const int col =
            C::G == 1 ? col0 : __ldg(block_cols + c.p + min(g, g_n - 1));
        cp_async16(st + g * C::SLOT + C::A_SLOT + bb * C::XS + q * C::VEC,
                   valid ? xq + static_cast<size_t>(b0 + bb) * n +
                               static_cast<size_t>(col) * BN
                         : x,
                   valid);
      }
    }
  };

  T acc[kRows][C::INST];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < C::INST; ++j) acc[i][j] = T(0);
  }

  Cursor prod{rp[0], 0, 0};
  while (prod.r < nrows - 1 && rp[prod.r + 1] <= prod.p) ++prod.r;
  Cursor cons = prod;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (prod.p < p_end) {
      issue(s, prod);
      advance(prod);
    }
    cp_async_commit();
  }

  int s_cons = 0, s_prod = kStages - 1;
  while (cons.p < p_end) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s_cons has landed; s_prod's readers are done
    if (prod.p < p_end) {
      issue(s_prod, prod);
      advance(prod);
    }
    cp_async_commit();
    s_prod = s_prod + 1 == kStages ? 0 : s_prod + 1;

    const T* st = smem + s_cons * C::STAGE;
#pragma unroll kUnroll
    for (int c = 0; c < C::CW; c += C::VEC) {
      const int col = kg * C::CW + c;
      const int g = col / C::KC, k = col % C::KC;
      const T* sa = st + g * C::SLOT + rg * kRows * C::XS + k;
      const T* sx = st + g * C::SLOT + C::A_SLOT + ig * C::XS + k;
      V a[kRows], xv[C::INST];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = *reinterpret_cast<const V*>(sa + i * C::XS);
      }
#pragma unroll
      for (int j = 0; j < C::INST; ++j) {
        xv[j] = *reinterpret_cast<const V*>(sx + j * C::IG * C::XS);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < C::INST; ++j) {
          acc[i][j] = VT::dot(a[i], xv[j], acc[i][j]);
        }
      }
    }
    const int s_done = s_cons;
    s_cons = s_cons + 1 == kStages ? 0 : s_cons + 1;

    const int row = cons.r;
    if (!advance(cons)) continue;
    // The row is done: its tile goes to Y.
    T* yr = y + static_cast<size_t>(r0 + row) * BM + ro;
    if (C::KS == 1) {
#pragma unroll
      for (int j = 0; j < C::INST; ++j) {
        const int b = b0 + ig + j * C::IG;
        if (b < batch) {
#pragma unroll
          for (int i = 0; i < kRows; i += 4) {
            VT::store4(yr + static_cast<size_t>(b) * m + rg * kRows + i,
                       acc[i][j], acc[i + 1][j], acc[i + 2][j],
                       acc[i + 3][j]);
          }
        }
      }
    } else {
      T* part = smem + (C::PART_IN_RING ? s_done : kStages) * C::STAGE;
      if (C::PART_IN_RING) __syncthreads();  // stage s_done is read
#pragma unroll
      for (int j = 0; j < C::INST; ++j) {
#pragma unroll
        for (int i = 0; i < kRows; i += 4) {
          VT::store4(part + (kg * kBatchTile + ig + j * C::IG) * C::PS +
                         rg * kRows + i,
                     acc[i][j], acc[i + 1][j], acc[i + 2][j], acc[i + 3][j]);
        }
      }
      __syncthreads();
      for (int e = t; e < C::RT * kBatchTile; e += C::THREADS) {
        const int i = e % C::RT, bb = e / C::RT;
        T sum = part[bb * C::PS + i];
#pragma unroll
        for (int k = 1; k < C::KS; ++k) {
          sum += part[(k * kBatchTile + bb) * C::PS + i];
        }
        if (b0 + bb < batch) yr[static_cast<size_t>(b0 + bb) * m + i] = sum;
      }
      // part is written again (or s_done refilled) only after the next
      // step's __syncthreads.
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < C::INST; ++j) acc[i][j] = T(0);
    }
  }
  cp_async_wait<0>();
}

template <class T, int BM, int BN>
int launch_shape(const int4* items, const int32_t* row_ptr,
                 const int32_t* block_cols, const T* data, const T* x, T* y,
                 int num_items, int batch, int n, int m,
                 cudaStream_t stream) {
  using C = Cfg<T, BM, BN>;
  auto kernel = block_spmm_kernel<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(num_items, (batch + kBatchTile - 1) / kBatchTile);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(items, row_ptr, block_cols,
                                                data, x, y, batch, n, m);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const int4* items, const int32_t* row_ptr,
           const int32_t* block_cols, const T* data, const T* x, T* y,
           int num_items, int num_block_rows, int bm, int bn, int batch, int n,
           int m, int device, cudaStream_t stream) {
  if (num_items < 0 || num_block_rows < 0 || batch < 0 || n < 0 ||
      m != num_block_rows * bm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(items) % 16 != 0 ||
      (static_cast<size_t>(n) * sizeof(T)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (num_items == 0 || batch == 0) return 0;
  // This library's CUDA runtime keeps its own current device: launch on
  // the card that holds the tensors.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
#define OTT_BLOCK_SPMM_CASE(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_) {                                              \
    return launch_shape<T, BM_, BN_>(items, row_ptr, block_cols, data, x, y, \
                                     num_items, batch, n, m, stream);        \
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

// ---------------------------------------------------------------------------
// The row layout: Y = X A^T over the nonzeros alone
// ---------------------------------------------------------------------------
//
// block_spmm_kernel_rows<T> (T = float, double) replaces no TPU
// kernel and no XLA code: the TPU stores blocks only.  It serves the
// batched products of matrices of low fill, which carry the row layout of
// block_spmv.cu's row kernel (tiled_spmv.make_row_layout: values in the
// matrix's dtype, int32 column indices, int32 row pointers over the padded
// rows, the rows stored bin by bin, each bin in matrix order, with the
// matrix row of each in order), where tiled_spmv.prefer_rows_batched says
// it moves fewer bytes than the blocks.  On the 55,520 x 52,520 LP
// relaxation of a class C network design (260,520 nonzeros; rows of 2,
// 26-42 and 101) the 8x128 blocks are 1.17% full: 89 MB of f32 a product,
// and the block kernel gathers 712 MB more of x segments at B = 64.
//
// Bound: bytes.  The work is the nonzeros once and X and Y once (28.7 MB
// at B = 64 in f32, 8.6 us); 2 flops a nonzero and instance.  What costs
// is the gather: X is batch-leading, so the B values of one column lie
// N apart, and a column read for all instances at once is B sectors of 32
// bytes for B * 4 useful bytes.
//
// The design, one launch: the thread blocks first copy X into a scratch
// X^T [N, B] (tiles of 64 instances x 32 columns through shared memory,
// both sides coalesced), meet at a grid-wide barrier (a cooperative
// launch: every thread block resident), then each nonzero reads one
// contiguous row of X^T, B values, out of L2: about 67 MB through L2 for
// the relaxation at B = 64.  The other design timed, direct gathers of X
// (one sector an instance and nonzero, about 530 MB of sectors), was
// twice as slow at B = 64 (PERF.md).  Then a thread block takes a unit of
// consecutive stored rows of one bin, 4 << i rows in bin i (the bins of
// tiled_spmv.row_bins, rows of up to 4 * (32 >> i) nonzeros, so about 128
// nonzeros a warp), and 64 instances (the batch is cut into tiles of 64);
// each warp takes 1 << i consecutive rows of it.  A warp's lanes hold instances lane and lane +
// 32; it loads 32 nonzeros (values and columns) at a time, one a lane,
// then gathers the X rows of kRowsGather of them before their sums, so
// kRowsGather * 2 loads are in flight a lane.  The ends of its rows sit in
// its lanes (one row pointer a lane), so a row's end is a shuffle away,
// and a finished row's sums go to a tile in shared memory [row][instance].
// At the unit's end the thread block writes the tile to Y, each instance's
// rows as one run (rows of a bin are in matrix order, so a unit's rows
// are mostly consecutive rows of Y).  Every padded row is written: an
// empty row gets zeros.
//
// Numbers (NVIDIA H100 80GB HBM3, 700 W, L2-cold, B = 64, f32; PERF.md,
// Findings): the relaxation's A 46.0 us and A^T 38.9 us against 8.6 us for
// the work; the block kernel took 232 and 482 us, torch's CSR product
// with a dense X^T 51.6 and 47.7.  The direct design took 108 and 112 us
// (25 us both at B = 8, where this one takes 34 and 27).  Of the
// staged 46 us, the launch, the copy and the barrier take about 10 (9.5
// at B = 8), the stores of Y about 8, the gathers of X^T 4-5; the rest is
// each unit's chain of dependent loads.  Measured and not kept: 8, 4 or
// 32 nonzeros gathered at once (A 52.8, 51.8, 48.1 us; A^T 43.2, 42.4,
// 50.7), 32 instances a unit (46.5, 48.2), registers capped for 6 or 8
// resident thread blocks (60.8 and 90.4 us for A).
//
// Deterministic output: a row's sums run over its nonzeros in order, in
// one lane an instance, and each Y entry is written once; no atomics, so
// repeated launches are bit-identical.  The kernel launches on the
// caller's stream, allocates nothing (the wrapper gives the scratch), and
// returns cudaGetLastError().

constexpr int kRowsThreads = 128;  // threads of a thread block
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsBins = 6;       // tiled_spmv.ROW_LANES: 32 >> i lanes
constexpr int kRowsTile = 64;      // instances of a unit
constexpr int kRowsPerLane = kRowsTile / 32;
constexpr int kRowsGather = 16;    // nonzeros a warp gathers at once
// Stored rows of a unit at most (bin 5), and the tile's row pitch.
constexpr int kRowsUnitRows = kRowsWarps << (kRowsBins - 1);
constexpr int kRowsPitch = kRowsTile + 1;
static_assert(kRowsTile % 32 == 0 && (kRowsTile * 32) % kRowsThreads == 0 &&
                  32 % kRowsWarps == 0 && kRowsTile * 33 <= kRowsUnitRows *
                  kRowsPitch, "the tiles");

struct RowsBins {
  int start[kRowsBins + 1];  // bin i: units [start[i], start[i + 1])
  int first[kRowsBins];      // its stored rows: [first[i], first[i] + rows[i])
  int rows[kRowsBins];
};

__device__ __forceinline__ float rows_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double rows_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <class T>
__global__ void __launch_bounds__(kRowsThreads)
block_spmm_kernel_rows(const int32_t* __restrict__ order,
                       const int32_t* __restrict__ row_ptr,
                       const int32_t* __restrict__ cols,
                       const T* __restrict__ values, const T* __restrict__ x,
                       T* __restrict__ xt, T* __restrict__ y, RowsBins bins,
                       int batch, int n, int m) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  T* tile = reinterpret_cast<T*>(rows_smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr unsigned kAll = 0xffffffffu;

  // X [batch, n] into X^T [n, batch], a tile of kRowsTile instances x 32
  // columns at a time: each thread loads its kTrans values of the tile
  // (addresses clamped, no branch, so all are in flight), then each warp
  // writes whole columns of X^T, kRowsTile values of one column a store.
  constexpr int kTrans = kRowsTile * 32 / kRowsThreads;
  const long long tn = (n + 31) / 32;
  const long long tiles = tn * ((batch + kRowsTile - 1) / kRowsTile);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int c0 = static_cast<int>(t % tn) * 32;
    const int b0 = static_cast<int>(t / tn) * kRowsTile;
    const int c = min(c0 + lane, n - 1);
    T v[kTrans];
#pragma unroll
    for (int i = 0; i < kTrans; ++i) {
      const int b = min(b0 + warp + kRowsWarps * i, batch - 1);
      v[i] = x[static_cast<size_t>(b) * n + c];
    }
#pragma unroll
    for (int i = 0; i < kTrans; ++i) {
      tile[(warp + kRowsWarps * i) * 33 + lane] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 32 / kRowsWarps; ++i) {
      const int cc = warp + kRowsWarps * i;
      if (c0 + cc < n) {
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const int b = lane + 32 * j;
          if (b0 + b < batch) {
            xt[static_cast<size_t>(c0 + cc) * batch + b0 + b] =
                tile[b * 33 + cc];
          }
        }
      }
    }
    __syncthreads();
  }
  __threadfence();
  cooperative_groups::this_grid().sync();

  const long long units = bins.start[kRowsBins];
  const long long work = units * ((batch + kRowsTile - 1) / kRowsTile);
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const int u = static_cast<int>(w % units);
    const int b0 = static_cast<int>(w / units) * kRowsTile;
    // The last bin that starts at or before u (an empty bin starts where
    // the next one does, so it is passed over).
    int bin = 0;
#pragma unroll
    for (int i = 1; i < kRowsBins; ++i) bin += u >= bins.start[i];
    const int unit_rows = kRowsWarps << bin;
    const int first = bins.first[bin] + (u - bins.start[bin]) * unit_rows;
    const int bin_end = bins.first[bin] + bins.rows[bin];
    const int nrows = min(unit_rows, bin_end - first);
    const int r0 = first + (warp << bin);
    const int nr = min(1 << bin, bin_end - r0);  // this warp's rows
    if (nr > 0) {
      const int start = __ldg(row_ptr + r0);
      const int ends = lane < nr ? __ldg(row_ptr + r0 + lane + 1) : 0;
      const int end = __shfl_sync(kAll, ends, nr - 1);
      T* out = tile + (r0 - first) * kRowsPitch + lane;
      int bs[kRowsPerLane];  // this lane's instances, clamped
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        bs[j] = min(b0 + lane + 32 * j, batch - 1);
      }
      T acc[kRowsPerLane];
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) acc[j] = T(0);
      int cur = 0;  // the warp's row being summed
      int cur_end = __shfl_sync(kAll, ends, 0);
      // 32 nonzeros, one a lane, loaded a pass ahead of their gathers
      int c_next = 0;
      T v_next = T(0);
      if (start < end) {
        const int k = min(start + lane, end - 1);
        c_next = __ldg(cols + k);
        v_next = __ldg(values + k);
      }
      for (int k0 = start; k0 < end; k0 += 32) {
        const int c = c_next;
        const T v = v_next;
        if (k0 + 32 < end) {
          const int k = min(k0 + 32 + lane, end - 1);
          c_next = __ldg(cols + k);
          v_next = __ldg(values + k);
        }
        const int cnt = min(32, end - k0);
#pragma unroll
        for (int g0 = 0; g0 < 32; g0 += kRowsGather) {
          if (g0 >= cnt) break;
          T xs[kRowsGather][kRowsPerLane];
#pragma unroll
          for (int q = 0; q < kRowsGather; ++q) {
            const int cq = __shfl_sync(kAll, c, g0 + q);
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) {
              xs[q][j] = __ldcg(xt + static_cast<size_t>(cq) * batch + bs[j]);
            }
          }
#pragma unroll
          for (int q = 0; q < kRowsGather; ++q) {
            const int kk = k0 + g0 + q;
            if (kk >= end) break;
            while (kk >= cur_end) {  // rows that end before nonzero kk
#pragma unroll
              for (int j = 0; j < kRowsPerLane; ++j) {
                out[cur * kRowsPitch + 32 * j] = acc[j];
                acc[j] = T(0);
              }
              ++cur;
              cur_end = __shfl_sync(kAll, ends, cur);
            }
            const T vq = __shfl_sync(kAll, v, g0 + q);
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) {
              acc[j] = rows_fma(vq, xs[q][j], acc[j]);
            }
          }
        }
      }
      for (; cur < nr; ++cur) {  // the last row, and empty rows after it
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          out[cur * kRowsPitch + 32 * j] = acc[j];
          acc[j] = T(0);
        }
      }
    }
    __syncthreads();
    // The unit's tile to Y: thread tid takes row tid % unit_rows of every
    // (kRowsThreads / unit_rows)-th instance, so that neighbouring threads
    // write neighbouring rows, each instance's rows as one run.
    const int row = tid % unit_rows;
    if (row < nrows) {
      const int jn = min(kRowsTile, batch - b0);
      T* yr = y + static_cast<size_t>(b0) * m + __ldg(order + first + row);
      for (int j = tid / unit_rows; j < jn; j += 32 >> bin) {
        yr[static_cast<size_t>(j) * m] = tile[row * kRowsPitch + j];
      }
    }
    __syncthreads();
  }
}

template <class T>
int launch_rows(const int32_t* order, const int32_t* row_ptr,
                const int32_t* cols, const T* values, const T* x, T* xt, T* y,
                const int32_t* bin_rows, int num_rows, int batch, int n,
                int device, cudaStream_t stream) {
  RowsBins bins;
  long long units = 0;
  long long first = 0;
  bins.start[0] = 0;
  for (int i = 0; i < kRowsBins; ++i) {
    if (bin_rows[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    bins.first[i] = static_cast<int>(first);
    bins.rows[i] = bin_rows[i];
    first += bin_rows[i];
    units += (bin_rows[i] + (kRowsWarps << i) - 1) / (kRowsWarps << i);
    bins.start[i + 1] = static_cast<int>(units);
  }
  if (num_rows < 0 || first != num_rows || batch < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0 || batch == 0) return 0;
  if (xt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto kernel = block_spmm_kernel_rows<T>;
  const int smem = kRowsUnitRows * kRowsPitch * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every thread block resident, for the barrier: as many as fit, or as
  // many as there are tiles of the copy or units of the rows.
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kRowsThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_b = (batch + kRowsTile - 1LL) / kRowsTile;
  const long long tiles = ((n + 31LL) / 32) * tiles_b;
  const long long grid = std::min<long long>(
      std::max(units * tiles_b, tiles), static_cast<long long>(per_sm) * sms);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int m = num_rows;
  void* args[] = {&order, &row_ptr, &cols, &values, &x, &xt,
                  &y,     &bins,    &batch, &n,     &m};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)),
                                    dim3(kRowsThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the launch's CUDA
// error: 0 when the kernel was launched (or there was nothing to do).
// items (make_layout's spmm_schedule, int32 [num_items, 4]), data, x and y
// must be 16-byte aligned, and so must each row of x (n * sizeof(T) a
// multiple of 16); m is num_block_rows * bm.
extern "C" {

int block_spmm_exact_f32(const void* items, const int32_t* row_ptr,
                         const int32_t* block_cols, const float* data,
                         const float* x, float* y, int num_items,
                         int num_block_rows, int bm, int bn, int batch, int n,
                         int m, int device, void* stream) {
  return launch<float>(static_cast<const int4*>(items), row_ptr, block_cols,
                       data, x, y, num_items, num_block_rows, bm, bn, batch,
                       n, m, device, static_cast<cudaStream_t>(stream));
}

int block_spmm_exact_f64(const void* items, const int32_t* row_ptr,
                         const int32_t* block_cols, const double* data,
                         const double* x, double* y, int num_items,
                         int num_block_rows, int bm, int bn, int batch, int n,
                         int m, int device, void* stream) {
  return launch<double>(static_cast<const int4*>(items), row_ptr, block_cols,
                        data, x, y, num_items, num_block_rows, bm, bn, batch,
                        n, m, device, static_cast<cudaStream_t>(stream));
}

// The row kernel: order, row_ptr, cols and values are make_row_layout's
// (device), x is [batch, n] and y [batch, num_rows], both contiguous; xt is
// a scratch of n * batch values for X^T (the staged design); bin_rows, the
// rows of each of the six bins (32, 16, 8, 4, 2 and 1 lanes), is a host
// array, read before the launch.
int block_spmm_rows_f32(const int32_t* order, const int32_t* row_ptr,
                        const int32_t* cols, const float* values,
                        const float* x, float* xt, float* y,
                        const int32_t* bin_rows, int num_rows, int batch,
                        int n, int device, void* stream) {
  return launch_rows<float>(order, row_ptr, cols, values, x, xt, y, bin_rows,
                            num_rows, batch, n, device,
                            static_cast<cudaStream_t>(stream));
}

int block_spmm_rows_f64(const int32_t* order, const int32_t* row_ptr,
                        const int32_t* cols, const double* values,
                        const double* x, double* xt, double* y,
                        const int32_t* bin_rows, int num_rows, int batch,
                        int n, int device, void* stream) {
  return launch_rows<double>(order, row_ptr, cols, values, x, xt, y,
                             bin_rows, num_rows, batch, n, device,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
