// Mutan backward from the bf16 residual v = tanh(x @ W + b) [M, heads*C]
// that the training forward writes (csrc/mutan.cu):
//
// 1. The dz pass.  Replaces the Pallas kernel of
//    cmpc_refseg_tpu/ops/pallas_kernels.py::mutan_bwd_fused.  Per row it
//    rebuilds acc = sum_h v_h * lang_h, y = tanh(acc), the row's sum of
//    squares sq, r = rsqrt(max(sq, 1e-12)) and out = y * r; then from the
//    cotangent g of out: gy = sum g * out, dy = (g - out * gy) * r (g * r
//    where sq <= 1e-12), dacc = dy * (1 - y^2), and writes
//    dz_h = dacc * lang_h * (1 - v_h^2) in bf16.  It also reduces
//    dlang[b] = sum over sample b's rows of dacc * v_h and db = sum over all
//    rows of dz_h (f32, before the bf16 rounding of dz).
//    Bound on the card: bytes (v in, dz out, g in: 282 MB, 0.084 ms at the
//    flagship's bs=8 train step).  Design: a stream in one wave.  The grid
//    is one block per SM, and block b takes the contiguous rows
//    [b M / grid, (b + 1) M / grid), which may cross samples: rows per
//    block do not depend on the divisors of N, and the scratch is bounded
//    by the grid, not by M.  A producer warp brings each stage (up to
//    kDzRows rows of one sample) into a shared-memory ring by two 1-D bulk
//    copies (v's rows, g's rows: contiguous byte ranges, rounded out to
//    16-byte bounds) that complete on the stage's mbarrier, so every v row
//    is read from memory once and both passes read shared memory.  Each
//    consumer thread owns VEC columns in every head and every row (VEC the
//    narrowest of 2, 4, 8 bf16 that C allows and that keeps a row within
//    16 consumer warps: the most warps per SM), so its dlang / db sums stay
//    in registers; the rows of a stage share one barrier for their norms
//    (a transposed warp sum, then the same shuffle tree over the consumer
//    warps in every warp).  dz leaves as VEC-wide stores.  At a sample
//    boundary a block writes its dlang sums to slot b + sample, and at its
//    end its db sums to slot b; a second small pass adds the slots in a
//    fixed order, threads over columns and 8 or 32 lanes over slots (a
//    two-level tree), so the result is deterministic.  Measured (PERF.md):
//    two blocks per SM, deeper rings and 16-byte vectors were all slower.
//
// 2. The dW product dW[K, heads*C] = x^T @ dz, f32 accumulation over all M
//    rows.  Replaces pallas_kernels.py::_mutan_dw_call.  Bound on the card:
//    operations (129 GFLOP at the flagship shapes); only wgmma reaches
//    Hopper's tensor-core rate, and only if its tiles arrive while it works.
//    Design (csrc/hopper.cuh): both operands are read as they lie in memory,
//    M-major: a [64 rows of x][64 of K] TMA box is the A = x^T tile with
//    trans-a = 1 (the TPU kernel's in-VMEM transpose, for free), a [64 rows
//    of dz][64 columns] box the B tile with trans-b = 1.  One producer warp
//    keeps a 4-stage ring (x [64 x 128], dz [64 x 256], 128-byte swizzle,
//    full / empty mbarriers) in flight; two consumer warpgroups each own 64
//    rows x 256 columns of dW in registers for their share of the reduction
//    over M, and store them once, masked at K and W.  Blocks run in 2 x 2
//    clusters: each loads half of the x and of the dz tile and multicasts
//    them to the blocks that share them, which halves the tiles' L2 traffic
//    (~2 GB at 128 x 128 tiles without it, about as long as the product).
//    Blocks that share dz columns are adjacent in launch order, so dz
//    streams from HBM about once and x stays in L2.  The reduction is split
//    over M in two (two f32 partials, added in a fixed order by a second
//    pass, so the result stays deterministic), which fills the 132 SMs'
//    second wave of 128 x 256 tiles: the fastest of the tilings measured
//    (PERF.md).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace cmpc {

// ---------------------------------------------------------------------------
// dz pass
// ---------------------------------------------------------------------------

constexpr int kDzRows = 2;            // rows per stage, at most
constexpr int kDzStages = 2;
constexpr int kDzMaxWarps = 16;       // consumer warps, at most: C <= 512 VEC
constexpr int kDzMaxVals = 40;        // heads * VEC, at most (registers)
constexpr float kNormEps = 1e-12f;

// Bytes of a stage buffer for `elems` bf16 of consecutive rows: a copy
// rounded out to 16-byte bounds takes up to 30 more.
__host__ __device__ __forceinline__ int dz_buf_bytes(int elems) {
  return (elems * 2 + 15) / 16 * 16 + 32;
}

// Byte offsets rounded down and up to 16-byte bounds.
__device__ __forceinline__ size_t floor16(size_t b) { return b & ~static_cast<size_t>(15); }
__device__ __forceinline__ size_t ceil16(size_t b) { return floor16(b + 15); }

// The rows of the stage that starts at `row`: at most kDzRows, none past
// `end` or the end of row's sample (a stage never straddles two samples).
__device__ __forceinline__ int stage_rows(int row, int end, int N) {
  return min(min(kDzRows, end - row), (row / N + 1) * N - row);
}

// Shared memory: kDzStages stages of [v rows | g rows], vbuf + gbuf bytes
// each.  Warps 0 .. cw-1 consume, warp cw produces (blockDim = 32 (cw + 1)).
template <int HEADS, int VEC>
__global__ void __launch_bounds__(32 * (kDzMaxWarps + 1), 1)
mutan_dz_kernel(const bf16* __restrict__ v, const float* __restrict__ lang,
                const bf16* __restrict__ g, bf16* __restrict__ dz,
                float* __restrict__ part_dl, float* __restrict__ part_db, int M, int C,
                int N, int vbuf, int gbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kDzStages], empty[kDzStages];
  __shared__ __align__(16) float red[2][kDzMaxWarps][2 * kDzRows];
  const int W = HEADS * C;
  const int cw = blockDim.x / 32 - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const int row0 = static_cast<int>(static_cast<long long>(b) * M / gridDim.x);
  const int row1 = static_cast<int>(static_cast<long long>(b + 1) * M / gridDim.x);
  const int stage_bytes = vbuf + gbuf;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDzStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cw);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == cw) {
    // producer: one thread copies each stage's v and g rows
    if (lane == 0) {
      int it = 0;
      for (int r = row0; r < row1; ++it) {
        const int n = stage_rows(r, row1, N);
        const int s = it % kDzStages;
        mbar_wait(&empty[s], ((it / kDzStages) & 1) ^ 1);
        unsigned char* buf = smem + s * stage_bytes;
        const size_t v_lo = floor16(static_cast<size_t>(r) * W * 2);
        const size_t v_hi = ceil16(static_cast<size_t>(r + n) * W * 2);
        const size_t g_lo = floor16(static_cast<size_t>(r) * C * 2);
        const size_t g_hi = ceil16(static_cast<size_t>(r + n) * C * 2);
        mbar_arrive_expect_tx(&full[s], static_cast<uint32_t>(v_hi - v_lo + g_hi - g_lo));
        bulk_load(buf, reinterpret_cast<const unsigned char*>(v) + v_lo,
                  static_cast<uint32_t>(v_hi - v_lo), &full[s]);
        bulk_load(buf + vbuf, reinterpret_cast<const unsigned char*>(g) + g_lo,
                  static_cast<uint32_t>(g_hi - g_lo), &full[s]);
        r += n;
      }
    }
    return;
  }

  // consumers: thread t owns columns col ... col + VEC - 1 of every head
  const int col = VEC * threadIdx.x;
  const bool active = col < C;
  float lng[HEADS][VEC], dl[HEADS][VEC], db[HEADS][VEC];
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      lng[h][e] = 0.f;
      dl[h][e] = 0.f;
      db[h][e] = 0.f;
    }
  int cur = row0 / N;   // the sample of dl and lng
  if (active)
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        lng[h][e] = lang[static_cast<size_t>(cur) * W + h * C + col + e];

  int it = 0;
  for (int r = row0; r < row1; ++it) {
    const int n = stage_rows(r, row1, N);
    const int s = it % kDzStages;
    if (r / N != cur) {
      // a new sample: this block's dlang sums of the last one go to its slot
      if (active)
#pragma unroll
        for (int h = 0; h < HEADS; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            part_dl[static_cast<size_t>(b + cur) * W + h * C + col + e] = dl[h][e];
            dl[h][e] = 0.f;
            lng[h][e] = lang[static_cast<size_t>(cur + 1) * W + h * C + col + e];
          }
      ++cur;
    }
    mbar_wait(&full[s], (it / kDzStages) & 1);
    const unsigned char* buf = smem + s * stage_bytes;
    const bf16* vs = reinterpret_cast<const bf16*>(buf + (static_cast<size_t>(r) * W * 2 & 15));
    const bf16* gs =
        reinterpret_cast<const bf16*>(buf + vbuf + (static_cast<size_t>(r) * C * 2 & 15));

    // pass 1: y = tanh(sum_h v_h lang_h), and each row's sum y^2, sum g y
    float y[kDzRows][VEC], part[2 * kDzRows];
#pragma unroll
    for (int j = 0; j < kDzRows; ++j) {
      part[2 * j] = 0.f;
      part[2 * j + 1] = 0.f;
      if (j < n && active) {
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          float vv[VEC];
          load_bf<VEC>(vs + j * W + h * C + col, vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += vv[e] * lng[h][e];
        }
        float gg[VEC];
        load_bf<VEC>(gs + j * C + col, gg);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          y[j][e] = tanhf(acc[e]);
          part[2 * j] += y[j][e] * y[j][e];
          part[2 * j + 1] += gg[e] * y[j][e];
        }
      }
    }
    // the rows' sums: per warp, then over the consumer warps by the same
    // shuffle tree in every warp, so every thread gets the same sums (one
    // barrier per stage; red alternates, so the next stage's writes never
    // meet this stage's reads)
    static_assert(2 * kDzRows == 4, "the sums go four at a time");
    const float mine = warp_sum4_spread(part[0], part[1], part[2], part[3]);
    if (lane % 8 == 0) red[it & 1][warp][lane / 8] = mine;
    named_bar_sync(1, 32 * cw);
    {
      const float4 w4 = lane < cw ? *reinterpret_cast<const float4*>(red[it & 1][lane])
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      const float all = warp_sum4_spread(w4.x, w4.y, w4.z, w4.w);
#pragma unroll
      for (int k = 0; k < 4; ++k) part[k] = __shfl_sync(0xffffffffu, all, 8 * k);
    }

    // pass 2: dacc, dz and the dlang / db sums
#pragma unroll
    for (int j = 0; j < kDzRows; ++j) {
      if (j >= n || !active) continue;
      const float sq = part[2 * j];
      float gy = part[2 * j + 1];
      const float rn = rsqrtf(fmaxf(sq, kNormEps));
      gy *= rn;   // sum g * out, out = y * rn
      const bool normed = sq > kNormEps;
      float gg[VEC], dacc[VEC];
      load_bf<VEC>(gs + j * C + col, gg);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float out = y[j][e] * rn;
        const float dy = normed ? (gg[e] - out * gy) * rn : gg[e] * rn;
        dacc[e] = dy * (1.f - y[j][e] * y[j][e]);
      }
      bf16* dzrow = dz + static_cast<size_t>(r + j) * W + col;
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
        float vv[VEC], d[VEC];
        load_bf<VEC>(vs + j * W + h * C + col, vv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          d[e] = dacc[e] * lng[h][e] * (1.f - vv[e] * vv[e]);
          dl[h][e] += dacc[e] * vv[e];
          db[h][e] += d[e];
        }
        store_bf<VEC>(dzrow + h * C, d);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    r += n;
  }
  if (active)
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        part_dl[static_cast<size_t>(b + cur) * W + h * C + col + e] = dl[h][e];
        part_db[static_cast<size_t>(b) * W + h * C + col + e] = db[h][e];
      }
}

// The dz block that holds row r (blocks take rows [b M / grid, (b+1) M / grid)).
__device__ __forceinline__ int dz_block_of(int r, int M, int grid) {
  return static_cast<int>((static_cast<long long>(r + 1) * grid - 1) / M);
}

constexpr int kFinThreads = 256;
constexpr int kFinDlCols = 32;   // a dlang block: 32 columns x 8 lanes
constexpr int kFinDbCols = 8;    // a db block: 8 columns x 32 lanes

// Slot sums in a fixed order.  Blocks [0, tiles * samples) give dlang[y]
// for 32 columns (tiles = ceil(W / 32)): the slots b + y of the dz blocks
// b that hold sample y's rows; the blocks after them give db for 8
// columns: slot b of every dz block.  Lane q of a column sums the slots q,
// q + lanes, ... in order (their loads issued eight at a time), then lane
// 0 adds the lanes' sums in order.
__global__ void __launch_bounds__(kFinThreads)
mutan_dz_finalize_kernel(const float* __restrict__ part_dl, const float* __restrict__ part_db,
                         float* __restrict__ dlang, float* __restrict__ db, int W, int M,
                         int N, int grid, int samples) {
  __shared__ float red[kFinThreads];
  const int tiles = (W + kFinDlCols - 1) / kFinDlCols;
  const bool dl_block = blockIdx.x < tiles * samples;
  const int cols = dl_block ? kFinDlCols : kFinDbCols;
  const int lanes = kFinThreads / cols;
  const int c = threadIdx.x % cols, q = threadIdx.x / cols;
  int j, lo, hi;
  const float* part;
  float* out;
  if (dl_block) {
    const int y = blockIdx.x / tiles;
    j = (blockIdx.x % tiles) * kFinDlCols + c;
    lo = dz_block_of(y * N, M, grid) + y;
    hi = dz_block_of((y + 1) * N - 1, M, grid) + y;
    part = part_dl;
    out = dlang + static_cast<size_t>(y) * W;
  } else {
    j = (blockIdx.x - tiles * samples) * kFinDbCols + c;
    lo = 0;
    hi = grid - 1;
    part = part_db;
    out = db;
  }
  float s = 0.f;
  if (j < W)
#pragma unroll 8
    for (int k = lo + q; k <= hi; k += lanes) s += part[static_cast<size_t>(k) * W + j];
  red[threadIdx.x] = s;
  __syncthreads();
  if (q == 0 && j < W) {
    float t = 0.f;
    for (int i = 0; i < lanes; ++i) t += red[i * cols + c];
    out[j] = t;
  }
}

// The finalize over the slots of `grid` dz blocks (part_dl [grid + M / N -
// 1, W], part_db [grid, W]) into dlang [M / N, W] and db [W].
inline cudaError_t launch_dz_finalize(const float* part_dl, const float* part_db, void* dlang,
                                      void* db, int W, int M, int N, int grid,
                                      cudaStream_t s) {
  const int blocks = (W + kFinDlCols - 1) / kFinDlCols * (M / N) +
                     (W + kFinDbCols - 1) / kFinDbCols;
  mutan_dz_finalize_kernel<<<blocks, kFinThreads, 0, s>>>(
      part_dl, part_db, static_cast<float*>(dlang), static_cast<float*>(db), W, M, N, grid,
      M / N);
  return cudaGetLastError();
}

using DzKernel = void (*)(const bf16*, const float*, const bf16*, bf16*, float*, float*, int,
                          int, int, int, int);

template <int HEADS, int VEC>
DzKernel dz_kernel_if_fits() {
  if constexpr (HEADS * VEC <= kDzMaxVals)
    return mutan_dz_kernel<HEADS, VEC>;
  else
    return nullptr;
}

template <int HEADS>
DzKernel dz_kernel_for(int vec) {
  return vec == 8 ? dz_kernel_if_fits<HEADS, 8>()
                  : vec == 4 ? dz_kernel_if_fits<HEADS, 4>() : dz_kernel_if_fits<HEADS, 2>();
}

// The vector (2, 4 or 8 bf16) that divides C: the narrowest that keeps a
// row within 32 kDzMaxWarps threads, so the most warps share the work, and
// within kDzMaxVals accumulators a thread; 0 if none does.
inline int dz_vec(int C, int heads) {
  for (int vec = 2; vec <= 8; vec *= 2)
    if (C % vec == 0 && C / vec <= 32 * kDzMaxWarps && heads * vec <= kDzMaxVals) return vec;
  return 0;
}

struct DzPlan {
  DzKernel kernel;
  int threads, vbuf, gbuf, smem, grid;
};

// The kernel, block, shared memory and grid for M rows, or kernel = null
// where the shape is not supported (heads > 8, odd C, C / VEC above
// 32 kDzMaxWarps, or the ring above the shared memory of a block).
inline DzPlan dz_plan(int M, int C, int heads) {
  DzPlan p{nullptr, 0, 0, 0, 0, 0};
  if (C % 2 || heads < 1 || heads > 8 || M < 1) return p;
  const int vec = dz_vec(C, heads);
  if (vec == 0) return p;
  const int warps = (C / vec + 31) / 32;
  DzKernel k = nullptr;
  switch (heads) {
    case 1: k = dz_kernel_for<1>(vec); break;
    case 2: k = dz_kernel_for<2>(vec); break;
    case 3: k = dz_kernel_for<3>(vec); break;
    case 4: k = dz_kernel_for<4>(vec); break;
    case 5: k = dz_kernel_for<5>(vec); break;
    case 6: k = dz_kernel_for<6>(vec); break;
    case 7: k = dz_kernel_for<7>(vec); break;
    default: k = dz_kernel_for<8>(vec); break;
  }
  if (k == nullptr) return p;
  p.threads = 32 * (warps + 1);
  p.vbuf = dz_buf_bytes(kDzRows * heads * C);
  p.gbuf = dz_buf_bytes(kDzRows * C);
  p.smem = kDzStages * (p.vbuf + p.gbuf);
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      p.smem > smem_max ||
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, p.threads, p.smem) !=
          cudaSuccess ||
      per_sm < 1)
    return p;
  p.grid = std::min(M, sms);   // one block per SM
  p.kernel = k;
  return p;
}

// ---------------------------------------------------------------------------
// dW product
// ---------------------------------------------------------------------------

constexpr int kDwBM = 128;                 // rows of dW (x's columns) per block
constexpr int kDwBN = 256;                 // columns of dW per block
constexpr int kDwSplits = 2;               // parts of the reduction over M, at most
constexpr int kDwStages = 4;
constexpr int kDwThreads = 2 * 128 + 32;   // two consumer warpgroups, one producer warp
constexpr int kDwChunkBytes = kTileK * kSwizzleBytes;   // [64 rows][64 bf16]
constexpr int kDwABytes = (kDwBM / kChunk) * kDwChunkBytes;   // x [64][128]
constexpr int kDwBBytes = (kDwBN / kChunk) * kDwChunkBytes;   // dz [64][256]
constexpr int kDwStageBytes = kDwABytes + kDwBBytes;
constexpr int kDwSmem = 1024 + kDwStages * kDwStageBytes;

// blockIdx.x: the dW row tile (fastest, so the blocks that read the same dz
// columns run together), y: the column tile, z: the split of the rows of x
// and dz, which writes its own [K, W] slice of `out`.  2 x 2 clusters: the
// blocks of a cluster column share x's columns, those of a cluster row dz's.
// The grid may be padded to whole clusters; a padded block loads and
// computes like the others (its tiles read zero) and stores nothing.
__global__ void __cluster_dims__(kClusterX, kClusterY, 1) __launch_bounds__(kDwThreads, 1)
mutan_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap dz_map, float* __restrict__ out,
                int M, int K, int W, int rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kDwStages], empty[kDwStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int k0 = blockIdx.x * kDwBM, c0 = blockIdx.y * kDwBN;
  const int m0 = blockIdx.z * rows_per_split;
  const int tiles = (min(M - m0, rows_per_split) + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kClusterSize);
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (warp == 8) {
    // producer: one thread issues this block's share of every stage: the x
    // boxes j = cy (mod 2) to its cluster column, the dz boxes j = cx
    // (mod 2) to its cluster row
    if (lane == 0) {
      const int cx = cluster_x(), cy = cluster_y();
      const uint16_t x_mask = cluster_col_mask(cx);
      const uint16_t z_mask = cluster_row_mask(cy);
      tma_prefetch(&x_map);
      tma_prefetch(&dz_map);
      for (int it = 0; it < tiles + kDwStages; ++it) {
        const int s = it % kDwStages;
        mbar_wait(&empty[s], ((it / kDwStages) & 1) ^ 1);
        if (it >= tiles) continue;   // the tail: wait until every stage is released
        unsigned char* a = smem + s * kDwStageBytes;
        const int m = m0 + it * kTileK;
        mbar_arrive_expect_tx(&full[s], kDwStageBytes);
#pragma unroll
        for (int j = cy; j < kDwBM / kChunk; j += kClusterY)
          tma_load_2d_mc(a + j * kDwChunkBytes, &x_map, &full[s], k0 + j * kChunk, m,
                         x_mask);
#pragma unroll
        for (int j = cx; j < kDwBN / kChunk; j += kClusterX)
          tma_load_2d_mc(a + kDwABytes + j * kDwChunkBytes, &dz_map, &full[s],
                         c0 + j * kChunk, m, z_mask);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns dW rows k0 + 64 wg ... + 63
  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const uint32_t base = smem_u32(smem);
  constexpr uint32_t kStep = (16 * kSwizzleBytes) >> 4;   // 16 rows of M
  float acc[kDwBN / 2];
  int s = 0;
  for (int it = 0; it < tiles; ++it) {
    s = it % kDwStages;
    mbar_wait(&full[s], (it / kDwStages) & 1);
    const uint32_t a = base + s * kDwStageBytes + wg * kDwChunkBytes;
    const uint32_t b = base + s * kDwStageBytes + kDwABytes;
    wgmma_fence();
    mma_stage<kDwBN, 1, 1>(acc, sw128_desc(a, kDwChunkBytes, 1024),
                           sw128_desc(b, kDwChunkBytes, 1024), kStep, kStep, it == 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0)
      release_stage_cluster(&empty[(it + kDwStages - 1) % kDwStages], wtid);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release_stage_cluster(&empty[s], wtid);

  // row k0 + 64 wg + r of this split's slice, r = 16 wl + lane / 4 (+ 8)
  float* slice = out + static_cast<size_t>(blockIdx.z) * K * W;
  const int r = k0 + wg * 64 + wl * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kDwBN / 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane % 4);
    if (col >= W) continue;
    if (r < K)
      *reinterpret_cast<float2*>(slice + static_cast<size_t>(r) * W + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < K)
      *reinterpret_cast<float2*>(slice + static_cast<size_t>(r + 8) * W + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dw = sum of the splits' partials in split order (n a multiple of 4).
__global__ void mutan_dw_sum_kernel(const float4* __restrict__ part,
                                    float4* __restrict__ dw, size_t n4, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 acc = part[i];
    for (int z = 1; z < splits; ++z) {
      const float4 p = part[z * n4 + i];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    dw[i] = acc;
  }
}

}  // namespace cmpc

// Blocks of the dz pass for M rows of heads * C columns (the grid sized to
// the card), or 0 where the kernel does not take the shape.  Its scratch
// `part` is [2 grid + M / N - 1, heads * C] f32: the dlang slots, then the
// db slots.
extern "C" int cmpc_mutan_dz_blocks(int M, int C, int heads) {
  return cmpc::dz_plan(M, C, heads).grid;
}

// v [M, heads*C] bf16, lang [M/N, heads*C] f32, g [M, C] bf16 ->
// dz [M, heads*C] bf16, dlang [M/N, heads*C] f32, db [heads*C] f32.  part is
// scratch (see cmpc_mutan_dz_blocks).  v, g and dz 16-byte aligned.
extern "C" int cmpc_mutan_bwd_dz(const void* v, const void* lang, const void* g,
                                 void* dz, void* part, void* dlang, void* db,
                                 int M, int C, int N, int heads, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DzPlan p = dz_plan(M, C, heads);
  if (p.kernel == nullptr || M % N) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dz)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int W = heads * C;
  float* part_dl = static_cast<float*>(part);
  float* part_db = part_dl + static_cast<size_t>(p.grid + M / N - 1) * W;
  p.kernel<<<p.grid, p.threads, p.smem, s>>>(
      static_cast<const bf16*>(v), static_cast<const float*>(lang),
      static_cast<const bf16*>(g), static_cast<bf16*>(dz), part_dl, part_db, M, C, N,
      p.vbuf, p.gbuf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dz_finalize(part_dl, part_db, dlang, db, W, M, N, p.grid, s));
}

// The splits of the dW reduction over M that `cmpc_mutan_dw` runs: each
// takes the same whole number of 64-row tiles of M, so a small M has fewer
// than kDwSplits.
extern "C" int cmpc_mutan_dw_splits(int M) {
  const int tiles = (M + cmpc::kTileK - 1) / cmpc::kTileK;
  const int splits = cmpc::kDwSplits > tiles ? tiles : cmpc::kDwSplits;
  const int per_split = (tiles + splits - 1) / splits;
  return (tiles + per_split - 1) / per_split;
}

// x [M, K] bf16, dz [M, W] bf16 -> dw [K, W] f32 = x^T @ dz.  x and dz
// 16-byte aligned, K and W multiples of 8 (TMA strides).  With more than
// one split (cmpc_mutan_dw_splits(M)), part is scratch [splits, K, W] f32;
// else it is unused.
extern "C" int cmpc_mutan_dw(const void* x, const void* dz, void* dw, void* part, int M,
                             int K, int W, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = cmpc_mutan_dw_splits(M);
  const int rows_per_split = ((M + kTileK - 1) / kTileK + splits - 1) / splits * kTileK;
  const uint64_t bf = sizeof(bf16);
  const uint32_t box[2] = {kChunk, kTileK};
  CUtensorMap x_map, dz_map;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t x_strides[1] = {K * bf};
  int rc = encode_tmap(&x_map, x, 2, x_dims, x_strides, box);
  if (rc) return rc;
  const uint64_t z_dims[2] = {static_cast<uint64_t>(W), static_cast<uint64_t>(M)};
  const uint64_t z_strides[1] = {W * bf};
  rc = encode_tmap(&dz_map, dz, 2, z_dims, z_strides, box);
  if (rc) return rc;
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  cudaError_t err = cudaFuncSetAttribute(
      mutan_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // padded to whole clusters
  const dim3 grid(((K + kDwBM - 1) / kDwBM + kClusterX - 1) / kClusterX * kClusterX,
                  ((W + kDwBN - 1) / kDwBN + kClusterY - 1) / kClusterY * kClusterY,
                  splits);
  mutan_dw_kernel<<<grid, kDwThreads, kDwSmem, s>>>(x_map, dz_map, out, M, K, W,
                                                    rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(K) * W / 4;
  mutan_dw_sum_kernel<<<264, 256, 0, s>>>(static_cast<const float4*>(part),
                                         static_cast<float4*>(dw), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The dz pass's wide form, for the shapes dz_plan refuses (C / VEC past 32
// kDzMaxWarps, or the ring past shared memory): any heads <= 8 and even C.
// No TPU kernel of its own: the Pallas kernel's block spans the whole row
// at any C.  The row norm and gy are the only reductions over a row, two
// scalars, so they are carried in device memory.  Three launches:
//  1. dz_wide_scalars_kernel, a warp per row (8 rows a block): each lane
//     takes VEC adjacent columns of every head at a time (16-, 8- or
//     4-byte loads), y = tanh(sum_h v_h lang_h), and the warp sums sq =
//     sum y^2 and sum g y; it stores r = rsqrt(max(sq, 1e-12)) and gy = r *
//     sum g y (0 where sq <= 1e-12, so that dy = g * r there);
//  2. dz_wide_stream_kernel, the column stream: thread t owns VEC adjacent
//     columns of every head (VEC the widest of 8, 4, 2 that divides C with
//     heads * VEC <= kDzMaxVals accumulators) in one of `ranges` contiguous
//     row ranges [b M / ranges, (b + 1) M / ranges), which may cross
//     samples; each thread keeps kDzWideDepth of its rows' v, g and (r,
//     gy) in flight by cp.async into its own slots of a shared-memory ring
//     (one copy group a row, no barrier: only the thread reads its slots),
//     so the bytes in flight do not cost registers; it writes dz_h with
//     VEC-wide stores and keeps its dlang / db sums in registers (its lang
//     slice waits in shared memory), written to the main kernel's slots:
//     dlang at b + sample, db at b.  `ranges` fills the card: as many
//     threads as one wave of blocks holds;
//  3. mutan_dz_finalize_kernel, the main kernel's fixed-order slot sums.
// The scratch (cmpc_mutan_dz_wide_ranges) is the main kernel's slot layout
// for `ranges` blocks, then (r, gy) per row.  Bound on the card: bytes (v
// and g read twice, dz written once).
// ---------------------------------------------------------------------------
namespace cmpc {

constexpr int kDzWideRowWarps = 8;      // rows per block of the scalars pass
constexpr int kDzWideThreads = 128;     // threads per block of the stream
constexpr int kDzWideMinBlocks = 2;     // stream blocks per SM: a 255-register cap
constexpr int kDzWideDepth = 4;         // rows of a stream thread in flight (cp.async)

// VEC f32 from p (aligned to 4 VEC bytes, or 16 where VEC = 8).
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x;
    out[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = a.x;
      out[4 * q + 1] = a.y;
      out[4 * q + 2] = a.z;
      out[4 * q + 3] = a.w;
    }
  }
}

template <int HEADS, int VEC>
__global__ void __launch_bounds__(32 * kDzWideRowWarps)
dz_wide_scalars_kernel(const bf16* __restrict__ v, const float* __restrict__ lang,
                       const bf16* __restrict__ g, float* __restrict__ rs, int M, int C,
                       int N) {
  const int row = blockIdx.x * kDzWideRowWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const int W = HEADS * C;
  const bf16* vr = v + static_cast<size_t>(row) * W;
  const float* l = lang + static_cast<size_t>(row / N) * W;
  const bf16* gr = g + static_cast<size_t>(row) * C;
  float sq = 0.f, gty = 0.f;
#pragma unroll 2
  for (int c = VEC * lane; c < C; c += 32 * VEC) {
    BfBitsT<VEC> vb[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) vb[h] = *reinterpret_cast<const BfBitsT<VEC>*>(vr + h * C + c);
    const BfBitsT<VEC> gb = *reinterpret_cast<const BfBitsT<VEC>*>(gr + c);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      float vv[VEC], ll[VEC];
      unpack_bf<VEC>(vb[h], vv);
      load_f32<VEC>(l + h * C + c, ll);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += vv[e] * ll[e];
    }
    float gg[VEC];
    unpack_bf<VEC>(gb, gg);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float y = tanhf(acc[e]);
      sq += y * y;
      gty += gg[e] * y;
    }
  }
  sq = warp_sum(sq);
  gty = warp_sum(gty);
  if (lane == 0) {
    const float r = rsqrtf(fmaxf(sq, kNormEps));
    *reinterpret_cast<float2*>(rs + 2 * static_cast<size_t>(row)) =
        make_float2(r, sq > kNormEps ? gty * r : 0.f);
  }
}

// A copy of BYTES (4, 8 or 16) from global `src` to shared `dst` by
// cp.async; the 16-byte copies bypass L1 (v and g are read once here).
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES) : "memory");
}

// Dynamic shared memory of the stream: each thread's lang slice
// [HEADS * VEC / 2] float pairs, then its ring of kDzWideDepth rows
// ([HEADS + 1] vectors of VEC bf16: v's heads, then g) and their (r, gy);
// every entry kDzWideThreads apart, so neighbouring threads touch
// neighbouring addresses.
template <int HEADS, int VEC>
constexpr int dz_wide_smem() {
  return kDzWideThreads *
         (HEADS * VEC / 2 * 8 + kDzWideDepth * ((HEADS + 1) * 2 * VEC + 8));
}

template <int HEADS, int VEC>
__global__ void __launch_bounds__(kDzWideThreads, kDzWideMinBlocks)
dz_wide_stream_kernel(const bf16* __restrict__ v, const float* __restrict__ lang,
                      const bf16* __restrict__ g, const float* __restrict__ rs,
                      bf16* __restrict__ dz, float* __restrict__ part_dl,
                      float* __restrict__ part_db, int M, int C, int N, int ranges) {
  using Bits = BfBitsT<VEC>;
  constexpr int T = kDzWideThreads, D = kDzWideDepth;
  extern __shared__ __align__(16) unsigned char dz_wide_smem_raw[];
  float2* lsm = reinterpret_cast<float2*>(dz_wide_smem_raw);               // [HEADS VEC / 2][T]
  Bits* ring = reinterpret_cast<Bits*>(lsm + HEADS * VEC / 2 * T);         // [D][HEADS + 1][T]
  float2* rgs = reinterpret_cast<float2*>(ring + D * (HEADS + 1) * T);     // [D][T]
  const int tid = threadIdx.x;
  const int cols = C / VEC;
  const long long t = static_cast<long long>(blockIdx.x) * T + tid;
  if (t >= static_cast<long long>(cols) * ranges) return;
  const int b = static_cast<int>(t / cols), col = static_cast<int>(t % cols) * VEC;
  const int row0 = static_cast<int>(static_cast<long long>(b) * M / ranges);
  const int row1 = static_cast<int>(static_cast<long long>(b + 1) * M / ranges);
  const int W = HEADS * C;
  float dl[HEADS][VEC], db[HEADS][VEC];
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dl[h][e] = db[h][e] = 0.f;
  int cur = row0 / N;   // the sample of dl and of the lang slice
  auto stage_lang = [&](int s) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      float ll[VEC];
      load_f32<VEC>(lang + static_cast<size_t>(s) * W + h * C + col, ll);
#pragma unroll
      for (int q = 0; q < VEC / 2; ++q)
        lsm[(h * VEC / 2 + q) * T + tid] = make_float2(ll[2 * q], ll[2 * q + 1]);
    }
  };
  auto lang_of = [&](int h, float (&ll)[VEC]) {
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      const float2 a = lsm[(h * VEC / 2 + q) * T + tid];
      ll[2 * q] = a.x;
      ll[2 * q + 1] = a.y;
    }
  };
  // row r's copies into ring slot q: one cp.async group a row
  auto fetch = [&](int r, int q) {
    const bf16* vr = v + static_cast<size_t>(r) * W + col;
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
      cp_async_bytes<2 * VEC>(&ring[(q * (HEADS + 1) + h) * T + tid], vr + h * C);
    cp_async_bytes<2 * VEC>(&ring[(q * (HEADS + 1) + HEADS) * T + tid],
                            g + static_cast<size_t>(r) * C + col);
    cp_async_bytes<8>(&rgs[q * T + tid], rs + 2 * static_cast<size_t>(r));
  };
  stage_lang(cur);
#pragma unroll
  for (int i = 0; i < D - 1; ++i) {
    if (row0 + i < row1) fetch(row0 + i, i);
    cp_async_commit();   // an empty group past the range keeps the count
  }

  for (int r = row0, q = 0; r < row1; ++r, q = q + 1 == D ? 0 : q + 1) {
    // row r + D - 1 into the slot row r - 1 freed, then wait for row r
    if (r + D - 1 < row1) fetch(r + D - 1, q == 0 ? D - 1 : q - 1);
    cp_async_commit();
    cp_async_wait<D - 1>();
    if (r / N != cur) {
      // a new sample: this range's dlang sums of the last one go to its slot
#pragma unroll
      for (int h = 0; h < HEADS; ++h)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          part_dl[static_cast<size_t>(b + cur) * W + h * C + col + e] = dl[h][e];
          dl[h][e] = 0.f;
        }
      stage_lang(++cur);
    }
    Bits xv[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) xv[h] = ring[(q * (HEADS + 1) + h) * T + tid];
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      float vv[VEC], ll[VEC];
      unpack_bf<VEC>(xv[h], vv);
      lang_of(h, ll);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += vv[e] * ll[e];
    }
    float gg[VEC], dacc[VEC];
    unpack_bf<VEC>(ring[(q * (HEADS + 1) + HEADS) * T + tid], gg);
    const float2 rg = rgs[q * T + tid];
    const float rn = rg.x, gy = rg.y;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float y = tanhf(acc[e]);
      const float dy = (gg[e] - y * rn * gy) * rn;
      dacc[e] = dy * (1.f - y * y);
    }
    bf16* dzrow = dz + static_cast<size_t>(r) * W + col;
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      float vv[VEC], ll[VEC], d[VEC];
      unpack_bf<VEC>(xv[h], vv);
      lang_of(h, ll);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        d[e] = dacc[e] * ll[e] * (1.f - vv[e] * vv[e]);
        dl[h][e] += dacc[e] * vv[e];
        db[h][e] += d[e];
      }
      store_bf<VEC>(dzrow + h * C, d);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      part_dl[static_cast<size_t>(b + cur) * W + h * C + col + e] = dl[h][e];
      part_db[static_cast<size_t>(b) * W + h * C + col + e] = db[h][e];
    }
}

using DzWideScalarsKernel = void (*)(const bf16*, const float*, const bf16*, float*, int, int,
                                     int);
using DzWideStreamKernel = void (*)(const bf16*, const float*, const bf16*, const float*,
                                    bf16*, float*, float*, int, int, int, int);

struct DzWidePlan {
  DzWideScalarsKernel scalars;
  DzWideStreamKernel stream;
  int vec, smem, ranges;
};

template <int HEADS, int VEC>
void dz_wide_kernels_if_fit(DzWidePlan& p) {
  if constexpr (HEADS * VEC <= kDzMaxVals) {
    p.scalars = dz_wide_scalars_kernel<HEADS, VEC>;
    p.stream = dz_wide_stream_kernel<HEADS, VEC>;
    p.smem = dz_wide_smem<HEADS, VEC>();
  }
}

template <int HEADS>
void dz_wide_kernels_for(DzWidePlan& p) {
  if (p.vec == 8)
    dz_wide_kernels_if_fit<HEADS, 8>(p);
  else if (p.vec == 4)
    dz_wide_kernels_if_fit<HEADS, 4>(p);
  else
    dz_wide_kernels_if_fit<HEADS, 2>(p);
}

// The kernels, vector and row ranges for M rows of heads * C columns, or
// ranges = 0 where the shape is not supported (heads outside 1..8, odd C).
// The ranges give as many stream threads as one wave of blocks holds
// on the card, at least one row each.
inline DzWidePlan dz_wide_plan(int M, int C, int heads) {
  DzWidePlan p{nullptr, nullptr, 0, 0, 0};
  if (C < 2 || C % 2 || heads < 1 || heads > 8 || M < 1) return p;
  for (int vec = 8; vec >= 2 && p.vec == 0; vec /= 2)
    if (C % vec == 0 && heads * vec <= kDzMaxVals) p.vec = vec;
  switch (heads) {
    case 1: dz_wide_kernels_for<1>(p); break;
    case 2: dz_wide_kernels_for<2>(p); break;
    case 3: dz_wide_kernels_for<3>(p); break;
    case 4: dz_wide_kernels_for<4>(p); break;
    case 5: dz_wide_kernels_for<5>(p); break;
    case 6: dz_wide_kernels_for<6>(p); break;
    case 7: dz_wide_kernels_for<7>(p); break;
    default: dz_wide_kernels_for<8>(p); break;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (p.stream == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(p.stream, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.stream, kDzWideThreads, p.smem) !=
          cudaSuccess ||
      per_sm < 1)
    return p;
  const long long threads = static_cast<long long>(sms) * per_sm * kDzWideThreads;
  const long long ranges = threads / (C / p.vec);
  p.ranges = static_cast<int>(ranges < 1 ? 1 : ranges > M ? M : ranges);
  return p;
}

}  // namespace cmpc

// The row ranges of the wide dz pass for M rows of heads * C columns (0
// where it does not take the shape).  Its scratch `part` is [2 ranges +
// M / N - 1 + ceil(2 M / (heads C)), heads * C] f32: the main kernel's
// dlang and db slots for `ranges` blocks, then (r, gy) per row.
extern "C" int cmpc_mutan_dz_wide_ranges(int M, int C, int heads) {
  return cmpc::dz_wide_plan(M, C, heads).ranges;
}

// The contract of cmpc_mutan_bwd_dz for any heads <= 8 and even C, with
// `part` the scratch above; v, g, dz and lang 16-byte aligned.
extern "C" int cmpc_mutan_bwd_dz_wide(const void* v, const void* lang, const void* g,
                                      void* dz, void* part, void* dlang, void* db, int M,
                                      int C, int N, int heads, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DzWidePlan p = dz_wide_plan(M, C, heads);
  if (p.ranges < 1 || N < 1 || M % N) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(v) || !aligned16(g) || !aligned16(dz) || !aligned16(lang))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int B = M / N, W = heads * C;
  float* part_dl = static_cast<float*>(part);
  float* part_db = part_dl + static_cast<size_t>(p.ranges + B - 1) * W;
  float* rs = part_db + static_cast<size_t>(p.ranges) * W;
  p.scalars<<<(M + kDzWideRowWarps - 1) / kDzWideRowWarps, 32 * kDzWideRowWarps, 0, s>>>(
      static_cast<const bf16*>(v), static_cast<const float*>(lang),
      static_cast<const bf16*>(g), rs, M, C, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = static_cast<long long>(C / p.vec) * p.ranges;
  p.stream<<<static_cast<int>((threads + kDzWideThreads - 1) / kDzWideThreads), kDzWideThreads,
             p.smem, s>>>(static_cast<const bf16*>(v), static_cast<const float*>(lang),
                          static_cast<const bf16*>(g), rs, static_cast<bf16*>(dz), part_dl,
                          part_db, M, C, N, p.ranges);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_dz_finalize(part_dl, part_db, dlang, db, W, M, N, p.ranges, s));
}
