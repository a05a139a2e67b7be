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
  const int fin_blocks = (W + kFinDlCols - 1) / kFinDlCols * (M / N) +
                         (W + kFinDbCols - 1) / kFinDbCols;
  mutan_dz_finalize_kernel<<<fin_blocks, kFinThreads, 0, s>>>(
      part_dl, part_db, static_cast<float*>(dlang), static_cast<float*>(db), W, M, N, p.grid,
      M / N);
  return static_cast<int>(cudaGetLastError());
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
// The dz pass's wide form, for the shapes dz_plan refuses (heads * VEC
// accumulators past a thread's budget, C / VEC past 32 kDzMaxWarps, or the
// ring past shared memory): any heads <= 8 and even C.  No TPU kernel of
// its own: the Pallas kernel's block spans the whole row at any C.  The
// row norm and gy are the only reductions over a row, two scalars, so they
// are carried in device memory:
//  1. a block per row sweeps its C columns: sq = sum y^2 and sum g * y;
//     it stores r = rsqrt(max(sq, 1e-12)) and gy = r * sum g * y (0 where
//     sq <= 1e-12, so that dy = g * r there);
//  2. a thread per column c of every head, a block per (128 columns,
//     sample, share of the sample's rows): it rebuilds y from v and lang,
//     writes dz_h, and keeps its dlang and db sums in registers, which go
//     to per-(sample, share) slots of the scratch;
//  3. a thread per column of heads * C adds the slots in a fixed order:
//     dlang per sample, db over all.
// The scratch ([2 slots + ceil(2 M / (heads C)), heads C] f32,
// `cmpc_mutan_dz_wide_shares`) holds both slot sets, then (r, gy) per row.
// Bound on the card: bytes (v read twice, dz written once).
// ---------------------------------------------------------------------------
namespace cmpc {

constexpr int kDzWideCols = 128;     // columns of a block of pass 2
constexpr int kDzWideTarget = 264;   // pass 2's blocks to aim for: two per SM
constexpr int kDzWideMaxHeads = 8;

__global__ void __launch_bounds__(256)
dz_wide_rows_kernel(const bf16* __restrict__ v, const float* __restrict__ lang,
                    const bf16* __restrict__ g, float* __restrict__ rs, int C, int N,
                    int heads) {
  __shared__ float red[8];
  const int row = blockIdx.x, s = row / N, W = heads * C;
  const bf16* vr = v + static_cast<size_t>(row) * W;
  const float* l = lang + static_cast<size_t>(s) * W;
  const bf16* gr = g + static_cast<size_t>(row) * C;
  float sq = 0.f, gty = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int h = 0; h < heads; ++h) acc += bf2f(vr[h * C + c]) * l[h * C + c];
    const float y = tanhf(acc);
    sq += y * y;
    gty += bf2f(gr[c]) * y;
  }
  sq = block_sum(sq, red);
  gty = block_sum(gty, red);
  if (threadIdx.x == 0) {
    const float r = rsqrtf(fmaxf(sq, 1e-12f));
    rs[2 * static_cast<size_t>(row)] = r;
    rs[2 * static_cast<size_t>(row) + 1] = sq > 1e-12f ? gty * r : 0.f;
  }
}

__global__ void __launch_bounds__(kDzWideCols)
dz_wide_cols_kernel(const bf16* __restrict__ v, const float* __restrict__ lang,
                    const bf16* __restrict__ g, const float* __restrict__ rs,
                    bf16* __restrict__ dz, float* __restrict__ part_dl,
                    float* __restrict__ part_db, int C, int N, int heads, int shares) {
  const int c = blockIdx.x * kDzWideCols + threadIdx.x;
  if (c >= C) return;
  const int s = blockIdx.y / shares, sh = blockIdx.y % shares;
  const int chunk = (N + shares - 1) / shares;
  const int n0 = sh * chunk, n1 = min(N, n0 + chunk);
  const int W = heads * C;
  float l[kDzWideMaxHeads], dl[kDzWideMaxHeads], db[kDzWideMaxHeads];
#pragma unroll
  for (int h = 0; h < kDzWideMaxHeads; ++h) {
    l[h] = h < heads ? lang[static_cast<size_t>(s) * W + h * C + c] : 0.f;
    dl[h] = db[h] = 0.f;
  }
  for (int n = n0; n < n1; ++n) {
    const size_t row = static_cast<size_t>(s) * N + n;
    const float r = rs[2 * row], gy = rs[2 * row + 1];
    float vv[kDzWideMaxHeads];
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < kDzWideMaxHeads; ++h) {
      vv[h] = h < heads ? bf2f(v[row * W + h * C + c]) : 0.f;
      if (h < heads) acc += vv[h] * l[h];
    }
    const float y = tanhf(acc), out = y * r;
    const float dy = (bf2f(g[row * C + c]) - out * gy) * r;
    const float dacc = dy * (1.f - y * y);
#pragma unroll
    for (int h = 0; h < kDzWideMaxHeads; ++h) {
      if (h >= heads) continue;
      const float d = dacc * l[h] * (1.f - vv[h] * vv[h]);
      dz[row * W + h * C + c] = f2bf(d);
      dl[h] += dacc * vv[h];
      db[h] += d;
    }
  }
  const size_t slot = (static_cast<size_t>(s) * shares + sh) * W;
#pragma unroll
  for (int h = 0; h < kDzWideMaxHeads; ++h)
    if (h < heads) {
      part_dl[slot + h * C + c] = dl[h];
      part_db[slot + h * C + c] = db[h];
    }
}

__global__ void __launch_bounds__(256)
dz_wide_finish_kernel(const float* __restrict__ part_dl, const float* __restrict__ part_db,
                      float* __restrict__ dlang, float* __restrict__ db, int W, int B,
                      int shares) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  float tdb = 0.f;
  for (int s = 0; s < B; ++s) {
    float tdl = 0.f;
    for (int sh = 0; sh < shares; ++sh) {
      const size_t slot = (static_cast<size_t>(s) * shares + sh) * W + w;
      tdl += part_dl[slot];
      tdb += part_db[slot];
    }
    dlang[static_cast<size_t>(s) * W + w] = tdl;
  }
  db[w] = tdb;
}

}  // namespace cmpc

// Shares of each sample's N rows that the wide dz pass splits over its
// blocks (M = B * N rows of heads * C columns), so that about
// kDzWideTarget blocks run; its scratch is [2 B shares + ceil(2 M /
// (heads C)), heads C] f32.
extern "C" int cmpc_mutan_dz_wide_shares(int M, int C, int N) {
  using namespace cmpc;
  const long long cols = (C + kDzWideCols - 1) / kDzWideCols;
  const long long blocks = cols * (M / N);
  const long long want = (kDzWideTarget + blocks - 1) / blocks;
  return static_cast<int>(want < 1 ? 1 : want > N ? N : want);
}

// The contract of cmpc_mutan_bwd_dz for any heads <= 8 and even C, with
// `part` the scratch above.
extern "C" int cmpc_mutan_bwd_dz_wide(const void* v, const void* lang, const void* g,
                                      void* dz, void* part, void* dlang, void* db, int M,
                                      int C, int N, int heads, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads < 1 || heads > kDzWideMaxHeads || C < 2 || C % 2 || N < 1 || M < 1 || M % N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int B = M / N, W = heads * C;
  const int shares = cmpc_mutan_dz_wide_shares(M, C, N);
  float* part_dl = static_cast<float*>(part);
  float* part_db = part_dl + static_cast<size_t>(B) * shares * W;
  float* rs = part_db + static_cast<size_t>(B) * shares * W;
  dz_wide_rows_kernel<<<M, 256, 0, s>>>(static_cast<const bf16*>(v),
                                        static_cast<const float*>(lang),
                                        static_cast<const bf16*>(g), rs, C, N, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dz_wide_cols_kernel<<<dim3((C + kDzWideCols - 1) / kDzWideCols, B * shares), kDzWideCols, 0,
                        s>>>(static_cast<const bf16*>(v), static_cast<const float*>(lang),
                             static_cast<const bf16*>(g), rs, static_cast<bf16*>(dz), part_dl,
                             part_db, C, N, heads, shares);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dz_wide_finish_kernel<<<(W + 255) / 256, 256, 0, s>>>(
      part_dl, part_db, static_cast<float*>(dlang), static_cast<float*>(db), W, B, shares);
  return static_cast<int>(cudaGetLastError());
}
