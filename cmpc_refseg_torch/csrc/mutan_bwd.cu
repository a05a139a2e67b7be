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
//    Bound on the card: bytes (v in, dz out, 2 x 128 MB at the flagship's
//    bs=8 train step).  Design: the row norm needs whole rows, so a block
//    owns a few rows x all heads*C columns (as se_sum.cu owns whole rows);
//    each thread owns the same column pairs in every row (bf16x2 loads and
//    stores), so its dlang / db accumulators live in shared memory with no
//    barrier and no atomics.  The rows of a block divide the rows per
//    sample, so they never straddle two samples (the TPU kernel's _pick_tm
//    guards the same).  Each block writes its column sums to its own slot;
//    a second small pass adds the slots in a fixed order (per sample for
//    dlang, over all blocks for db), so the result is deterministic.
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
#include "common.cuh"
#include "hopper.cuh"

namespace cmpc {

// ---------------------------------------------------------------------------
// dz pass
// ---------------------------------------------------------------------------

constexpr int kDzThreads = 256;
constexpr int kDzMaxRows = 32;        // rows per block, at most
constexpr float kNormEps = 1e-12f;

__device__ __forceinline__ float2 load_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared memory: dl, db [W] f32 accumulators, lang row [W] f32, then y and
// g [C] f32 of the current row (W = heads * C).
__global__ void __launch_bounds__(kDzThreads)
mutan_dz_kernel(const bf16* __restrict__ v, const float* __restrict__ lang,
                const bf16* __restrict__ g, bf16* __restrict__ dz,
                float* __restrict__ part_dl, float* __restrict__ part_db, int C,
                int heads, int N, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[kDzThreads / 32];
  const int W = heads * C;
  float* dl = reinterpret_cast<float*>(smem);
  float* db = dl + W;
  float* ls = db + W;
  float* ys = ls + W;
  float* gs = ys + C;
  const int row0 = blockIdx.x * rows_per_block;
  const float* lrow = lang + static_cast<size_t>(row0 / N) * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    dl[j] = 0.f;
    db[j] = 0.f;
    ls[j] = lrow[j];
  }
  __syncthreads();

  const int pairs = C / 2;
  for (int r = 0; r < rows_per_block; ++r) {
    const size_t row = static_cast<size_t>(row0 + r);
    const bf16* vrow = v + row * W;
    // pass 1: y = tanh(sum_h v_h lang_h), sum y^2 and sum g y
    float sq = 0.f, gy = 0.f;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int c = 2 * p;
      float2 acc = make_float2(0.f, 0.f);
      for (int h = 0; h < heads; ++h) {
        const float2 vv = load_bf2(vrow + h * C + c);
        acc.x += vv.x * ls[h * C + c];
        acc.y += vv.y * ls[h * C + c + 1];
      }
      const float2 y = make_float2(tanhf(acc.x), tanhf(acc.y));
      const float2 gg = load_bf2(g + row * C + c);
      ys[c] = y.x;
      ys[c + 1] = y.y;
      gs[c] = gg.x;
      gs[c + 1] = gg.y;
      sq += y.x * y.x + y.y * y.y;
      gy += gg.x * y.x + gg.y * y.y;
    }
    sq = block_sum(sq, scratch);
    gy = block_sum(gy, scratch);
    const float rn = rsqrtf(fmaxf(sq, kNormEps));
    gy *= rn;   // sum g * out, out = y * rn
    const bool normed = sq > kNormEps;
    // pass 2: dacc, dz and this block's dlang / db column sums
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int c = 2 * p;
      float dacc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float y = ys[c + i], gg = gs[c + i];
        const float out = y * rn;
        const float dy = normed ? (gg - out * gy) * rn : gg * rn;
        dacc[i] = dy * (1.f - y * y);
      }
      for (int h = 0; h < heads; ++h) {
        const int j = h * C + c;
        const float2 vv = load_bf2(vrow + j);
        const float dz0 = dacc[0] * ls[j] * (1.f - vv.x * vv.x);
        const float dz1 = dacc[1] * ls[j + 1] * (1.f - vv.y * vv.y);
        *reinterpret_cast<__nv_bfloat162*>(dz + row * W + j) =
            __floats2bfloat162_rn(dz0, dz1);
        dl[j] += dacc[0] * vv.x;
        dl[j + 1] += dacc[1] * vv.y;
        db[j] += dz0;
        db[j + 1] += dz1;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    part_dl[static_cast<size_t>(blockIdx.x) * W + j] = dl[j];
    part_db[static_cast<size_t>(blockIdx.x) * W + j] = db[j];
  }
}

// Slot sums in a fixed order: y < samples gives dlang[y], y == samples db.
__global__ void mutan_dz_finalize_kernel(const float* __restrict__ part_dl,
                                         const float* __restrict__ part_db,
                                         float* __restrict__ dlang,
                                         float* __restrict__ db, int W,
                                         int blocks_per_sample, int samples) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const int b = blockIdx.y;
  float s = 0.f;
  if (b < samples) {
    for (int k = 0; k < blocks_per_sample; ++k)
      s += part_dl[static_cast<size_t>(b * blocks_per_sample + k) * W + j];
    dlang[static_cast<size_t>(b) * W + j] = s;
  } else {
    for (int k = 0; k < samples * blocks_per_sample; ++k)
      s += part_db[static_cast<size_t>(k) * W + j];
    db[j] = s;
  }
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

// Rows per block of the dz pass: the largest divisor of N (rows per sample)
// up to kDzMaxRows, so a block never straddles two samples.
extern "C" int cmpc_mutan_dz_rows_per_block(int N) {
  for (int r = cmpc::kDzMaxRows; r > 1; --r)
    if (N % r == 0) return r;
  return 1;
}

// v [M, heads*C] bf16, lang [M/N, heads*C] f32, g [M, C] bf16 ->
// dz [M, heads*C] bf16, dlang [M/N, heads*C] f32, db [heads*C] f32.  part is
// scratch [2, M / rows_per_block, heads*C] f32.  C must be even.
extern "C" int cmpc_mutan_bwd_dz(const void* v, const void* lang, const void* g,
                                 void* dz, void* part, void* dlang, void* db,
                                 int M, int C, int N, int heads, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = heads * C;
  const int rpb = cmpc_mutan_dz_rows_per_block(N);
  const int blocks = M / rpb;
  const int smem = (3 * W + 2 * C) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mutan_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part_dl = static_cast<float*>(part);
  float* part_db = part_dl + static_cast<size_t>(blocks) * W;
  mutan_dz_kernel<<<blocks, kDzThreads, smem, s>>>(
      static_cast<const bf16*>(v), static_cast<const float*>(lang),
      static_cast<const bf16*>(g), static_cast<bf16*>(dz), part_dl, part_db, C,
      heads, N, rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + 255) / 256, M / N + 1);
  mutan_dz_finalize_kernel<<<grid, 256, 0, s>>>(
      part_dl, part_db, static_cast<float*>(dlang), static_cast<float*>(db), W,
      N / rpb, M / N);
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
