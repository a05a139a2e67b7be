// Mutan bilinear fusion: out = l2norm_row(tanh(sum_h tanh(x @ W_h + b_h) * lang_h))
//
// Replaces cmpc_refseg_tpu/ops/pallas_kernels.py::mutan_fused_padded and
// ::_mutan_fused_fwd (the same function; the port needs no lane padding),
// and, with a residual buffer, ::_mutan_fwd_with_residual: the training
// forward that also writes v = tanh(x @ W + b) [rows, heads*C] in bf16 for
// the backward (csrc/mutan_bwd.cu).  v is rounded once from the f32
// accumulator; out is computed from the f32 v as without it.
//
// Bound on the card: operations.  At the flagship shapes (x [8*1600, 1008],
// W [1008, 5*1000]) the product is 129 GFLOP against ~60 MB of operands.
// Only wgmma reaches Hopper's tensor-core rate, and only if its tiles
// arrive while it works; with 128 x 128 tiles, the tiles each block reads
// from L2 (x once per head and column tile, W once per row tile, ~2 GB at
// bs=8) would take about as long as the product.  Design (csrc/hopper.cuh):
// a block owns [128 rows x 128 columns] of the output and loops over the 5
// heads, each a product over all of K.  A producer warpgroup (one thread
// issues, the rest give their registers to the consumers) keeps a ring of
// TMA stages full (x [128 x 64] K-major, W [64 x 128] N-major, 128-byte
// swizzle, full / empty mbarriers) and runs ahead into the next head while
// the consumers finish one.  Blocks run in 2 x 2 clusters: each loads half
// of the x tile and multicasts it to the block beside it (same rows), and
// half of the W tile to the block below it (same columns), which halves
// the L2 traffic.  Each of two consumer warpgroups owns 64 rows: the head's
// product in 64 f32 registers a thread, then tanh(acc + b_h) * lang_h added
// to a second register accumulator, the head sum, straight from the
// accumulator fragment, so the [rows, 5*C] tanh intermediate never leaves
// the SM.  W is read through a 3D tensor map [K][heads][C], so a tile's
// columns past C read zero instead of the next head's.  The training form
// stages each head's v tile in swizzled shared memory and writes it with a
// TMA store.  The row l2norm needs all C columns, which span 8 blocks: each
// block writes tanh(acc) in f32 plus its per-row sum of squares (a quad
// shuffle), and a second small pass scales and rounds to bf16 (an [rows, C]
// f32 round trip).  The tensor cores idle during each head's epilogue;
// running it in slices between the next head's wgmma issues measured
// slower (PERF.md).  Not done: a persistent schedule, and a cluster
// exchange of the row sums in place of the second pass.
#include "common.cuh"
#include "hopper.cuh"

namespace cmpc {

constexpr int kMutBM = 128;                  // output rows per block
constexpr int kMutBN = 128;                  // output columns per block
constexpr int kMutChunks = kMutBN / kChunk;  // W boxes per stage
constexpr int kChunkBytes = kTileK * kSwizzleBytes;   // [64 rows][64 bf16]
// Two consumer warpgroups of 64 rows, then one producer warpgroup whose
// registers (setmaxnreg) go to the consumers' two accumulators.
constexpr int kMutThreads = 3 * 128;
constexpr int kMutStages = 5;
constexpr int kMutABytes = kMutBM * kSwizzleBytes;          // x [128][64]
constexpr int kMutBBytes = kMutChunks * kChunkBytes;        // W [64][128]
constexpr int kMutStageBytes = kMutABytes + kMutBBytes;
constexpr int kMutVBytes = 2 * kMutChunks * kChunkBytes;    // v staging, per warpgroup
constexpr int kMutSmem = 1024 + kMutStages * kMutStageBytes + kMutVBytes;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void store_bf2(unsigned char* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// blockIdx.x: column tile, y: row tile, in 2 x 2 clusters: the blocks of a
// cluster row share x's rows, those of a cluster column W's columns.  The
// grid may be padded to whole clusters; a padded block loads and computes
// like the others (its tiles read zero) and stores nothing.
// kResidual: also store v.
template <bool kResidual>
__global__ void __cluster_dims__(kClusterX, kClusterY, 1) __launch_bounds__(kMutThreads, 1)
mutan_heads_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const float* __restrict__ bias, const float* __restrict__ lang,
                   float* __restrict__ y, float* __restrict__ rowsq, int M, int K,
                   int C, int N, int heads, int col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMutStages], empty[kMutStages];
  unsigned char* smem = align1024(smem_raw);
  const int ct = blockIdx.x, c0 = ct * kMutBN;
  const int row0 = blockIdx.y * kMutBM;
  const int ktiles = (K + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMutStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kClusterSize);
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (warp >= 8) {
    // producer: one thread issues this block's share of every stage: the
    // 64-row halves j = cx (mod 2) of the x tile to its cluster row, the
    // 64-column halves j = cy (mod 2) of the W tile to its cluster column
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int cx = cluster_x(), cy = cluster_y();
      const uint16_t row_mask = cluster_row_mask(cy);
      const uint16_t col_mask = cluster_col_mask(cx);
      tma_prefetch(&x_map);
      tma_prefetch(&w_map);
      const int iters = heads * ktiles;
      for (int it = 0; it < iters + kMutStages; ++it) {
        const int s = it % kMutStages;
        mbar_wait(&empty[s], ((it / kMutStages) & 1) ^ 1);
        if (it >= iters) continue;   // the tail: wait until every stage is released
        unsigned char* a = smem + s * kMutStageBytes;
        const int h = it / ktiles, k0 = (it % ktiles) * kTileK;
        mbar_arrive_expect_tx(&full[s], kMutStageBytes);
#pragma unroll
        for (int j = cx; j < kMutBM / 64; j += kClusterX)
          tma_load_2d_mc(a + j * kChunkBytes, &x_map, &full[s], k0, row0 + j * 64,
                         row_mask);
#pragma unroll
        for (int j = cy; j < kMutChunks; j += kClusterY)
          tma_load_3d_mc(a + kMutABytes + j * kChunkBytes, &w_map, &full[s],
                         c0 + j * kChunk, h, k0, col_mask);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<232>();
  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const int ldw = heads * C;
  const int r_lo = row0 + wg * 64 + wl * 16 + lane / 4;   // and r_lo + 8
  const int col_t = 2 * (lane % 4);                      // + 8 j
  const float* lang_lo = lang + static_cast<size_t>(min(r_lo, M - 1) / N) * ldw;
  const float* lang_hi = lang + static_cast<size_t>(min(r_lo + 8, M - 1) / N) * ldw;
  const uint32_t base = smem_u32(smem);
  unsigned char* vstage = smem + kMutStages * kMutStageBytes + wg * kMutChunks * kChunkBytes;
  const int vr = wl * 16 + lane / 4;       // this thread's row in the v tile

  float acc[64], hsum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) hsum[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    int s = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int it = h * ktiles + kt;
      s = it % kMutStages;
      mbar_wait(&full[s], (it / kMutStages) & 1);
      const uint32_t a = base + s * kMutStageBytes + wg * kChunkBytes;
      const uint32_t b = base + s * kMutStageBytes + kMutABytes;
      wgmma_fence();
      mma_stage<kMutBN, 0, 1>(acc, sw128_desc(a, 16, 1024), sw128_desc(b, kChunkBytes, 1024),
                              2, (16 * kSwizzleBytes) >> 4, kt == 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0)
        release_stage_cluster(&empty[(it + kMutStages - 1) % kMutStages], wtid);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release_stage_cluster(&empty[s], wtid);

    // the head's epilogue, in registers: tanh(acc + b_h) * lang_h.  The
    // producer is meanwhile filling the ring with the next head's stages.
    if constexpr (kResidual) {
      if (wtid == 0) bulk_wait_read();   // the previous head's v tile is out
      named_bar_sync(1 + wg, 128);
    }
    const float* bh = bias + h * C;
#pragma unroll
    for (int j = 0; j < kMutBN / 8; ++j) {
      const int col = c0 + 8 * j + col_t;
      float2 bb = make_float2(0.f, 0.f), llo = bb, lhi = bb;
      if (col < C) {
        bb = *reinterpret_cast<const float2*>(bh + col);
        llo = *reinterpret_cast<const float2*>(lang_lo + h * C + col);
        lhi = *reinterpret_cast<const float2*>(lang_hi + h * C + col);
      }
      const float t0 = tanhf(acc[4 * j] + bb.x), t1 = tanhf(acc[4 * j + 1] + bb.y);
      const float t2 = tanhf(acc[4 * j + 2] + bb.x), t3 = tanhf(acc[4 * j + 3] + bb.y);
      hsum[4 * j] += t0 * llo.x;
      hsum[4 * j + 1] += t1 * llo.y;
      hsum[4 * j + 2] += t2 * lhi.x;
      hsum[4 * j + 3] += t3 * lhi.y;
      if constexpr (kResidual) {
        // the 128-byte swizzle TMA expects: 16-byte group g of row r at g ^ (r % 8)
        unsigned char* chunk = vstage + (j / 8) * kChunkBytes + 4 * (lane % 4);
        const int g = j % 8;
        store_bf2(chunk + vr * kSwizzleBytes + ((g ^ (vr % 8)) << 4), t0, t1);
        store_bf2(chunk + (vr + 8) * kSwizzleBytes + ((g ^ ((vr + 8) % 8)) << 4), t2, t3);
      }
    }
    if constexpr (kResidual) {
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (wtid == 0) {
#pragma unroll
        for (int j = 0; j < kMutChunks; ++j)
          tma_store_3d(&v_map, vstage + j * kChunkBytes, c0 + j * kChunk, h,
                       row0 + wg * 64);
        bulk_commit();
      }
    }
  }

  // tanh(head sum) out in f32, and this block's per-row sum of squares:
  // a row's 128 columns lie in the four threads of a quad
  float sq_lo = 0.f, sq_hi = 0.f;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < kMutBN / 8; ++j) {
    const int col = c0 + 8 * j + col_t;
    const float y0 = tanhf(hsum[4 * j]), y1 = tanhf(hsum[4 * j + 1]);
    const float y2 = tanhf(hsum[4 * j + 2]), y3 = tanhf(hsum[4 * j + 3]);
    if (col < C) {
      if (r_lo < M) {
        *reinterpret_cast<float2*>(y + static_cast<size_t>(r_lo) * C + col) =
            make_float2(y0, y1);
        sq_lo += y0 * y0 + y1 * y1;
      }
      if (r_hi < M) {
        *reinterpret_cast<float2*>(y + static_cast<size_t>(r_hi) * C + col) =
            make_float2(y2, y3);
        sq_hi += y2 * y2 + y3 * y3;
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sq_lo += __shfl_xor_sync(0xffffffffu, sq_lo, o);
    sq_hi += __shfl_xor_sync(0xffffffffu, sq_hi, o);
  }
  if (lane % 4 == 0 && ct < col_tiles) {
    if (r_lo < M) rowsq[static_cast<size_t>(r_lo) * col_tiles + ct] = sq_lo;
    if (r_hi < M) rowsq[static_cast<size_t>(r_hi) * col_tiles + ct] = sq_hi;
  }
  if constexpr (kResidual) {
    if (wtid == 0) bulk_wait();
  }
}

// One row per block: out = y * rsqrt(max(the row's sum of squares, 1e-12))
// in bf16, the sum taken over the column tiles' partial sums in order.
// C a multiple of 4 (16-byte loads, 8-byte stores).
__global__ void mutan_norm_kernel(const float* __restrict__ y,
                                  const float* __restrict__ rowsq,
                                  bf16* __restrict__ out, int C, int col_tiles) {
  const size_t row = blockIdx.x;
  float sq = 0.f;
  for (int j = 0; j < col_tiles; ++j) sq += rowsq[row * col_tiles + j];
  const float inv = rsqrtf(fmaxf(sq, 1e-12f));
  const float4* yr = reinterpret_cast<const float4*>(y + row * C);
  uint2* orow = reinterpret_cast<uint2*>(out + row * C);
  for (int c = threadIdx.x; c < C / 4; c += blockDim.x) {
    const float4 v = yr[c];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * inv, v.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * inv, v.w * inv);
    orow[c] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <bool kResidual>
int launch_heads(const CUtensorMap& x_map, const CUtensorMap& w_map,
                 const CUtensorMap& v_map, const float* bias, const float* lang,
                 float* y, float* rowsq, int M, int K, int C, int N, int heads,
                 cudaStream_t s) {
  const auto kernel = mutan_heads_kernel<kResidual>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMutSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (C + kMutBN - 1) / kMutBN;
  const int row_tiles = (M + kMutBM - 1) / kMutBM;
  // padded to whole clusters
  const dim3 grid((col_tiles + kClusterX - 1) / kClusterX * kClusterX,
                  (row_tiles + kClusterY - 1) / kClusterY * kClusterY);
  kernel<<<grid, kMutThreads, kMutSmem, s>>>(x_map, w_map, v_map, bias, lang, y, rowsq,
                                             M, K, C, N, heads, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cmpc

extern "C" int cmpc_mutan_col_tiles(int C) { return (C + cmpc::kMutBN - 1) / cmpc::kMutBN; }

// x [M, K] bf16, w [K, heads*C] bf16, bias [heads*C] f32, lang [M/N, heads*C]
// f32 -> out [M, C] bf16; y [M, C] f32 and rowsq [M, col_tiles] f32 are
// scratch.  Row r uses lang row r / N.  v: null, or [M, heads*C] bf16 that
// receives tanh(x @ W + b) (the training residual).  x, w and v 16-byte
// aligned, K and C multiples of 8 (TMA strides).
extern "C" int cmpc_mutan_fused(const void* x, const void* w, const void* bias,
                                const void* lang, void* y, void* rowsq, void* out,
                                void* v, int M, int K, int C, int N, int heads,
                                void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t bf = sizeof(bf16);
  CUtensorMap x_map, w_map, v_map;
  // x in boxes of 64 rows: each block of a cluster row loads half a tile
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t x_strides[1] = {K * bf};
  const uint32_t x_box[2] = {kChunk, 64};
  int rc = encode_tmap(&x_map, x, 2, x_dims, x_strides, x_box);
  if (rc) return rc;
  // [K][heads][C] viewed innermost first: a box never crosses into the next head
  const uint64_t w_dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(heads),
                              static_cast<uint64_t>(K)};
  const uint64_t w_strides[2] = {C * bf, heads * C * bf};
  const uint32_t box3[3] = {kChunk, 1, kTileK};
  rc = encode_tmap(&w_map, w, 3, w_dims, w_strides, box3);
  if (rc) return rc;
  v_map = w_map;   // unused by the inference form
  if (v) {
    const uint64_t v_dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(heads),
                                static_cast<uint64_t>(M)};
    rc = encode_tmap(&v_map, v, 3, v_dims, w_strides, box3);
    if (rc) return rc;
  }
  const auto* b = static_cast<const float*>(bias);
  const auto* l = static_cast<const float*>(lang);
  auto* yf = static_cast<float*>(y);
  auto* sq = static_cast<float*>(rowsq);
  rc = v ? launch_heads<true>(x_map, w_map, v_map, b, l, yf, sq, M, K, C, N, heads, s)
         : launch_heads<false>(x_map, w_map, v_map, b, l, yf, sq, M, K, C, N, heads, s);
  if (rc) return rc;
  mutan_norm_kernel<<<M, 256, 0, s>>>(yf, sq, static_cast<bf16*>(out), C,
                                      cmpc_mutan_col_tiles(C));
  return static_cast<int>(cudaGetLastError());
}
