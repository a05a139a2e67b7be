// Gated-exchange SE sum with the row l2norm (CMPC_model.py:245-259 and the
// l2norm the fusion stack applies):
//   acc = feat
//   acc = bf16(acc + bf16(relu(bf16(bf16(o_i @ W_i) + b_i)) * gate_i))   for each other i
//   out = bf16(acc * rsqrt(max(|acc|^2, 1e-12)))                        (norm in f32)
// rounded to bf16 at each step, as the TPU kernel rounds.
//
// Replaces cmpc_refseg_tpu/ops/pallas_kernels.py::se_sum_fused.
// Bound on the card: bytes at the flagship shapes (feat, 2 others and out,
// [8*1600, 500] bf16 each, 52 MB with the weights, against 12.8 GFLOP of
// products).  Design (csrc/hopper.cuh): a block owns 64 rows and 128
// columns; the blocks of a thread-block cluster lie side by side along the
// columns and together cover whole rows (4 blocks for C = 500), which the
// row l2norm needs.  A producer warpgroup keeps a 4-stage ring full with
// the others' [64 x 64 of K] rows and W_i's [64 of K x 128] columns, both by
// cp.async: C = 500 rows are 1000 bytes apart, which a TMA tensor map
// refuses, so 8-byte copies are written into the 128-byte swizzled layout
// (zeros past M and C); the issuing threads wait for them, fence them to
// the async proxy and arrive on the stage's full barrier two iterations
// later, before they wait for the next free stage.  The consumer
// warpgroup runs m64n128k16 wgmmas into 64 f32 registers a thread over
// ceil(C/64) k tiles per other; the running sum lives in registers too,
// packed as bf16 pairs (exact: the reference rounds it to bf16 after every
// add), and each other's epilogue folds into it straight from the
// fragment, so the per-other products never leave the SM.  The norm:
// per-row partial sums of squares (a quad shuffle) go to shared memory,
// the cluster syncs, each block reads its peers' partials over DSMEM and
// sums them in rank order (deterministic), scales and stores bf16 pairs; a
// second cluster sync keeps every block alive until its peers have read
// it.  A row tile may straddle two samples: each row reads its own
// sample's gates.  128-row tiles (two consumer warpgroups, half the W_i
// reads) measured slower at every batch: with a third warpgroup a thread
// gets at most 168 registers and the consumers spill (PERF.md).
#include "common.cuh"
#include "hopper.cuh"

namespace cmpc {

constexpr int kSeBM = 64;             // rows per block: one consumer warpgroup
constexpr int kSeBN = 128;            // columns per block
constexpr int kSeStages = 4;
constexpr int kSeLag = 2;             // iterations between a cp.async issue and its arrival
constexpr int kSeMaxOthers = 4;
constexpr int kSeMaxCluster = 8;      // blocks per row tile: C <= 1024
constexpr int kSeThreads = 2 * 128;   // the consumer warpgroup, then the producer
constexpr int kSeABytes = kSeBM * kSwizzleBytes;                        // [64][64]
constexpr int kSeBBytes = kTileK * kSwizzleBytes * (kSeBN / kChunk);    // [64][128]
constexpr int kSeStageBytes = kSeABytes + kSeBBytes;
constexpr int kSeSmem = 1024 + kSeStages * kSeStageBytes;

struct SeOthers {
  const bf16* o[kSeMaxOthers];   // [M, C]
  const bf16* w[kSeMaxOthers];   // [C, C]
  const bf16* b[kSeMaxOthers];   // [C]
  const bf16* g[kSeMaxOthers];   // [B, C]
};

// The SE sum of one block.  blockIdx.x: the 128-column slice, y: the row
// tile.  CLUSTER = true (se_sum_kernel, C <= 1024): the slices of a row
// tile form one cluster (blockIdx.x is the rank) and the row norm is
// summed over DSMEM.  CLUSTER = false (the wide form, any C): no cluster;
// each row's sum of squares over the block's columns goes to its slot of
// `sq_part` [M, gridDim.x] and the unnormalised bf16 sum to `out`, which
// se_sum_wide_norm_kernel then scales.
template <bool CLUSTER>
__device__ __forceinline__ void se_sum_block(const bf16* __restrict__ feat,
                                             SeOthers others, int k,
                                             bf16* __restrict__ out,
                                             float* __restrict__ sq_part, int M, int N,
                                             int C) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kSeStages], empty[kSeStages];
  __shared__ float rowsq[kSeBM];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int c0 = blockIdx.x * kSeBN, row0 = blockIdx.y * kSeBM;
  const int ktiles = (C + kTileK - 1) / kTileK;
  const int iters = k * ktiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(smem);

  if (threadIdx.x == 0) {
    for (int q = 0; q < kSeStages; ++q) {
      mbar_init(&full[q], 128);   // the producer's threads
      mbar_init(&empty[q], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {
    // producer
    const int tid = threadIdx.x - 128;
    for (int it = 0; it < iters + kSeLag; ++it) {
      // first publish the stage issued kSeLag iterations ago (its copies are
      // in), then wait for a free stage: the consumers never wait on a stage
      // whose copies landed while the producer sat on an empty barrier
      if (it >= kSeLag) {
        cp_async_wait<kSeLag - 1>();
        fence_proxy_async();
        mbar_arrive(&full[(it - kSeLag) % kSeStages]);
      }
      if (it < iters) {
        const int q = it % kSeStages;
        mbar_wait(&empty[q], ((it / kSeStages) & 1) ^ 1);
        const int i = it / ktiles, k0 = (it % ktiles) * kTileK;
        const uint32_t a = base + q * kSeStageBytes;
        cp_async_tile<kSeBM, kTileK, 128>(a, others.o[i] + static_cast<size_t>(row0) * C + k0,
                                          C, M - row0, C - k0, feat, tid);
        cp_async_tile<kTileK, kSeBN, 128>(a + kSeABytes,
                                          others.w[i] + static_cast<size_t>(k0) * C + c0, C,
                                          C - k0, C - c0, feat, tid);
      }
      cp_async_commit();   // an empty group in the tail keeps the lag's count
    }
    if constexpr (CLUSTER) {
      cluster_sync();   // the consumers' two cluster barriers below
      cluster_sync();
    }
    return;
  }

  // consumer: this thread holds rows r_lo and r_lo + 8 (hf = 0, 1) of the
  // tile, columns col_t + 8 j (+ 1)
  const int r_lo = warp * 16 + lane / 4;
  const int col_t = c0 + 2 * (lane % 4);
  float acc[kSeBN / 2];
  __nv_bfloat162 sum[kSeBN / 4];   // the running sum, pairs: 2 j + hf

  // acc = feat, as bf16 pairs (rows are 4-byte aligned: C is even).  Every
  // load in the epilogues reads a clamped, valid address and the result is
  // masked afterwards, so the unrolled loads issue together instead of one
  // L2 round trip after another behind each bounds check.
  const int rows_c[2] = {min(row0 + r_lo, M - 1), min(row0 + r_lo + 8, M - 1)};
#pragma unroll
  for (int j = 0; j < kSeBN / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = col_t + 8 * j;
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          feat + static_cast<size_t>(rows_c[hf]) * C + min(col, C - 2));
      sum[2 * j + hf] =
          row0 + r_lo + 8 * hf < M && col < C ? v : __floats2bfloat162_rn(0.f, 0.f);
    }
  int sample[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) sample[hf] = rows_c[hf] / N;

  constexpr uint32_t kStepB = (16 * kSwizzleBytes) >> 4;   // 16 rows of K
  int it = 0;
  for (int i = 0; i < k; ++i) {
    int q = 0;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      q = it % kSeStages;
      mbar_wait(&full[q], (it / kSeStages) & 1);
      const uint32_t a = base + q * kSeStageBytes;
      wgmma_fence();
      mma_stage<kSeBN, 0, 1>(acc, sw128_desc(a, 16, 1024),
                             sw128_desc(a + kSeABytes, kTileK * kSwizzleBytes, 1024), 2,
                             kStepB, kt == 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && threadIdx.x == 0)
        mbar_arrive(&empty[(it + kSeStages - 1) % kSeStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (threadIdx.x == 0) mbar_arrive(&empty[q]);

    // sum = bf16(sum + bf16(relu(bf16(bf16(acc) + b)) * gate)), from the
    // fragment: register 4 j + 2 hf + e holds row r_lo + 8 hf, column
    // col_t + 8 j + e.  The producer meanwhile fills the next other's stages.
    const bf16* bias = others.b[i];
    const bf16* gate = others.g[i];
#pragma unroll
    for (int j = 0; j < kSeBN / 8; ++j) {
      const int col = col_t + 8 * j, colc = min(col, C - 2);
      const float2 bb = ld_bf2(bias + colc);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 gg = ld_bf2(gate + static_cast<size_t>(sample[hf]) * C + colc);
        const float2 sv = __bfloat1622float2(sum[2 * j + hf]);
        const float t0 = round_bf(round_bf(acc[4 * j + 2 * hf]) + bb.x);
        const float t1 = round_bf(round_bf(acc[4 * j + 2 * hf + 1]) + bb.y);
        const float u0 = round_bf(fmaxf(t0, 0.f) * gg.x);
        const float u1 = round_bf(fmaxf(t1, 0.f) * gg.y);
        if (col < C) sum[2 * j + hf] = __floats2bfloat162_rn(sv.x + u0, sv.y + u1);
      }
    }
  }

  // this block's share of each row's sum of squares: a row's 128 columns
  // lie in the four threads of a quad
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kSeBN / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 v = __bfloat1622float2(sum[2 * j + hf]);
      sq[hf] += v.x * v.x + v.y * v.y;
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sq[hf] += __shfl_xor_sync(0xffffffffu, sq[hf], 1);
    sq[hf] += __shfl_xor_sync(0xffffffffu, sq[hf], 2);
    if constexpr (CLUSTER) {
      if (lane % 4 == 0) rowsq[r_lo + 8 * hf] = sq[hf];
    }
  }

  if constexpr (CLUSTER) {
    cluster_sync();   // every block's partials are written
    const uint32_t blocks = cluster_blocks();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + r_lo + 8 * hf;
      float total = 0.f;
      for (uint32_t rank = 0; rank < blocks; ++rank)
        total += ld_cluster_f32(&rowsq[r_lo + 8 * hf], rank);
      const float inv = rsqrtf(fmaxf(total, 1e-12f));
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < kSeBN / 8; ++j) {
        const int col = col_t + 8 * j;
        if (col >= C) continue;
        const float2 v = __bfloat1622float2(sum[2 * j + hf]);
        st_bf2(out + static_cast<size_t>(r) * C + col, v.x * inv, v.y * inv);
      }
    }
    cluster_sync();   // no block exits while a peer may still read its partials
  } else {
    // this slice's slot of each row, and the unnormalised sum
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + r_lo + 8 * hf;
      if (r >= M) continue;
      if (lane % 4 == 0) sq_part[static_cast<size_t>(r) * gridDim.x + blockIdx.x] = sq[hf];
#pragma unroll
      for (int j = 0; j < kSeBN / 8; ++j) {
        const int col = col_t + 8 * j;
        if (col < C)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * C + col) =
              sum[2 * j + hf];
      }
    }
  }
}

__global__ void __launch_bounds__(kSeThreads, 1)
se_sum_kernel(const bf16* __restrict__ feat, SeOthers others, int k,
              bf16* __restrict__ out, int M, int N, int C) {
  se_sum_block<true>(feat, others, k, out, nullptr, M, N, C);
}

// The 128-column slices of a row.
inline int se_slices(int C) { return (C + kSeBN - 1) / kSeBN; }

// The kernels' argument of k host arrays of device pointers.
inline SeOthers se_others(const void* const* others, const void* const* ws,
                          const void* const* bs, const void* const* gates, int k) {
  SeOthers args{};
  for (int i = 0; i < k; ++i) {
    args.o[i] = static_cast<const bf16*>(others[i]);
    args.w[i] = static_cast<const bf16*>(ws[i]);
    args.b[i] = static_cast<const bf16*>(bs[i]);
    args.g[i] = static_cast<const bf16*>(gates[i]);
  }
  return args;
}

}  // namespace cmpc

// feat [M, C] bf16 (M = B*N rows, row r of sample r / N); others[i] [M, C],
// ws[i] [C, C], bs[i] [C], gates[i] [B, C] bf16 for i < k <= 4 (host arrays
// of device pointers) -> out [M, C] bf16.  C a multiple of 4 (8-byte rows),
// at most 1024 (a cluster of 8 blocks of 128 columns covers a row).
extern "C" int cmpc_se_sum(const void* feat, const void* const* others,
                           const void* const* ws, const void* const* bs,
                           const void* const* gates, int k, void* out, int M, int N,
                           int C, void* stream) {
  using namespace cmpc;
  if (k < 1 || k > kSeMaxOthers || C % 4 || C > kSeMaxCluster * kSeBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const SeOthers args = se_others(others, ws, bs, gates, k);
  cudaError_t err = cudaFuncSetAttribute(
      se_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSeSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the blocks of a row tile form one cluster
  const int slices = se_slices(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, (M + kSeBM - 1) / kSeBM, 1);
  cfg.blockDim = dim3(kSeThreads, 1, 1);
  cfg.dynamicSmemBytes = kSeSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, se_sum_kernel,
                                             static_cast<const bf16*>(feat), args, k,
                                             static_cast<bf16*>(out), M, N, C));
}

// ---------------------------------------------------------------------------
// The wide form, for C > kSeMaxCluster * kSeBN (1024): a row no longer fits
// one cluster, so its l2norm cannot be summed over DSMEM.  No TPU kernel of
// its own: the Pallas kernel's block spans the whole row at any C.  Two
// launches:
//  1. se_sum_wide_kernel, the main kernel's pipeline without the cluster
//     (se_sum_block<false>): the same producer ring, m64n128 wgmma consumer
//     and fragment epilogue, on ceil(C/128) column slices x ceil(M/64) row
//     tiles; each row's quad-shuffled sum of squares over the block's 128
//     columns goes to its slot of a [M, ceil(C/128)] f32 scratch, the
//     unnormalised bf16 sum to `out`;
//  2. se_sum_wide_norm_kernel, a warp per row: the row's slots added in
//     slice order (deterministic, the cluster's rank order), then out =
//     bf16(out * rsqrt(max(sum, 1e-12))) in place, 16-byte accesses where
//     C % 8 == 0 (8-byte otherwise).
// Bound on the card: operations at such widths (the k products of
// [M, C] x [C, C]).
// ---------------------------------------------------------------------------
namespace cmpc {

constexpr int kSeNormWarps = 8;   // rows per block of the norm pass

__global__ void __launch_bounds__(kSeThreads, 1)
se_sum_wide_kernel(const bf16* __restrict__ feat, SeOthers others, int k,
                   bf16* __restrict__ out, float* __restrict__ sq_part, int M, int N,
                   int C) {
  se_sum_block<false>(feat, others, k, out, sq_part, M, N, C);
}

template <int VEC>
__global__ void __launch_bounds__(32 * kSeNormWarps)
se_sum_wide_norm_kernel(bf16* __restrict__ out, const float* __restrict__ sq_part, int M,
                        int C, int slices) {
  const int row = blockIdx.x * kSeNormWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* part = sq_part + static_cast<size_t>(row) * slices;
  float total = 0.f;
  for (int j = 0; j < slices; ++j) total += part[j];
  const float inv = rsqrtf(fmaxf(total, 1e-12f));
  bf16* p = out + static_cast<size_t>(row) * C;
  for (int c = VEC * lane; c < C; c += 32 * VEC) {
    float v[VEC];
    load_bf<VEC>(p + c, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] *= inv;
    store_bf<VEC>(p + c, v);
  }
}

}  // namespace cmpc

// Bytes of the wide form's scratch: the row norms' partials [M, ceil(C/128)]
// f32, a slot per 128-column slice.
extern "C" long long cmpc_se_sum_wide_scratch(int M, int C) {
  return static_cast<long long>(M) * cmpc::se_slices(C) * sizeof(float);
}

// The contract of cmpc_se_sum for any C (a multiple of 4), with `scratch`
// of cmpc_se_sum_wide_scratch(M, C) bytes.
extern "C" int cmpc_se_sum_wide(const void* feat, const void* const* others,
                                const void* const* ws, const void* const* bs,
                                const void* const* gates, int k, void* out, void* scratch,
                                int M, int N, int C, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kSeMaxOthers || C % 4 || C < 4 || M < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  const SeOthers args = se_others(others, ws, bs, gates, k);
  cudaError_t err = cudaFuncSetAttribute(
      se_sum_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSeSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = se_slices(C);
  float* sq_part = static_cast<float*>(scratch);
  se_sum_wide_kernel<<<dim3(slices, (M + kSeBM - 1) / kSeBM), kSeThreads, kSeSmem, s>>>(
      static_cast<const bf16*>(feat), args, k, static_cast<bf16*>(out), sq_part, M, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kSeNormWarps - 1) / kSeNormWarps;
  if (C % 8 == 0 && aligned16(out))
    se_sum_wide_norm_kernel<8><<<blocks, 32 * kSeNormWarps, 0, s>>>(
        static_cast<bf16*>(out), sq_part, M, C, slices);
  else
    se_sum_wide_norm_kernel<4><<<blocks, 32 * kSeNormWarps, 0, s>>>(
        static_cast<bf16*>(out), sq_part, M, C, slices);
  return static_cast<int>(cudaGetLastError());
}
