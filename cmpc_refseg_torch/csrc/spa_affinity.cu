// Spatial-graph word affinity with both softmax normalisations.
//
// Replaces cmpc_refseg_tpu/ops/pallas_kernels.py::spa_affinity_fused, in
// both forms: one weight pair, or G groups (wg [G, C, A], bg [G, A]; sample
// s uses group s / (B / G), the level-packed layout).  Per sample s and
// node row n:
//   g    = bf16(bf16(x[n] @ Wg) + bg)                     (projection, [A])
//   g    = bf16(g * rsqrt(max(|g|^2, 1e-12)))             (if L2N)
//   affi = rel[s] * ((g @ wt[s]^T) / scale)               ([T], f32)
//   w    = softmax_T(mask*affi + (1-mask)*min)  (MASKED)  or  mask*softmax_T(affi)
// plus per-block column-softmax partials (max over rows, sum exp(affi - max))
// from which the wrapper finalises v_aff = mask * softmax_N(affi).
//
// Bound on the card: operations (the [B*N, C] x [C, A] projection, 205
// GFLOP at bs=64, against ~260 MB).  Design (csrc/hopper.cuh): a block
// owns 128 rows of one sample x 256 of the A projection columns; the
// ceil(A/256) blocks of a row tile form one cluster (4 for A = 1000).  One
// producer thread keeps a 4-stage TMA ring full: the x tile [128 x 64 of
// K] through a 3D map [B][N][C] (zero past the sample's rows), each of its
// two boxes loaded by one block and multicast to the cluster, and the
// block's own Wg boxes [64 of K x 64 columns] x 4 (N-major, trans-b).  Two
// consumer warpgroups run m64n256k16 wgmmas into 128 f32 registers a
// thread.  The epilogue rounds, adds bg and, with L2N, sums each row's
// squares over the cluster: per-row partials (a quad shuffle) go to shared
// memory and every block reads its peers' over DSMEM in rank order.  The
// scaled g chunk stays in registers, packed to bf16 in the A-operand
// layout of a wgmma (an accumulator fragment's layout), so the projection
// never leaves the SM.  The word affinities are a second wgmma, g chunk x
// wt[s][:, chunk]^T, with A from registers, in chunks of 32 words
// (m64n32k16; wt by TMA as a K-major [32 x 64] box per 64 columns), for
// any T.  Each block's [128 x 32] partial goes to shared memory; after a
// cluster barrier block r sums its share of the rows, r*ceil(128/blocks)
// ..., over the cluster's partials by DSMEM in rank order (deterministic),
// applies the relation scale, stores affi and keeps an online row softmax
// (max, sum) across the word chunks and the column partials; a second
// cluster barrier frees the partials for the next chunk.  The last chunk's
// words get their softmax at once; a last pass forms the earlier chunks'
// from the stored affi.
#include "common.cuh"
#include "hopper.cuh"

namespace cmpc {

constexpr int kAffBM = 128;                            // rows per block
constexpr int kAffBN = 256;                            // A columns per block
constexpr int kAffMaxCluster = 8;                      // A <= 2048
constexpr int kAffStages = 4;
constexpr int kAffWarps = 9;   // two consumer warpgroups, then the producer warp
constexpr int kAffThreads = kAffWarps * 32;
constexpr int kAffWords = 32;                          // words per chunk (wgmma N)
constexpr int kAffRowsAtOnce = 4;                      // rows a warp finishes together
constexpr int kAffBox = kTileK * kSwizzleBytes;        // [64][64] bf16
constexpr int kAffXBytes = kAffBM * kSwizzleBytes;     // x [128][64]
constexpr int kAffStage = kAffXBytes + (kAffBN / kChunk) * kAffBox;
// wt's 32-word chunk [4][32][64] bf16 lies past the ring (its first load
// is issued at the start); after the projection the ring holds the f32
// word partials [128][kAffPLd]
constexpr int kAffWt = kAffStages * kAffStage;
constexpr int kAffWtSub = kAffWords * kSwizzleBytes;
constexpr int kAffSmem = 1024 + kAffWt + (kAffBN / kChunk) * kAffWtSub;
constexpr int kAffP = 0;
constexpr int kAffPLd = kAffWords + 8;
static_assert(kAffP + kAffBM * kAffPLd * 4 <= kAffStages * kAffStage, "fits the ring");

// blockIdx.x: the 256-column slice of A (the cluster's rank), y: the
// 128-row tile of sample z.
template <bool L2N, bool MASKED>
__global__ void __launch_bounds__(kAffThreads, 1)
spa_affinity_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap wg_map,
                    const __grid_constant__ CUtensorMap wt_map,
                    const bf16* __restrict__ bg, const float* __restrict__ rel,
                    const float* __restrict__ mask, float* __restrict__ w_out,
                    float* __restrict__ affi_out, float* __restrict__ stats, int N, int C,
                    int A, int T, int per_group, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kAffStages], empty[kAffStages], wt_bar;
  __shared__ float rowsq[kAffBM];
  __shared__ float row_m[kAffBM], row_l[kAffBM];
  __shared__ float col_s[kAffWarps][kAffWords][2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int ct = blockIdx.x, rb = blockIdx.y, s = blockIdx.z;
  const int a0 = ct * kAffBN, row0 = rb * kAffBM;
  const int nrows = min(kAffBM, N - row0);
  const int grp = s / per_group;
  const int ktiles = (C + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t nblk = cluster_blocks(), rank = cluster_rank();
  const uint32_t base = smem_u32(smem);

  if (threadIdx.x == 0) {
    for (int q = 0; q < kAffStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], 2 * nblk);   // both consumer warpgroups of every block
    }
    mbar_init(&wt_bar, 1);
    mbar_fence_init();
  }
  cluster_sync();
  if (threadIdx.x == 0) {   // wt's first chunk
    mbar_arrive_expect_tx(&wt_bar, (kAffBN / kChunk) * kAffWtSub);
#pragma unroll
    for (int j = 0; j < kAffBN / kChunk; ++j)
      tma_load_3d(smem + kAffWt + j * kAffWtSub, &wt_map, &wt_bar, a0 + j * kChunk, 0, s);
  }

  // 1. the projection chunk, and 2. its epilogue into registers
  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const int r_lo = wg * 64 + wl * 16 + lane / 4;   // and r_lo + 8
  uint32_t ga[kAffBN / 16][4];   // the consumers' g chunk, bf16 pairs (below)
  if (warp == 8) {
    if (lane == 0) {
      const uint16_t all = static_cast<uint16_t>((1u << nblk) - 1);
      tma_prefetch(&x_map);
      tma_prefetch(&wg_map);
      for (int it = 0; it < ktiles + kAffStages; ++it) {
        const int q = it % kAffStages;
        mbar_wait(&empty[q], ((it / kAffStages) & 1) ^ 1);
        if (it >= ktiles) continue;   // the tail: until every block released every stage
        unsigned char* st = smem + q * kAffStage;
        const int k0 = it * kTileK;
        mbar_arrive_expect_tx(&full[q], kAffStage);
        for (int b = rank; b < kAffBM / 64; b += nblk)
          tma_load_3d_mc(st + b * kAffBox, &x_map, &full[q], k0, row0 + 64 * b, s, all);
#pragma unroll
        for (int j = 0; j < kAffBN / kChunk; ++j)
          tma_load_3d(st + kAffXBytes + j * kAffBox, &wg_map, &full[q], a0 + j * kChunk, k0,
                      grp);
      }
    }
    __syncwarp();
  } else {
    constexpr uint32_t kStepB = (16 * kSwizzleBytes) >> 4;   // 16 rows of K
    float acc[kAffBN / 2];
    int q = 0;
    for (int it = 0; it < ktiles; ++it) {
      q = it % kAffStages;
      mbar_wait(&full[q], (it / kAffStages) & 1);
      const uint32_t a = base + q * kAffStage + wg * kAffBox;
      const uint32_t b = base + q * kAffStage + kAffXBytes;
      wgmma_fence();
      mma_stage<kAffBN, 0, 1>(acc, sw128_desc(a, 16, 1024), sw128_desc(b, kAffBox, 1024), 2,
                              kStepB, it == 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0 && wtid < static_cast<int>(nblk))
        mbar_arrive_remote(&empty[(it + kAffStages - 1) % kAffStages], wtid);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (wtid < static_cast<int>(nblk)) mbar_arrive_remote(&empty[q], wtid);
    named_bar_sync(1, 256);   // the ring is free for the partials: every stage was consumed

    // g = bf16(bf16(acc) + bg), zero past A: register 4 j + 2 hf + e holds
    // row r_lo + 8 hf, column a0 + 8 j + 2 (lane % 4) + e
    const bf16* bgg = bg + static_cast<size_t>(grp) * A;
    const int col_t = a0 + 2 * (lane % 4);
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kAffBN / 8; ++j) {
      const int col = col_t + 8 * j;
      const float2 bb = ld_bf2(bgg + min(col, A - 2));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float& g0 = acc[4 * j + 2 * hf];
        float& g1 = acc[4 * j + 2 * hf + 1];
        g0 = col < A ? round_bf(round_bf(g0) + bb.x) : 0.f;
        g1 = col < A ? round_bf(round_bf(g1) + bb.y) : 0.f;
        sq[hf] += g0 * g0 + g1 * g1;
      }
    }
    if (L2N) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sq[hf] += __shfl_xor_sync(0xffffffffu, sq[hf], 1);
        sq[hf] += __shfl_xor_sync(0xffffffffu, sq[hf], 2);
        if (lane % 4 == 0) rowsq[r_lo + 8 * hf] = sq[hf];
      }
    }
    if (L2N) cluster_sync();   // every block's row partials are written (the producer warp joins below)
    float inv[2] = {1.f, 1.f};
    if (L2N) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float total = 0.f;
        for (uint32_t r = 0; r < nblk; ++r) total += ld_cluster_f32(&rowsq[r_lo + 8 * hf], r);
        inv[hf] = rsqrtf(fmaxf(total, 1e-12f));
      }
    }
    // the g chunk in bf16 as the A operand of the word product, straight
    // from the fragment: k16 step kk takes the column groups j = 2 kk and
    // 2 kk + 1 (wgmma_m64n32k16_rs)
#pragma unroll
    for (int kk = 0; kk < kAffBN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 4 * (2 * kk + h / 2) + 2 * (h % 2);   // j = 2 kk + h / 2, hf = h % 2
        const float sc = L2N ? inv[h % 2] : 1.f;
        ga[kk][h] = bf2_bits(__floats2bfloat162_rn(acc[i] * sc, acc[i + 1] * sc));
      }
  }
  if (L2N && warp == 8) cluster_sync();

  // 3. the word affinities, 32 words at a time
  const int tchunks = (T + kAffWords - 1) / kAffWords;
  const int rpb = (kAffBM + nblk - 1) / nblk;           // rows this block finishes
  const int my_lo = rank * rpb, my_hi = min(nrows, static_cast<int>(rank + 1) * rpb);
  const size_t grow0 = static_cast<size_t>(s) * N + row0;
  const int row_blocks = gridDim.y * nblk;
  float* part = reinterpret_cast<float*>(smem + kAffP);
  for (int tc = 0; tc < tchunks; ++tc) {
    // lane = word: its mask and relation weight, loaded ahead of their use
    const int t = tc * kAffWords + lane;
    const bool word = t < T, last = tc + 1 == tchunks;
    const float m_lane = word ? mask[static_cast<size_t>(s) * T + t] : 0.f;
    const float r_lane = word ? rel[static_cast<size_t>(s) * T + t] : 0.f;
    if (warp < 8) {
      mbar_wait(&wt_bar, tc & 1);
      float acc2[kAffWords / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kAffBN / 16; ++kk)
        wgmma_m64n32k16_rs<0>(acc2, ga[kk],
                              sw128_desc(base + kAffWt + (kk / 4) * kAffWtSub, 16, 1024) +
                                  2 * (kk % 4),
                              kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc2);
#pragma unroll
      for (int j = 0; j < kAffWords / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(part + (r_lo + 8 * hf) * kAffPLd + 8 * j +
                                     2 * (lane % 4)) =
              make_float2(acc2[4 * j + 2 * hf], acc2[4 * j + 2 * hf + 1]);
    }
    cluster_sync();   // (a) every block's partials of this chunk are written
    if (threadIdx.x == 0 && tc + 1 < tchunks) {   // the next chunk's wt: its buffer is free
      mbar_arrive_expect_tx(&wt_bar, (kAffBN / kChunk) * kAffWtSub);
#pragma unroll
      for (int j = 0; j < kAffBN / kChunk; ++j)
        tma_load_3d(smem + kAffWt + j * kAffWtSub, &wt_map, &wt_bar, a0 + j * kChunk,
                    (tc + 1) * kAffWords, s);
    }

    // this block's rows: one warp per row, lane = word, kAffRowsAtOnce rows
    // of a warp at a time so that their DSMEM reads and warp reductions
    // overlap.  In the last chunk the row's (max, sum) are final, so its
    // words' softmax is written at once.
    float col_max = -INFINITY, col_sum = 0.f;
    for (int r0 = my_lo + warp; r0 < my_hi; r0 += kAffRowsAtOnce * kAffWarps) {
      float v[kAffRowsAtOnce][kAffMaxCluster];
#pragma unroll
      for (int u = 0; u < kAffRowsAtOnce; ++u)
#pragma unroll
        for (int q = 0; q < kAffMaxCluster; ++q)
          v[u][q] = q < static_cast<int>(nblk) && r0 + u * kAffWarps < my_hi
                        ? ld_cluster_f32(part + (r0 + u * kAffWarps) * kAffPLd + lane, q)
                        : 0.f;
      float affi[kAffRowsAtOnce], z[kAffRowsAtOnce], m_new[kAffRowsAtOnce],
          l_new[kAffRowsAtOnce], e[kAffRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kAffRowsAtOnce; ++u) {
        float raw = 0.f;
#pragma unroll
        for (int q = 0; q < kAffMaxCluster; ++q) raw += v[u][q];   // rank order
        affi[u] = r_lane * (raw / scale);
        z[u] = MASKED ? m_lane * affi[u] + (1.f - m_lane) * (-FLT_MAX) : affi[u];
        m_new[u] = word ? z[u] : -INFINITY;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kAffRowsAtOnce; ++u)
          m_new[u] = fmaxf(m_new[u], __shfl_xor_sync(0xffffffffu, m_new[u], o));
      float m_old[kAffRowsAtOnce], l_old[kAffRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kAffRowsAtOnce; ++u) {
        const int r = min(r0 + u * kAffWarps, kAffBM - 1);
        m_old[u] = tc == 0 ? -INFINITY : row_m[r];
        l_old[u] = tc == 0 ? 0.f : row_l[r];
        m_new[u] = fmaxf(m_new[u], m_old[u]);
        e[u] = word ? expf(z[u] - m_new[u]) : 0.f;
        l_new[u] = e[u];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kAffRowsAtOnce; ++u)
          l_new[u] += __shfl_xor_sync(0xffffffffu, l_new[u], o);
      __syncwarp();   // every lane has read the rows' old (max, sum)
#pragma unroll
      for (int u = 0; u < kAffRowsAtOnce; ++u) {
        const int r = r0 + u * kAffWarps;
        if (r >= my_hi) break;
        l_new[u] += l_old[u] * expf(m_old[u] - m_new[u]);
        if (lane == 0) {
          row_m[r] = m_new[u];
          row_l[r] = l_new[u];
        }
        if (word) {
          const size_t o = (grow0 + r) * T + t;
          affi_out[o] = affi[u];
          if (last) w_out[o] = MASKED ? e[u] / l_new[u] : m_lane * (e[u] / l_new[u]);
          const float nm = fmaxf(col_max, affi[u]);
          col_sum = col_sum * expf(col_max - nm) + expf(affi[u] - nm);
          col_max = nm;
        }
      }
    }
    col_s[warp][lane][0] = col_max;
    col_s[warp][lane][1] = col_sum;
    __syncthreads();
    if (threadIdx.x < kAffWords && word) {
      float m = -INFINITY;
      for (int w = 0; w < kAffWarps; ++w) m = fmaxf(m, col_s[w][lane][0]);
      float sum = 0.f;
      for (int w = 0; w < kAffWarps; ++w)
        if (col_s[w][lane][1] > 0.f) sum += col_s[w][lane][1] * expf(col_s[w][lane][0] - m);
      float* st = stats + (static_cast<size_t>(s) * row_blocks + rb * nblk + rank) * 2 * T;
      st[t] = m;
      st[T + t] = sum;
    }
    cluster_sync();   // (b) the peers have read this block's partials
  }

  // 4. the row softmax of the earlier chunks' words from the stored affi
  //    (each thread reads back what it wrote)
  for (int r = my_lo + warp; r < my_hi; r += kAffWarps) {
    const float m = row_m[r], inv_l = 1.f / row_l[r];
    for (int t = lane; t < (tchunks - 1) * kAffWords; t += kAffWords) {
      const size_t o = (grow0 + r) * T + t;
      const float affi = affi_out[o];
      const float mk = mask[static_cast<size_t>(s) * T + t];
      if (MASKED) {
        const float z = mk * affi + (1.f - mk) * (-FLT_MAX);
        w_out[o] = expf(z - m) * inv_l;
      } else {
        w_out[o] = mk * (expf(affi - m) * inv_l);
      }
    }
  }
}

inline int affinity_cluster(int A) { return (A + kAffBN - 1) / kAffBN; }

template <bool L2N, bool MASKED>
int launch_affinity(const CUtensorMap& x_map, const CUtensorMap& wg_map,
                    const CUtensorMap& wt_map, const void* bg, const void* rel,
                    const void* mask, void* w_out, void* affi_out, void* stats, int B,
                    int N, int C, int A, int T, int groups, float scale, cudaStream_t s) {
  const auto kernel = spa_affinity_kernel<L2N, MASKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAffSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(affinity_cluster(A), (N + kAffBM - 1) / kAffBM, B);
  cfg.blockDim = dim3(kAffThreads, 1, 1);
  cfg.dynamicSmemBytes = kAffSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = affinity_cluster(A);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, x_map, wg_map, wt_map, static_cast<const bf16*>(bg),
      static_cast<const float*>(rel), static_cast<const float*>(mask),
      static_cast<float*>(w_out), static_cast<float*>(affi_out), static_cast<float*>(stats),
      N, C, A, T, B / groups, scale));
}

}  // namespace cmpc

// Row blocks of the column statistics per sample: each 128-row tile is
// finished by the ceil(A/256) blocks of its cluster, a share each.
extern "C" int cmpc_spa_affinity_row_blocks(int N, int A) {
  return (N + cmpc::kAffBM - 1) / cmpc::kAffBM * cmpc::affinity_cluster(A);
}

// x [B*N, C], wg [G, C, A], bg [G, A], wt [B, T, A] bf16; rel, mask [B, T]
// f32 -> w_out, affi_out [B*N, T] f32 and stats [B, row_blocks, 2, T] f32
// (per-block column max, then sum of exp(affi - max)).  G divides B;
// sample s uses weight group s / (B / G).  x, wg and wt 16-byte aligned,
// C and A multiples of 8 (TMA strides), A <= 2048 (one cluster of 8
// blocks), any T >= 1.
extern "C" int cmpc_spa_affinity(const void* x, const void* wg, const void* bg,
                                 const void* wt, const void* rel, const void* mask,
                                 void* w_out, void* affi_out, void* stats, int B,
                                 int N, int C, int A, int T, int groups, float scale,
                                 int l2n, int masked, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || groups < 1 || B % groups || C % 8 || A % 8 ||
      A > kAffMaxCluster * kAffBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t bf = sizeof(bf16);
  CUtensorMap x_map, wg_map, wt_map;
  const uint32_t box[3] = {kChunk, 64, 1};
  // [B][N][C] innermost first: a row tile's boxes read zero past its sample
  const uint64_t x_dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(N),
                              static_cast<uint64_t>(B)};
  const uint64_t x_strides[2] = {C * bf, static_cast<uint64_t>(N) * C * bf};
  int rc = encode_tmap(&x_map, x, 3, x_dims, x_strides, box);
  if (rc) return rc;
  const uint64_t wg_dims[3] = {static_cast<uint64_t>(A), static_cast<uint64_t>(C),
                               static_cast<uint64_t>(groups)};
  const uint64_t wg_strides[2] = {A * bf, static_cast<uint64_t>(C) * A * bf};
  rc = encode_tmap(&wg_map, wg, 3, wg_dims, wg_strides, box);
  if (rc) return rc;
  const uint64_t wt_dims[3] = {static_cast<uint64_t>(A), static_cast<uint64_t>(T),
                               static_cast<uint64_t>(B)};
  const uint64_t wt_strides[2] = {A * bf, static_cast<uint64_t>(T) * A * bf};
  const uint32_t wt_box[3] = {kChunk, kAffWords, 1};
  rc = encode_tmap(&wt_map, wt, 3, wt_dims, wt_strides, wt_box);
  if (rc) return rc;
  if (l2n && masked)
    return launch_affinity<true, true>(x_map, wg_map, wt_map, bg, rel, mask, w_out,
                                       affi_out, stats, B, N, C, A, T, groups, scale, s);
  if (l2n)
    return launch_affinity<true, false>(x_map, wg_map, wt_map, bg, rel, mask, w_out,
                                        affi_out, stats, B, N, C, A, T, groups, scale, s);
  if (masked)
    return launch_affinity<false, true>(x_map, wg_map, wt_map, bg, rel, mask, w_out,
                                        affi_out, stats, B, N, C, A, T, groups, scale, s);
  return launch_affinity<false, false>(x_map, wg_map, wt_map, bg, rel, mask, w_out,
                                       affi_out, stats, B, N, C, A, T, groups, scale, s);
}

// ---------------------------------------------------------------------------
// The wide form, for A > kAffMaxCluster * kAffBN (2048): the projection
// columns of a row no longer fit one cluster, so the l2n row norm cannot
// be summed over DSMEM.  No TPU kernel of its own: the Pallas kernel's
// block spans the whole row at any A.  Four launches (csrc/wide.cuh):
//  1. the projection, 64 x 64 tiles of x[s] @ Wg[group]: g = bf16(bf16(acc)
//     + bg) to a bf16 scratch [B*N, A] and, with L2N, each row's sum of
//     squares of its 64 rounded columns to a partial [B*N, A/64];
//  2. with L2N, per row: the partials added in order, g = bf16(g /
//     sqrt(max(sum, 1e-12))) in place (the plain version's rounding: the
//     norm in f32, then one bf16 rounding);
//  3. the word affinities, 64-row x 64-word tiles of g[s] @ wt[s]^T, times
//     rel / scale, to affi_out;
//  4. per 64-row block of a sample: each row's softmax over the words (a
//     warp per row) to w_out, and the block's column partials (max over its
//     rows, sum of exp(affi - max)) to stats in the main kernel's layout,
//     which the wrapper finalises as before.
// Bound on the card: operations (the projection, as the main kernel's).
// ---------------------------------------------------------------------------
#include "wide.cuh"

namespace cmpc {

template <bool L2N>
__global__ void __launch_bounds__(kWideThreads)
aff_wide_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                     const bf16* __restrict__ bg, bf16* __restrict__ gt,
                     float* __restrict__ sq_part, int N, int C, int A, int per_group) {
  __shared__ WideSmem sm;
  const int ct = blockIdx.x, row0 = blockIdx.y * kWideTile, s = blockIdx.z;
  const int c0 = ct * kWideTile, grp = s / per_group;
  const size_t srow = static_cast<size_t>(s) * N;
  const RowsLoad xa{x + srow * C, C, N, C, true};
  const RowsLoad wb{wg + static_cast<size_t>(grp) * C * A, A, C, A, true};
  wide_product<false>(sm, xa, wb, row0, c0, C);
#pragma unroll 4
  for (int i = 0; i < kWidePerThread; ++i) {
    const int e = threadIdx.x + i * kWideThreads, r = e / kWideTile, j = e % kWideTile;
    const int row = row0 + r, col = c0 + j;
    float g = 0.f;
    if (row < N && col < A) {
      g = round_bf(round_bf(sm.c[r][j]) + bf2f(bg[static_cast<size_t>(grp) * A + col]));
      gt[(srow + row) * A + col] = f2bf(g);
    }
    sm.c[r][j] = g * g;
  }
  if (!L2N) return;
  __syncthreads();
  if (threadIdx.x < kWideTile && row0 + threadIdx.x < N)
    sq_part[(srow + row0 + threadIdx.x) * gridDim.x + ct] = wide_row_sum(sm, threadIdx.x);
}

// A warp per row of g [rows, A]: its norm from the `tiles` partials.
__global__ void __launch_bounds__(256)
aff_wide_norm_kernel(bf16* __restrict__ gt, const float* __restrict__ sq_part, int rows,
                     int A, int tiles) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float t = 0.f;
  for (int j = 0; j < tiles; ++j) t += sq_part[static_cast<size_t>(row) * tiles + j];
  const float inv = 1.f / sqrtf(fmaxf(t, 1e-12f));
  bf16* p = gt + static_cast<size_t>(row) * A;
  for (int a = lane; a < A; a += 32) p[a] = f2bf(bf2f(p[a]) * inv);
}

__global__ void __launch_bounds__(kWideThreads)
aff_wide_words_kernel(const bf16* __restrict__ gt, const bf16* __restrict__ wt,
                      const float* __restrict__ rel, float* __restrict__ affi_out, int N,
                      int A, int T, float scale) {
  __shared__ WideSmem sm;
  const int t0 = blockIdx.x * kWideTile, row0 = blockIdx.y * kWideTile, s = blockIdx.z;
  const size_t srow = static_cast<size_t>(s) * N;
  const RowsLoad ga{gt + srow * A, A, N, A, true};
  const RowsLoad wb{wt + static_cast<size_t>(s) * T * A, A, T, A, true};   // [T][A]: B^T
  wide_product<true>(sm, ga, wb, row0, t0, A);
#pragma unroll 4
  for (int i = 0; i < kWidePerThread; ++i) {
    const int e = threadIdx.x + i * kWideThreads, r = e / kWideTile, j = e % kWideTile;
    const int row = row0 + r, t = t0 + j;
    if (row < N && t < T)
      affi_out[(srow + row) * T + t] = rel[static_cast<size_t>(s) * T + t] * (sm.c[r][j] / scale);
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(256)
aff_wide_softmax_kernel(const float* __restrict__ affi, const float* __restrict__ mask,
                        float* __restrict__ w_out, float* __restrict__ stats, int N, int T) {
  const int rb = blockIdx.x, s = blockIdx.y, row0 = rb * kWideTile;
  const int nrows = min(kWideTile, N - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* mk = mask + static_cast<size_t>(s) * T;
  const float* a0 = affi + (static_cast<size_t>(s) * N + row0) * T;
  float* w0 = w_out + (static_cast<size_t>(s) * N + row0) * T;
  auto logit = [&](const float* a, int t) {
    return MASKED ? mk[t] * a[t] + (1.f - mk[t]) * (-FLT_MAX) : a[t];
  };
  for (int r = warp; r < nrows; r += 8) {
    const float* a = a0 + static_cast<size_t>(r) * T;
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, logit(a, t));
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < T; t += 32) l += expf(logit(a, t) - m);
    const float inv_l = 1.f / warp_sum(l);
    for (int t = lane; t < T; t += 32)
      w0[static_cast<size_t>(r) * T + t] =
          MASKED ? expf(logit(a, t) - m) * inv_l : mk[t] * (expf(a[t] - m) * inv_l);
  }
  float* st = stats + (static_cast<size_t>(s) * gridDim.x + rb) * 2 * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float m = -INFINITY;
    for (int r = 0; r < nrows; ++r) m = fmaxf(m, a0[static_cast<size_t>(r) * T + t]);
    float l = 0.f;
    for (int r = 0; r < nrows; ++r) l += expf(a0[static_cast<size_t>(r) * T + t] - m);
    st[t] = m;
    st[T + t] = l;
  }
}

inline size_t aff_wide_g_bytes(int B, int N, int A) {
  return (static_cast<size_t>(B) * N * A * sizeof(bf16) + 15) / 16 * 16;
}

}  // namespace cmpc

extern "C" int cmpc_spa_affinity_wide_row_blocks(int N) { return cmpc::wide_tiles(N); }

// Bytes of the wide form's scratch: g [B*N, A] bf16, then the row norms'
// partials [B*N, A/64] f32.
extern "C" long long cmpc_spa_affinity_wide_scratch(int B, int N, int A) {
  using namespace cmpc;
  return static_cast<long long>(aff_wide_g_bytes(B, N, A) +
                                static_cast<size_t>(B) * N * wide_tiles(A) * sizeof(float));
}

// The contract of cmpc_spa_affinity for any A (a multiple of 8), with
// stats [B, cmpc_spa_affinity_wide_row_blocks(N), 2, T] and `scratch` of
// cmpc_spa_affinity_wide_scratch(B, N, A) bytes, 16-byte aligned.
extern "C" int cmpc_spa_affinity_wide(const void* x, const void* wg, const void* bg,
                                      const void* wt, const void* rel, const void* mask,
                                      void* w_out, void* affi_out, void* stats, void* scratch,
                                      int B, int N, int C, int A, int T, int groups,
                                      float scale, int l2n, int masked, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || T < 1 || groups < 1 || B % groups || C % 8 || A % 8 || A < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(wg) || !aligned16(wt) || !aligned16(scratch))
    return static_cast<int>(cudaErrorMisalignedAddress);
  bf16* gt = static_cast<bf16*>(scratch);
  float* sq_part = reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) +
                                            aff_wide_g_bytes(B, N, A));
  const dim3 proj(wide_tiles(A), wide_tiles(N), B);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wgb = static_cast<const bf16*>(wg);
  const auto* bgb = static_cast<const bf16*>(bg);
  if (l2n)
    aff_wide_proj_kernel<true><<<proj, kWideThreads, 0, s>>>(xb, wgb, bgb, gt, sq_part, N, C,
                                                             A, B / groups);
  else
    aff_wide_proj_kernel<false><<<proj, kWideThreads, 0, s>>>(xb, wgb, bgb, gt, sq_part, N, C,
                                                              A, B / groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l2n) {
    const int rows = B * N;
    aff_wide_norm_kernel<<<(rows + 7) / 8, 256, 0, s>>>(gt, sq_part, rows, A, wide_tiles(A));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  aff_wide_words_kernel<<<dim3(wide_tiles(T), wide_tiles(N), B), kWideThreads, 0, s>>>(
      gt, static_cast<const bf16*>(wt), static_cast<const float*>(rel),
      static_cast<float*>(affi_out), N, A, T, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 rows_grid(wide_tiles(N), B);
  if (masked)
    aff_wide_softmax_kernel<true><<<rows_grid, 256, 0, s>>>(
        static_cast<const float*>(affi_out), static_cast<const float*>(mask),
        static_cast<float*>(w_out), static_cast<float*>(stats), N, T);
  else
    aff_wide_softmax_kernel<false><<<rows_grid, 256, 0, s>>>(
        static_cast<const float*>(affi_out), static_cast<const float*>(mask),
        static_cast<float*>(w_out), static_cast<float*>(stats), N, T);
  return static_cast<int>(cudaGetLastError());
}
