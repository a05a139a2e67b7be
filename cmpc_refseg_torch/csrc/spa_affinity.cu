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

// The tensor maps of both forms: x [B][N][C] and, with `g`, the wide form's
// scratch g [B][N][A] innermost first (a row tile's boxes read zero past
// its sample, and its stores stop there), wg [G][C][A], boxes of 64 x 64;
// wt [B][T][A], boxes of 64 columns x 32 words.
inline int affinity_maps(CUtensorMap* x_map, CUtensorMap* wg_map, CUtensorMap* wt_map,
                         CUtensorMap* g_map, const void* x, const void* wg, const void* wt,
                         const void* g, int B, int N, int C, int A, int T, int groups) {
  const uint64_t bf = sizeof(bf16);
  const uint32_t box[3] = {kChunk, 64, 1};
  const uint64_t x_dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(N),
                              static_cast<uint64_t>(B)};
  const uint64_t x_strides[2] = {C * bf, static_cast<uint64_t>(N) * C * bf};
  int rc = encode_tmap(x_map, x, 3, x_dims, x_strides, box);
  if (rc) return rc;
  const uint64_t wg_dims[3] = {static_cast<uint64_t>(A), static_cast<uint64_t>(C),
                               static_cast<uint64_t>(groups)};
  const uint64_t wg_strides[2] = {A * bf, static_cast<uint64_t>(C) * A * bf};
  rc = encode_tmap(wg_map, wg, 3, wg_dims, wg_strides, box);
  if (rc) return rc;
  const uint64_t wt_dims[3] = {static_cast<uint64_t>(A), static_cast<uint64_t>(T),
                               static_cast<uint64_t>(B)};
  const uint64_t wt_strides[2] = {A * bf, static_cast<uint64_t>(T) * A * bf};
  const uint32_t wt_box[3] = {kChunk, kAffWords, 1};
  rc = encode_tmap(wt_map, wt, 3, wt_dims, wt_strides, wt_box);
  if (rc || g == nullptr) return rc;
  const uint64_t g_dims[3] = {static_cast<uint64_t>(A), static_cast<uint64_t>(N),
                              static_cast<uint64_t>(B)};
  const uint64_t g_strides[2] = {A * bf, static_cast<uint64_t>(N) * A * bf};
  return encode_tmap(g_map, g, 3, g_dims, g_strides, box);
}

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
  CUtensorMap x_map, wg_map, wt_map;
  const int rc =
      affinity_maps(&x_map, &wg_map, &wt_map, nullptr, x, wg, wt, nullptr, B, N, C, A, T, groups);
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
// The wide form, for A > kAffMaxCluster * kAffBN (2048): a row's projection
// columns no longer fit one cluster, so the l2n row norm cannot be summed
// over DSMEM and g cannot stay in registers.  No TPU kernel of its own: the
// Pallas kernel's block spans the whole row at any A.  Two launches:
//  1. aff_wide_tma_proj_kernel, the main kernel's projection without a
//     cluster: a block owns 128 rows of one sample x 256 columns of A; a
//     producer warp keeps a 4-stage TMA ring of the x tile and the Wg
//     boxes full, two consumer warpgroups run m64n256k16 wgmmas.  The
//     epilogue writes g = bf16(bf16(acc) + bg) to a bf16 scratch [B][N][A]
//     by TMA stores (staged swizzled in the freed ring) and, with L2N, each
//     row's sum of squares of its 256 rounded columns to a partial [B*N,
//     ceil(A / 256)] (a quad shuffle: no atomics).
//  2. aff_wide_tma_words_kernel, per 64-row tile of a sample: the row norms
//     from the partials, added in order; then g streamed by TMA in 64-column
//     boxes beside wt[s]'s [32 words x 64] boxes through a 6-stage ring.
//     Four consumer warps of 16 rows read their A fragments by ldmatrix,
//     apply the norm and round to bf16 there (the plain version's rounding:
//     the norm in f32, one bf16 rounding), so g is never rewritten, and run
//     the word product as mma.sync m16n8k16, 32 words at a time (g
//     streamed again for each further 32 words).  From the fragment: affi =
//     rel * (raw / scale) to affi_out, the row softmax (max and sum over a
//     row's 4 lanes, online across word chunks; the earlier chunks' words
//     re-read at the end) to w_out, and the tile's column partials (max over
//     its rows, sum of exp(affi - max); over the warp's lanes, then the 4
//     warps in order) to stats in the main kernel's layout, which the
//     wrapper finalises as before.
// Bound on the card: operations (the projection, as the main kernel's).  g
// crosses device memory twice (written, read once per 32 words): 2 x B*N*A
// bf16, 157 MB at B*N = 9600 and A = 4104, ~47 us at 3.35 TB/s beside the
// projection's ~330 us.
// ---------------------------------------------------------------------------

namespace cmpc {

constexpr int kAwRows = 64;                            // rows per words block
constexpr int kAwWarps = kAwRows / 16;                 // consumer warps
constexpr int kAwThreads = 32 * (kAwWarps + 1);        // + the producer warp
constexpr int kAwStages = 6;
constexpr int kAwGBox = kAwRows * kSwizzleBytes;       // g [64 rows][64 columns]
constexpr int kAwWtBox = kAffWords * kSwizzleBytes;    // wt [32 words][64 columns]
constexpr int kAwStage = kAwGBox + kAwWtBox;
constexpr int kAwSmem = 1024 + kAwStages * kAwStage;
constexpr int kAwProjSmem = 1024 + kAffStages * kAffStage;
static_assert(kAwStage % 1024 == 0 && kAwGBox % 1024 == 0, "swizzle atoms stay aligned");

// blockIdx.x: the 256-column slice of A, y: the 128-row tile of sample z.
// Warps 0-7: the consumer warpgroups; lane 0 of warp 8 the producer.
template <bool L2N>
__global__ void __launch_bounds__(kAffThreads, 1)
aff_wide_tma_proj_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap wg_map,
                         const __grid_constant__ CUtensorMap g_map,
                         const bf16* __restrict__ bg, float* __restrict__ sq_part, int N,
                         int C, int A, int per_group) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kAffStages], empty[kAffStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int ct = blockIdx.x, rb = blockIdx.y, s = blockIdx.z;
  const int a0 = ct * kAffBN, row0 = rb * kAffBM;
  const int grp = s / per_group;
  const int ktiles = (C + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int q = 0; q < kAffStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], 2);   // both consumer warpgroups
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer: stage it % kAffStages gets K step it
    if (lane == 0) {
      tma_prefetch(&x_map);
      tma_prefetch(&wg_map);
      for (int it = 0; it < ktiles; ++it) {
        const int q = it % kAffStages;
        if (it >= kAffStages) mbar_wait(&empty[q], ((it / kAffStages) - 1) & 1);
        unsigned char* st = smem + q * kAffStage;
        const int k0 = it * kTileK;
        mbar_arrive_expect_tx(&full[q], kAffStage);
#pragma unroll
        for (int b = 0; b < kAffBM / 64; ++b)
          tma_load_3d(st + b * kAffBox, &x_map, &full[q], k0, row0 + 64 * b, s);
#pragma unroll
        for (int j = 0; j < kAffBN / kChunk; ++j)
          tma_load_3d(st + kAffXBytes + j * kAffBox, &wg_map, &full[q], a0 + j * kChunk, k0,
                      grp);
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const uint32_t base = smem_u32(smem);
  constexpr uint32_t kStepB = (16 * kSwizzleBytes) >> 4;   // 16 rows of K
  float acc[kAffBN / 2];
  for (int it = 0; it < ktiles; ++it) {
    const int q = it % kAffStages;
    mbar_wait(&full[q], (it / kAffStages) & 1);
    const uint32_t a = base + q * kAffStage + wg * kAffBox;
    const uint32_t b = base + q * kAffStage + kAffXBytes;
    wgmma_fence();
    mma_stage<kAffBN, 0, 1>(acc, sw128_desc(a, 16, 1024), sw128_desc(b, kAffBox, 1024), 2,
                            kStepB, it == 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0 && wtid == 0) mbar_arrive(&empty[(it - 1) % kAffStages]);   // stage it - 1 is read
  }
  wgmma_wait<0>();
  fence_regs(acc);
  named_bar_sync(1, 256);   // both warpgroups are done reading the ring

  // g = bf16(bf16(acc) + bg), zero past A: register 4 j + 2 hf + e holds
  // row r_lo + 8 hf, column a0 + 8 j + 2 (lane % 4) + e.  g goes through
  // the ring as four [128 x 64] swizzled sub-tiles, written by TMA stores
  // (rows past N and columns past A clipped).
  const int r_lo = wg * 64 + wl * 16 + lane / 4;
  const int col_t = a0 + 2 * (lane % 4);
  const bf16* bgg = bg + static_cast<size_t>(grp) * A;
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r_lo + 8 * hf;
    unsigned char* grow = smem + r * kSwizzleBytes + 4 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kAffBN / 8; ++j) {
      const int col = col_t + 8 * j;
      const float2 bb = ld_bf2(bgg + min(col, A - 2));
      const float g0 = col < A ? round_bf(round_bf(acc[4 * j + 2 * hf]) + bb.x) : 0.f;
      const float g1 = col < A ? round_bf(round_bf(acc[4 * j + 2 * hf + 1]) + bb.y) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(grow + (j / 8) * kAffXBytes +
                                         (((j % 8) ^ (r % 8)) << 4)) =
          __floats2bfloat162_rn(g0, g1);
      sq[hf] += g0 * g0 + g1 * g1;
    }
  }
  fence_proxy_async();
  named_bar_sync(2 + wg, 128);
  if (wtid == 0 && row0 + 64 * wg < N) {
    for (int j = 0; j < kAffBN / kChunk && a0 + j * kChunk < A; ++j)
      tma_store_3d(&g_map, smem + j * kAffXBytes + wg * kAffBox, a0 + j * kChunk,
                   row0 + 64 * wg, s);
    bulk_commit();
  }
  if (L2N) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = sq[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = row0 + r_lo + 8 * hf;
      if (lane % 4 == 0 && row < N)
        sq_part[(static_cast<size_t>(s) * N + row) * gridDim.x + ct] = v;
    }
  }
  if (wtid == 0) bulk_wait_read();   // the stores have read shared memory
}

// blockIdx.x: the 64-row tile of sample y.  Warps 0-3 consume (warp w:
// rows 16 w ... + 15 of the tile), lane 0 of warp 4 produces: step it =
// tc * atiles + kt loads g's columns 64 kt ... (rows past N and columns
// past A zero) and wt[s]'s words 32 tc ... of those columns (zero past T).
template <bool L2N, bool MASKED>
__global__ void __launch_bounds__(kAwThreads)
aff_wide_tma_words_kernel(const __grid_constant__ CUtensorMap g_map,
                          const __grid_constant__ CUtensorMap wt_map,
                          const float* __restrict__ sq_part, int parts,
                          const float* __restrict__ rel, const float* __restrict__ mask,
                          float* __restrict__ w_out, float* __restrict__ affi_out,
                          float* __restrict__ stats, int N, int A, int T, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kAwStages], empty[kAwStages];
  __shared__ float col_s[kAwWarps][kAffWords][2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int rb = blockIdx.x, s = blockIdx.y, row0 = rb * kAwRows;
  const int atiles = (A + kChunk - 1) / kChunk;
  const int tchunks = (T + kAffWords - 1) / kAffWords;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int q = 0; q < kAwStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kAwWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kAwWarps) {   // the producer
    if (lane == 0) {
      tma_prefetch(&g_map);
      tma_prefetch(&wt_map);
      for (int it = 0; it < tchunks * atiles; ++it) {
        const int q = it % kAwStages, tc = it / atiles, kt = it % atiles;
        if (it >= kAwStages) mbar_wait(&empty[q], ((it / kAwStages) - 1) & 1);
        unsigned char* st = smem + q * kAwStage;
        mbar_arrive_expect_tx(&full[q], kAwStage);
        tma_load_3d(st, &g_map, &full[q], kt * kChunk, row0, s);
        tma_load_3d(st + kAwGBox, &wt_map, &full[q], kt * kChunk, tc * kAffWords, s);
      }
    }
    return;
  }

  // Lane (gq, c) = (lane / 4, lane % 4) holds rows r[0] = row0 + 16 warp +
  // gq and r[1] = r[0] + 8, words 8 nt + 2c + e of each chunk (nt < 4, e <
  // 2): acc[nt][2 hf + e] is row r[hf].
  const int gq = lane / 4, c = lane % 4;
  const int rows[2] = {row0 + 16 * warp + gq, row0 + 16 * warp + gq + 8};
  float inv[2] = {1.f, 1.f};
  if (L2N) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (rows[hf] >= N) continue;
      const float* p = sq_part + (static_cast<size_t>(s) * N + rows[hf]) * parts;
      float t = 0.f;
      for (int j = 0; j < parts; ++j) t += p[j];
      inv[hf] = 1.f / sqrtf(fmaxf(t, 1e-12f));
    }
  }
  // ldmatrix addresses (128-byte swizzle: 16-byte group q of row r at q ^
  // (r % 8), and r % 8 = lane % 8 here).  A: lane l gives row 16 warp + 8
  // ((l / 8) % 2) + l % 8 of group 2 kk + l / 16; B: word 8 (l / 16) + l % 8
  // (+ 16 for the second pair of n8 tiles) of group 2 kk + (l / 8) % 2.
  const uint32_t a_row = (16 * warp + 8 * ((lane / 8) % 2) + lane % 8) * kSwizzleBytes;
  const uint32_t b_row = (8 * (lane / 16) + lane % 8) * kSwizzleBytes;
  const int a_grp = lane / 16, b_grp = (lane / 8) % 2, sw = lane % 8;
  auto scaled = [&](uint32_t v, float f) {   // a bf16 pair times f, rounded to bf16
    const float2 x = __bfloat1622float2(bits_bf2(v));
    return bf2_bits(__floats2bfloat162_rn(x.x * f, x.y * f));
  };
  const float* rel_s = rel + static_cast<size_t>(s) * T;
  const float* mask_s = mask + static_cast<size_t>(s) * T;
  float row_m[2] = {-INFINITY, -INFINITY}, row_l[2] = {0.f, 0.f};
  int it = 0;
  for (int tc = 0; tc < tchunks; ++tc) {
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int kt = 0; kt < atiles; ++kt, ++it) {
      const int q = it % kAwStages;
      mbar_wait(&full[q], (it / kAwStages) & 1);
      const uint32_t ga = smem_u32(smem + q * kAwStage);
      const uint32_t wb = ga + kAwGBox;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, ga + a_row + (((2 * kk + a_grp) ^ sw) << 4));
        if (L2N) {
          a[0] = scaled(a[0], inv[0]);
          a[1] = scaled(a[1], inv[1]);
          a[2] = scaled(a[2], inv[0]);
          a[3] = scaled(a[3], inv[1]);
        }
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          uint32_t b[4];
          ldmatrix_x4(b, wb + b_row + pr * 16 * kSwizzleBytes + (((2 * kk + b_grp) ^ sw) << 4));
          mma_m16n8k16(acc[2 * pr], a, b[0], b[1]);
          mma_m16n8k16(acc[2 * pr + 1], a, b[2], b[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[q]);   // this warp is done with the stage
    }

    // affi, the row softmax's running (max, sum) and the column partials
    // of this chunk's words, from the fragment
    const bool last = tc + 1 == tchunks;
    float affi[2][8], z[2][8], rl[8], mk[8];
    bool word[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = tc * kAffWords + 8 * (i / 2) + 2 * c + i % 2;
      word[i] = t < T;
      rl[i] = word[i] ? rel_s[t] : 0.f;
      mk[i] = word[i] ? mask_s[t] : 0.f;
    }
    float m_old[2], m_new[2], l_new[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        affi[hf][i] = rl[i] * (acc[i / 2][2 * hf + i % 2] / scale);
        z[hf][i] = MASKED ? mk[i] * affi[hf][i] + (1.f - mk[i]) * (-FLT_MAX) : affi[hf][i];
        if (word[i]) mx = fmaxf(mx, z[hf][i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_old[hf] = row_m[hf];
      m_new[hf] = fmaxf(m_old[hf], mx);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        z[hf][i] = word[i] ? expf(z[hf][i] - m_new[hf]) : 0.f;   // now e
        l += z[hf][i];
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_new[hf] = l + row_l[hf] * expf(m_old[hf] - m_new[hf]);
      row_m[hf] = m_new[hf];
      row_l[hf] = l_new[hf];
      if (rows[hf] < N) {
        const size_t o = (static_cast<size_t>(s) * N + rows[hf]) * T + tc * kAffWords + 2 * c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!word[i]) continue;
          const size_t oi = o + 8 * (i / 2) + i % 2;
          affi_out[oi] = affi[hf][i];
          if (last)
            w_out[oi] = MASKED ? z[hf][i] / l_new[hf] : mk[i] * (z[hf][i] / l_new[hf]);
        }
      }
    }
    // the column partials: over the warp's 16 rows (lanes of equal c), then
    // over the 4 warps in order by warp 0
    float cm[8], cs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (rows[hf] < N) m = fmaxf(m, affi[hf][i]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (rows[hf] < N) sum += expf(affi[hf][i] - m);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      cm[i] = m;
      cs[i] = sum;
    }
    if (gq == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        col_s[warp][8 * (i / 2) + 2 * c + i % 2][0] = cm[i];
        col_s[warp][8 * (i / 2) + 2 * c + i % 2][1] = cs[i];
      }
    }
    named_bar_sync(1, 32 * kAwWarps);
    const int t = tc * kAffWords + lane;
    if (warp == 0 && t < T) {
      float m = -INFINITY;
      for (int w = 0; w < kAwWarps; ++w) m = fmaxf(m, col_s[w][lane][0]);
      float sum = 0.f;
      for (int w = 0; w < kAwWarps; ++w)
        if (col_s[w][lane][1] > 0.f) sum += col_s[w][lane][1] * expf(col_s[w][lane][0] - m);
      float* st = stats + (static_cast<size_t>(s) * gridDim.x + rb) * 2 * T;
      st[t] = m;
      st[T + t] = sum;
    }
    named_bar_sync(1, 32 * kAwWarps);   // col_s is free for the next chunk
  }

  // the row softmax of the earlier chunks' words, from the affi this
  // thread stored
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (rows[hf] >= N) continue;
    const float inv_l = 1.f / row_l[hf];
    const size_t o = (static_cast<size_t>(s) * N + rows[hf]) * T;
    for (int tc = 0; tc + 1 < tchunks; ++tc)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tc * kAffWords + 8 * (i / 2) + 2 * c + i % 2;
        const float a = affi_out[o + t];
        const float mk = mask_s[t];
        w_out[o + t] = MASKED ? expf(mk * a + (1.f - mk) * (-FLT_MAX) - row_m[hf]) * inv_l
                              : mk * (expf(a - row_m[hf]) * inv_l);
      }
  }
}

inline size_t aff_wide_g_bytes(int B, int N, int A) {
  return (static_cast<size_t>(B) * N * A * sizeof(bf16) + 15) / 16 * 16;
}

template <bool L2N, bool MASKED>
int launch_affinity_wide(const CUtensorMap& x_map, const CUtensorMap& wg_map,
                         const CUtensorMap& g_map, const CUtensorMap& wt_map, const void* bg,
                         const void* rel, const void* mask, void* w_out, void* affi_out,
                         void* stats, float* sq_part, int B, int N, int C, int A, int T,
                         int groups, float scale, cudaStream_t s) {
  const auto proj = aff_wide_tma_proj_kernel<L2N>;
  const auto words = aff_wide_tma_words_kernel<L2N, MASKED>;
  cudaError_t err =
      cudaFuncSetAttribute(proj, cudaFuncAttributeMaxDynamicSharedMemorySize, kAwProjSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(words, cudaFuncAttributeMaxDynamicSharedMemorySize, kAwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (A + kAffBN - 1) / kAffBN;
  proj<<<dim3(slices, (N + kAffBM - 1) / kAffBM, B), kAffThreads, kAwProjSmem, s>>>(
      x_map, wg_map, g_map, static_cast<const bf16*>(bg), sq_part, N, C, A, B / groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  words<<<dim3((N + kAwRows - 1) / kAwRows, B), kAwThreads, kAwSmem, s>>>(
      g_map, wt_map, sq_part, slices, static_cast<const float*>(rel),
      static_cast<const float*>(mask), static_cast<float*>(w_out), static_cast<float*>(affi_out),
      static_cast<float*>(stats), N, A, T, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cmpc

extern "C" int cmpc_spa_affinity_wide_row_blocks(int N) {
  return (N + cmpc::kAwRows - 1) / cmpc::kAwRows;
}

// Bytes of the wide form's scratch: g [B*N, A] bf16, then the row norms'
// partials [B*N, ceil(A / 256)] f32.
extern "C" long long cmpc_spa_affinity_wide_scratch(int B, int N, int A) {
  using namespace cmpc;
  return static_cast<long long>(aff_wide_g_bytes(B, N, A) + static_cast<size_t>(B) * N *
                                                                ((A + kAffBN - 1) / kAffBN) *
                                                                sizeof(float));
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
  CUtensorMap x_map, wg_map, wt_map, g_map;
  const int rc =
      affinity_maps(&x_map, &wg_map, &wt_map, &g_map, x, wg, wt, scratch, B, N, C, A, T, groups);
  if (rc) return rc;
  float* sq_part = reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) +
                                            aff_wide_g_bytes(B, N, A));
  if (l2n && masked)
    return launch_affinity_wide<true, true>(x_map, wg_map, g_map, wt_map, bg, rel, mask, w_out,
                                            affi_out, stats, sq_part, B, N, C, A, T, groups,
                                            scale, s);
  if (l2n)
    return launch_affinity_wide<true, false>(x_map, wg_map, g_map, wt_map, bg, rel, mask,
                                             w_out, affi_out, stats, sq_part, B, N, C, A, T,
                                             groups, scale, s);
  if (masked)
    return launch_affinity_wide<false, true>(x_map, wg_map, g_map, wt_map, bg, rel, mask,
                                             w_out, affi_out, stats, sq_part, B, N, C, A, T,
                                             groups, scale, s);
  return launch_affinity_wide<false, false>(x_map, wg_map, g_map, wt_map, bg, rel, mask, w_out,
                                            affi_out, stats, sq_part, B, N, C, A, T, groups,
                                            scale, s);
}
