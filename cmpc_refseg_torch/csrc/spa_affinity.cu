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
// Bound on the card: operations (the [B*N, C] x [C, A] projection, 25.6
// GFLOP at the flagship shapes, against ~27 MB of operands).  Design: one
// block owns 64 rows of one sample and ALL A projection columns: it runs
// the tensor-core tile product over A in 128-column slices, keeping the
// rounded [64, A] projection in shared memory (129 KB at A = 1000), so it
// never reaches device memory.  The word affinities [64, T] are a second
// tensor-core product against wt[s] staged in the (then free) stages of the
// first; one warp per row then forms the row softmax (lane = word) and an
// online column max / sum.  T <= 32.
#include "common.cuh"

namespace cmpc {

constexpr int kAffBM = 64;
constexpr int kAffBN = 128;
using AffTile = GemmTile<kAffBM, kAffBN>;
constexpr int kAffWarps = AffTile::kThreads / 32;
constexpr int kMaxT = 32;
constexpr int kAffOLd = kMaxT + 4;   // leading dim of the f32 affinity tile
static_assert(kAffWarps == (kAffBM / 16) * (kMaxT / 16), "one affinity tile per warp");

struct AffLayout {
  int a_pad;   // A rounded up to the projection slice width
  int g_ld;    // leading dim (bf16) of the projection and the staged wt
  size_t gs_off, ao_off, bytes;
  __host__ __device__ explicit AffLayout(int A) {
    a_pad = (A + kAffBN - 1) / kAffBN * kAffBN;
    g_ld = a_pad + 8;
    const size_t region = static_cast<size_t>(kMaxT) * g_ld * 2;
    gs_off = round128(region > AffTile::kSmemBytes ? region : AffTile::kSmemBytes);
    ao_off = round128(gs_off + static_cast<size_t>(kAffBM) * g_ld * 2);
    bytes = ao_off + static_cast<size_t>(kAffBM) * kAffOLd * 4;
  }
  __host__ __device__ static size_t round128(size_t v) { return (v + 127) / 128 * 128; }
};

template <bool L2N, bool MASKED>
__global__ void __launch_bounds__(AffTile::kThreads)
spa_affinity_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                    const bf16* __restrict__ bg, const bf16* __restrict__ wt,
                    const float* __restrict__ rel, const float* __restrict__ mask,
                    float* __restrict__ w_out, float* __restrict__ affi_out,
                    float* __restrict__ stats, int N, int C, int A, int T,
                    int per_group, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float warp_max_s[kAffWarps][kMaxT];
  __shared__ float warp_sum_s[kAffWarps][kMaxT];
  const AffLayout L(A);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.gs_off);    // [BM][g_ld] projection
  bf16* wts = reinterpret_cast<bf16*>(smem);              // [kMaxT][g_ld], after phase 1
  float* ao = reinterpret_cast<float*>(smem + L.ao_off);  // [BM][kAffOLd] affinities
  const float* cs = reinterpret_cast<const float*>(smem);
  const int s = blockIdx.y, rb = blockIdx.x;
  const int row0 = rb * kAffBM;
  const int nrows = min(kAffBM, N - row0);
  const size_t grow0 = static_cast<size_t>(s) * N + row0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = s / per_group;
  wg += static_cast<size_t>(grp) * C * A;
  bg += static_cast<size_t>(grp) * A;

  // 1. projection g = bf16(bf16(x @ Wg) + bg), zero in the pad columns
  const RowsA load_x{x + grow0 * C, C, C, nrows};
  for (int a0 = 0; a0 < L.a_pad; a0 += kAffBN) {
    tile_gemm<kAffBM, kAffBN>(load_x, wg, A, C, a0, A, smem);
    for (int e = threadIdx.x; e < kAffBM * kAffBN; e += AffTile::kThreads) {
      const int r = e / kAffBN, c = e % kAffBN, a = a0 + c;
      const float g = a < A ? round_bf(cs[r * AffTile::kCLd + c]) + bf2f(bg[a]) : 0.f;
      gs[r * L.g_ld + a] = f2bf(g);
    }
  }
  __syncthreads();

  // 2. stage wt[s] (zero past T and A); l2-normalize the projection rows
  const bf16* wt_s = wt + static_cast<size_t>(s) * T * A;
  for (int v = threadIdx.x; v < kMaxT * (L.a_pad / 8); v += AffTile::kThreads) {
    const int t = v / (L.a_pad / 8), a = (v % (L.a_pad / 8)) * 8;
    const uint4 val = (t < T && a < A)
                          ? *reinterpret_cast<const uint4*>(wt_s + static_cast<size_t>(t) * A + a)
                          : zero_vec();
    *reinterpret_cast<uint4*>(wts + t * L.g_ld + a) = val;
  }
  if (L2N) {
    for (int r = warp; r < nrows; r += kAffWarps) {
      bf16* g = gs + r * L.g_ld;
      float sq = 0.f;
      for (int a = lane; a < A; a += 32) {
        const float v = bf2f(g[a]);
        sq += v * v;
      }
      const float inv = rsqrtf(fmaxf(warp_sum(sq), 1e-12f));
      for (int a = lane; a < A; a += 32) g[a] = f2bf(bf2f(g[a]) * inv);
    }
  }
  __syncthreads();

  // 3. affinities [BM, kMaxT] = g @ wt^T on the tensor cores, one 16x16
  //    output tile per warp
  {
    const int tr = warp / (kMaxT / 16), tc = warp % (kMaxT / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < L.a_pad; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, gs + tr * 16 * L.g_ld + k, L.g_ld);
      wmma::load_matrix_sync(fb, wts + tc * 16 * L.g_ld + k, L.g_ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(ao + tr * 16 * kAffOLd + tc * 16, acc, kAffOLd,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 4. relation scale, row softmax over the words, column statistics
  const bool word = lane < T;
  const float m_lane = word ? mask[s * T + lane] : 0.f;
  const float r_lane = word ? rel[s * T + lane] : 0.f;
  float col_max = -INFINITY, col_sum = 0.f;
  for (int r = warp; r < nrows; r += kAffWarps) {
    const float affi = r_lane * (ao[r * kAffOLd + lane] / scale);
    const float z = MASKED ? m_lane * affi + (1.f - m_lane) * (-FLT_MAX) : affi;
    const float zmax = warp_max(word ? z : -INFINITY);
    const float ez = word ? expf(z - zmax) : 0.f;
    float wv = ez / warp_sum(ez);
    if (!MASKED) wv *= m_lane;
    if (word) {
      const size_t o = (grow0 + r) * T + lane;
      w_out[o] = wv;
      affi_out[o] = affi;
      const float nm = fmaxf(col_max, affi);
      col_sum = col_sum * expf(col_max - nm) + expf(affi - nm);
      col_max = nm;
    }
  }

  warp_max_s[warp][lane] = col_max;
  warp_sum_s[warp][lane] = col_sum;
  __syncthreads();
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    float m = -INFINITY;
    for (int w = 0; w < kAffWarps; ++w) m = fmaxf(m, warp_max_s[w][t]);
    float sum = 0.f;
    for (int w = 0; w < kAffWarps; ++w)
      if (warp_sum_s[w][t] > 0.f) sum += warp_sum_s[w][t] * expf(warp_max_s[w][t] - m);
    float* st = stats + (static_cast<size_t>(s) * gridDim.x + rb) * 2 * T;
    st[t] = m;
    st[T + t] = sum;
  }
}

template <bool L2N, bool MASKED>
int launch_affinity(const void* x, const void* wg, const void* bg, const void* wt,
                    const void* rel, const void* mask, void* w_out, void* affi_out,
                    void* stats, int B, int N, int C, int A, int T, int groups,
                    float scale, cudaStream_t s) {
  const size_t bytes = AffLayout(A).bytes;
  auto kernel = spa_affinity_kernel<L2N, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kAffBM - 1) / kAffBM, B);
  kernel<<<grid, AffTile::kThreads, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(bg), static_cast<const bf16*>(wt),
      static_cast<const float*>(rel), static_cast<const float*>(mask),
      static_cast<float*>(w_out), static_cast<float*>(affi_out),
      static_cast<float*>(stats), N, C, A, T, B / groups, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cmpc

extern "C" int cmpc_spa_affinity_row_blocks(int N) {
  return (N + cmpc::kAffBM - 1) / cmpc::kAffBM;
}

// x [B*N, C], wg [G, C, A], bg [G, A], wt [B, T, A] bf16; rel, mask [B, T]
// f32 -> w_out, affi_out [B*N, T] f32 and stats [B, row_blocks, 2, T] f32
// (per-block column max, then sum of exp(affi - max)).  G divides B;
// sample s uses weight group s / (B / G).
extern "C" int cmpc_spa_affinity(const void* x, const void* wg, const void* bg,
                                 const void* wt, const void* rel, const void* mask,
                                 void* w_out, void* affi_out, void* stats, int B,
                                 int N, int C, int A, int T, int groups, float scale,
                                 int l2n, int masked, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T > kMaxT || groups < 1 || B % groups) return static_cast<int>(cudaErrorInvalidValue);
  if (l2n && masked)
    return launch_affinity<true, true>(x, wg, bg, wt, rel, mask, w_out, affi_out,
                                       stats, B, N, C, A, T, groups, scale, s);
  if (l2n)
    return launch_affinity<true, false>(x, wg, bg, wt, rel, mask, w_out, affi_out,
                                        stats, B, N, C, A, T, groups, scale, s);
  if (masked)
    return launch_affinity<false, true>(x, wg, bg, wt, rel, mask, w_out, affi_out,
                                        stats, B, N, C, A, T, groups, scale, s);
  return launch_affinity<false, false>(x, wg, bg, wt, rel, mask, w_out, affi_out,
                                       stats, B, N, C, A, T, groups, scale, s);
}
