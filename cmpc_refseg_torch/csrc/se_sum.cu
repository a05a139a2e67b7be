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
// products).  Design:
// the row l2norm needs whole rows, so one block owns 64 rows and all C
// columns.  It keeps the running sum for those rows in shared memory in
// bf16 (the TPU kernel's rounding), runs the tensor-core tile product of
// common.cuh over each other's [64, C] x [C, C] in 128-column slices, and
// folds each slice's epilogue into the sum, so the per-other products
// never reach device memory.  C = 500 is not a multiple of 8: rows are
// 1000 bytes apart, so every load is 8 bytes (VEC = 4) with masked tails.
#include "common.cuh"

namespace cmpc {

constexpr int kSeBM = 64;
constexpr int kSeBN = 128;
constexpr int kSeMaxOthers = 4;
using SeTile = GemmTile<kSeBM, kSeBN>;

struct SeOthers {
  const bf16* o[kSeMaxOthers];   // [M, C]
  const bf16* w[kSeMaxOthers];   // [C, C]
  const bf16* b[kSeMaxOthers];   // [C]
  const bf16* g[kSeMaxOthers];   // [B, C]
};

// Shared memory: the tile product's stages, then the running sum [BM][c_pad].
__host__ __device__ inline size_t se_acc_offset() {
  return (static_cast<size_t>(SeTile::kSmemBytes) + 127) / 128 * 128;
}
__host__ __device__ inline int se_c_pad(int C) { return (C + kSeBN - 1) / kSeBN * kSeBN; }

__global__ void __launch_bounds__(SeTile::kThreads)
se_sum_kernel(const bf16* __restrict__ feat, SeOthers others, int k,
              bf16* __restrict__ out, int M, int N, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c_pad = se_c_pad(C);
  bf16* acc = reinterpret_cast<bf16*>(smem + se_acc_offset());
  const float* cs = reinterpret_cast<const float*>(smem);
  const int row0 = blockIdx.x * kSeBM;
  const int nrows = min(kSeBM, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = SeTile::kThreads / 32;

  // acc = feat (bf16 pairs: rows are 4-byte aligned since C is even)
  for (int r = warp; r < nrows; r += kWarps) {
    const __nv_bfloat162* f2 =
        reinterpret_cast<const __nv_bfloat162*>(feat + static_cast<size_t>(row0 + r) * C);
    __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(acc + r * c_pad);
    for (int cp = lane; cp < C / 2; cp += 32) a2[cp] = f2[cp];
  }

  for (int i = 0; i < k; ++i) {
    const RowsAT<4> load_o{others.o[i] + static_cast<size_t>(row0) * C, C, C, nrows};
    for (int c0 = 0; c0 < C; c0 += kSeBN) {
      // tile_gemm opens with a barrier, so acc's previous updates are visible
      tile_gemm<kSeBM, kSeBN, 4>(load_o, others.w[i], C, C, c0, C, smem);
      for (int e = threadIdx.x; e < kSeBM * kSeBN; e += SeTile::kThreads) {
        const int r = e / kSeBN, c = e % kSeBN, col = c0 + c;
        if (r < nrows && col < C) {
          const int s = (row0 + r) / N;
          const float t = round_bf(round_bf(cs[r * SeTile::kCLd + c]) + bf2f(others.b[i][col]));
          const float u = round_bf(fmaxf(t, 0.f) * bf2f(others.g[i][static_cast<size_t>(s) * C + col]));
          acc[r * c_pad + col] = f2bf(bf2f(acc[r * c_pad + col]) + u);
        }
      }
    }
  }
  __syncthreads();

  // row l2norm in f32, one warp per row
  for (int r = warp; r < nrows; r += kWarps) {
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(acc + r * c_pad);
    float sq = 0.f;
    for (int cp = lane; cp < C / 2; cp += 32) {
      const float2 v = __bfloat1622float2(a2[cp]);
      sq += v.x * v.x + v.y * v.y;
    }
    const float inv = rsqrtf(fmaxf(warp_sum(sq), 1e-12f));
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0 + r) * C);
    for (int cp = lane; cp < C / 2; cp += 32) {
      const float2 v = __bfloat1622float2(a2[cp]);
      o2[cp] = __floats2bfloat162_rn(v.x * inv, v.y * inv);
    }
  }
}

}  // namespace cmpc

// feat [M, C] bf16 (M = B*N rows, row r of sample r / N); others[i] [M, C],
// ws[i] [C, C], bs[i] [C], gates[i] [B, C] bf16 for i < k <= 4 (host arrays
// of device pointers) -> out [M, C] bf16.  C must be a multiple of 4.
extern "C" int cmpc_se_sum(const void* feat, const void* const* others,
                           const void* const* ws, const void* const* bs,
                           const void* const* gates, int k, void* out, int M, int N,
                           int C, void* stream) {
  using namespace cmpc;
  if (k < 1 || k > kSeMaxOthers || C % 4) return static_cast<int>(cudaErrorInvalidValue);
  SeOthers args{};
  for (int i = 0; i < k; ++i) {
    args.o[i] = static_cast<const bf16*>(others[i]);
    args.w[i] = static_cast<const bf16*>(ws[i]);
    args.b[i] = static_cast<const bf16*>(bs[i]);
    args.g[i] = static_cast<const bf16*>(gates[i]);
  }
  const size_t bytes = se_acc_offset() + static_cast<size_t>(kSeBM) * se_c_pad(C) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      se_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kSeBM - 1) / kSeBM;
  se_sum_kernel<<<blocks, SeTile::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(feat), args, k, static_cast<bf16*>(out), M, N, C);
  return static_cast<int>(cudaGetLastError());
}
