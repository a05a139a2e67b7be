// Mutan bilinear fusion: out = l2norm_row(tanh(sum_h tanh(x @ W_h + b_h) * lang_h))
//
// Replaces cmpc_refseg_tpu/ops/pallas_kernels.py::mutan_fused_padded and
// ::_mutan_fused_fwd (the same function; the port needs no lane padding),
// and, with a residual buffer, ::_mutan_fwd_with_residual: the training
// forward that also writes v = tanh(x @ W + b) [rows, heads*C] in bf16 for
// the backward (csrc/mutan_bwd.cu).  That is one extra bf16 store per head
// epilogue element; out is computed from the f32 v as without it.
//
// Bound on the card: operations.  At the flagship shapes (x [8*1600, 1008],
// W [1008, 5*1000]) the product is 129 GFLOP against ~60 MB of operands.
// Design: one block owns a [128 rows x 64 columns] tile of the output and
// loops over the 5 heads, each a tensor-core tile product over all of K; the
// head epilogue tanh(part + b_h) * lang_h accumulates in shared memory, so
// the [rows, 5*C] tanh intermediate never reaches device memory.  The row l2norm
// needs all C columns, which span 16 blocks: each block writes tanh(acc) in
// f32 plus its per-row sum of squares, and a second small pass scales and
// rounds to bf16 (an [rows, C] f32 round trip, ~1/50 of the product's time).
// Not yet done: TMA / wgmma pipelining and a resident-W persistent schedule.
#include "common.cuh"

namespace cmpc {

constexpr int kMutBM = 128;
constexpr int kMutBN = 64;
using MutTile = GemmTile<kMutBM, kMutBN>;
constexpr int kMutPer = kMutBM * kMutBN / MutTile::kThreads;
// The tile product's stages, then the head-sum accumulators: kept in shared
// memory rather than registers so that three blocks fit on an SM.
constexpr int kMutSmem = MutTile::kSmemBytes + kMutBM * kMutBN * 4;

// kResidual: also store v = tanh(x @ W_h + b_h) in bf16, row-major [M, heads*C].
template <bool kResidual>
__global__ void __launch_bounds__(MutTile::kThreads, 3)
mutan_heads_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ lang,
                   float* __restrict__ y, float* __restrict__ rowsq,
                   bf16* __restrict__ v, int M, int K, int C, int N, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float half_sq[kMutBM][2];
  float* acc = reinterpret_cast<float*>(smem + MutTile::kSmemBytes);
  const int ct = blockIdx.x;
  const int row0 = blockIdx.y * kMutBM;
  const int c0 = ct * kMutBN;
  const int nrows = min(kMutBM, M - row0);
  const int ldw = heads * C;
  const float* cs = reinterpret_cast<const float*>(smem);
  const RowsA load_x{x + static_cast<size_t>(row0) * K, K, K, nrows};

  // Each thread owns the same kMutPer elements in every pass below, so the
  // accumulators need no barrier of their own.
#pragma unroll 4
  for (int i = 0; i < kMutPer; ++i) acc[threadIdx.x + i * MutTile::kThreads] = 0.f;

  for (int h = 0; h < heads; ++h) {
    tile_gemm<kMutBM, kMutBN>(load_x, w, ldw, K, h * C + c0, h * C + C, smem);
#pragma unroll 4
    for (int i = 0; i < kMutPer; ++i) {
      const int e = threadIdx.x + i * MutTile::kThreads;
      const int r = e / kMutBN, c = e % kMutBN, col = c0 + c;
      if (r < nrows && col < C) {
        const int row = row0 + r;
        const float t = tanhf(cs[r * MutTile::kCLd + c] + bias[h * C + col]);
        if constexpr (kResidual) v[static_cast<size_t>(row) * ldw + h * C + col] = f2bf(t);
        acc[e] += t * lang[static_cast<size_t>(row / N) * ldw + h * C + col];
      }
    }
  }

  // tanh(acc) out in f32, and this block's per-row sum of squares.  For a
  // fixed i the 32 lanes of a warp share one row, and each row is covered
  // by exactly two warps (column halves), so the row sum is formed in a
  // fixed order.
  const int lane = threadIdx.x % 32;
  const int half = (threadIdx.x / 32) % 2;
#pragma unroll 4
  for (int i = 0; i < kMutPer; ++i) {
    const int e = threadIdx.x + i * MutTile::kThreads;
    const int r = e / kMutBN, c = e % kMutBN, col = c0 + c;
    float sq = 0.f;
    if (r < nrows && col < C) {
      const float v = tanhf(acc[e]);
      y[static_cast<size_t>(row0 + r) * C + col] = v;
      sq = v * v;
    }
    sq = warp_sum(sq);
    if (lane == 0) half_sq[r][half] = sq;
  }
  __syncthreads();
  if (threadIdx.x < nrows)
    rowsq[static_cast<size_t>(row0 + threadIdx.x) * gridDim.x + ct] =
        half_sq[threadIdx.x][0] + half_sq[threadIdx.x][1];
}

__global__ void mutan_norm_kernel(const float* __restrict__ y,
                                  const float* __restrict__ rowsq,
                                  bf16* __restrict__ out, int C, int col_tiles) {
  const size_t row = blockIdx.x;
  float sq = 0.f;
  for (int j = 0; j < col_tiles; ++j) sq += rowsq[row * col_tiles + j];
  const float inv = rsqrtf(fmaxf(sq, 1e-12f));
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    out[row * C + c] = f2bf(y[row * C + c] * inv);
}

}  // namespace cmpc

extern "C" int cmpc_mutan_col_tiles(int C) { return (C + cmpc::kMutBN - 1) / cmpc::kMutBN; }

// x [M, K] bf16, w [K, heads*C] bf16, bias [heads*C] f32, lang [M/N, heads*C]
// f32 -> out [M, C] bf16; y [M, C] f32 and rowsq [M, col_tiles] f32 are
// scratch.  Row r uses lang row r / N.  v: null, or [M, heads*C] bf16 that
// receives tanh(x @ W + b) (the training residual).
extern "C" int cmpc_mutan_fused(const void* x, const void* w, const void* bias,
                                const void* lang, void* y, void* rowsq, void* out,
                                void* v, int M, int K, int C, int N, int heads,
                                void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_tiles = cmpc_mutan_col_tiles(C);
  const auto kernel = v ? mutan_heads_kernel<true> : mutan_heads_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMutSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(col_tiles, (M + kMutBM - 1) / kMutBM);
  kernel<<<grid, MutTile::kThreads, kMutSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(lang),
      static_cast<float*>(y), static_cast<float*>(rowsq), static_cast<bf16*>(v),
      M, K, C, N, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mutan_norm_kernel<<<M, 256, 0, s>>>(static_cast<const float*>(y),
                                      static_cast<const float*>(rowsq),
                                      static_cast<bf16*>(out), C, col_tiles);
  return static_cast<int>(cudaGetLastError());
}
