// Shared device code of the one wide-row form still built from a plain
// tiled product: graph_conv.cu's graph_msg_wide_kernel, the message where
// its plan does not fit shared memory (C > 4096, or C * T too large).  A
// bf16 product on the tensor cores and the loader of its operands.  It is
// simple, not fast: a block of 4 warps owns one 64 x 64 output tile, K
// advances 32 at a time through shared memory without a pipeline, and the
// products run as WMMA m16n16k16 (bf16 in, f32 sums).  The other wide
// forms run their main kernel's pipeline in their own sources (the
// affinity, the update, the SE sum) or a vector stream (the dz pass).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace cmpc {

constexpr int kWideTile = 64;      // rows and columns of a block's output tile
constexpr int kWideK = 32;         // K per step
constexpr int kWideThreads = 128;  // 4 warps, a 32 x 32 quarter of the tile each
constexpr int kWidePerThread = kWideTile * kWideTile / kWideThreads;   // 32 entries

// The operand tiles (rows padded by 16 bytes against bank conflicts) and
// the f32 result tile, which the epilogues read: entry e = threadIdx.x +
// i * kWideThreads of the tile is row e / kWideTile, column e % kWideTile.
struct __align__(128) WideSmem {
  bf16 a[kWideTile][kWideK + 8];
  bf16 b[kWideK][kWideTile + 8];
  float c[kWideTile][kWideTile + 4];
};

__host__ __device__ inline int wide_tiles(int n) { return (n + kWideTile - 1) / kWideTile; }

// 8 neighbouring entries p[r * ld + k .. k + 7] of a row-major matrix of
// `rows` rows and `cols` columns, zero past either; one 16-byte load where
// `vec` says the rows are 16-byte aligned (ld % 8 == 0, p aligned).
struct RowsLoad {
  const bf16* p;
  long long ld;
  int rows, cols;
  bool vec;
  __device__ uint4 operator()(int r, int k) const {
    if (r >= rows || k >= cols) return zero_vec();
    const bf16* q = p + r * ld + k;
    if (vec && k + 8 <= cols) return *reinterpret_cast<const uint4*>(q);
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = k + i < cols ? q[i] : f2bf(0.f);
    return out;
  }
};

// The 64 x 64 tile [r0, c0] of A @ B over K into sm.c (f32), for every
// thread of the block.  A(r, k .. k + 7) gives 8 entries of A's row r,
// B(k, j .. j + 7) 8 entries of B's row k, both zero past their bounds.
template <class ALoad, class BLoad>
__device__ void wide_product(WideSmem& sm, const ALoad& A, const BLoad& B, int r0, int c0,
                             int K) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < K; k0 += kWideK) {
    for (int e = threadIdx.x; e < kWideTile * kWideK / 8; e += kWideThreads) {
      const int r = e / (kWideK / 8), kc = (e % (kWideK / 8)) * 8;
      *reinterpret_cast<uint4*>(&sm.a[r][kc]) = A(r0 + r, k0 + kc);
    }
    for (int e = threadIdx.x; e < kWideK * kWideTile / 8; e += kWideThreads) {
      const int k = e / (kWideTile / 8), jc = (e % (kWideTile / 8)) * 8;
      *reinterpret_cast<uint4*>(&sm.b[k][jc]) = B(k0 + k, c0 + jc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWideK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &sm.a[wr + 16 * i][kk], kWideK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[kk][wc + 16 * j], kWideTile + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.c[wr + 16 * i][wc + 16 * j], acc[i][j], kWideTile + 4,
                              wmma::mem_row_major);
  __syncthreads();
}

}  // namespace cmpc
