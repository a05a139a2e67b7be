// Shared device code of the wide-row forms: a plain tiled bf16 product on
// the tensor cores and the loaders of its operands.
//
// Each of spa_affinity.cu, se_sum.cu, graph_conv.cu and mutan_bwd.cu has a
// wide form beside its main kernel, launched where that kernel refuses the
// shape: a row wider than one thread-block cluster covers (the affinity's
// and the SE sum's row norms), a width whose per-column tables or staged
// rows do not fit shared memory (the graph update and message), or a row
// past the dz ring.  These forms hold no row in shared memory: a
// reduction over a whole row is carried in device memory as per-tile
// partials that a second pass adds in a fixed order (deterministic).
// They are simple, not fast: a block of 4 warps owns one 64 x 64 output
// tile, K advances 32 at a time through shared memory without a
// pipeline, and the products run as WMMA m16n16k16 (bf16 in, f32 sums).
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
// thread of the block.  A(r, k .. k + 7) gives 8 entries of A's row r;
// B(k, j .. j + 7) 8 entries of B's row k, or with BT B's column j as
// B(j, k .. k + 7) (B stored transposed, [columns][K]).  Both zero past
// their bounds.
template <bool BT, class ALoad, class BLoad>
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
      if (!BT) {
        const int k = e / (kWideTile / 8), jc = (e % (kWideTile / 8)) * 8;
        *reinterpret_cast<uint4*>(&sm.b[k][jc]) = B(k0 + k, c0 + jc);
      } else {
        const int j = e / (kWideK / 8), kc = (e % (kWideK / 8)) * 8;
        const uint4 v = B(c0 + j, k0 + kc);
        const bf16* vb = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) sm.b[kc + i][j] = vb[i];
      }
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

// Row r of the tile: the sum of sm.c[r][0 .. 63] in column order, by
// thread r < 64 (after the caller's __syncthreads).
__device__ __forceinline__ float wide_row_sum(const WideSmem& sm, int r) {
  float t = 0.f;
  for (int j = 0; j < kWideTile; ++j) t += sm.c[r][j];
  return t;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace cmpc
