// Shared device code of the port's Hopper kernels: bf16 helpers, warp and
// block reductions, and one bf16 tile product on the tensor cores (WMMA,
// f32 accumulation) that every kernel builds on.
//
// The tile product is deliberately simple: a [BM, K] x [K, BN] block
// product staged through two shared-memory buffers in 32-deep slices with
// 16-byte vector loads, four 16x16 fragments per warp.  Ragged edges are
// masked at 8-element granularity, so K, the row strides and the column
// bounds must be multiples of 8 (the wrappers check this).  Each kernel customises how
// the A operand is loaded (a plain row block, or a row block computed on
// the fly by the kernel's prologue).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace cmpc {

using bf16 = __nv_bfloat16;

struct __align__(16) Vec8 {
  bf16 v[8];
};

__device__ __forceinline__ uint4 zero_vec() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ Vec8 as_vec8(uint4 u) {
  Vec8 r;
  *reinterpret_cast<uint4*>(&r) = u;
  return r;
}

__device__ __forceinline__ uint4 as_uint4(const Vec8& v) {
  return *reinterpret_cast<const uint4*>(&v);
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
// Round a float to bf16 precision and back (a bf16 store + reload).
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum `v` over the block in a fixed order (deterministic); every thread
// gets the total.  `scratch` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total += scratch[w];
  return total;
}

constexpr int kBK = 32;          // depth of one staged slice
constexpr int kALd = kBK + 8;    // padded leading dim of the A slice (bf16)

template <int BM, int BN>
struct GemmTile {
  static constexpr int kWarpsM = BM / 32;
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = kWarpsM * kWarpsN * 32;
  static constexpr int kBLd = BN + 8;   // bf16
  static constexpr int kCLd = BN + 4;   // f32
  static constexpr int kStageElems = BM * kALd + kBK * kBLd;   // one A+B slice
  static constexpr int kABBytes = 2 * kStageElems * 2;         // two stages
  static constexpr int kCBytes = BM * kCLd * 4;
  static constexpr int kSmemBytes = kABBytes > kCBytes ? kABBytes : kCBytes;
  static constexpr int kAVecs = BM * kBK / 8 / kThreads;  // 16-byte loads per thread
  static constexpr int kBVecs = kBK * BN / 8 / kThreads;
  static_assert(kAVecs * kThreads * 8 == BM * kBK, "A slice must split evenly");
  static_assert(kBVecs * kThreads * 8 == kBK * BN, "B slice must split evenly");
};

// A operand: `nrows` rows of a row-major bf16 matrix starting at `a`;
// zero past the last row and past K.
struct RowsA {
  const bf16* a;
  int lda;
  int K;
  int nrows;
  __device__ __forceinline__ uint4 operator()(int r, int k) const {
    if (r < nrows && k < K)
      return *reinterpret_cast<const uint4*>(a + static_cast<size_t>(r) * lda + k);
    return zero_vec();
  }
};

// C[BM, BN] = A[BM, K] x B[K, col0:col0+BN] with f32 accumulation, left in
// shared memory as floats with leading dim GemmTile::kCLd.  Columns at or
// past `col_end` read as zero.  Two shared-memory stages: the global loads
// of slice k+1 are issued into registers before the tensor cores work on
// slice k, and stored to the other stage after, so one barrier per slice
// separates them.  The result aliases the stages, so it is valid until the
// next call (which begins with a barrier).
template <int BM, int BN, class ALoad>
__device__ __forceinline__ void tile_gemm(const ALoad& load_a,
                                          const bf16* __restrict__ b, int ldb,
                                          int K, int col0, int col_end,
                                          unsigned char* smem) {
  using T = GemmTile<BM, BN>;
  using namespace nvcuda;
  bf16* stage0 = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;

  uint4 ra[T::kAVecs], rb[T::kBVecs];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::kAVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      ra[i] = load_a(v / (kBK / 8), k0 + (v % (kBK / 8)) * 8);
    }
#pragma unroll
    for (int i = 0; i < T::kBVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      const int k = k0 + v / (BN / 8), col = col0 + (v % (BN / 8)) * 8;
      rb[i] = (k < K && col < col_end)
                  ? *reinterpret_cast<const uint4*>(b + static_cast<size_t>(k) * ldb + col)
                  : zero_vec();
    }
  };
  auto stash = [&](int s) {
    bf16* as = stage0 + s * T::kStageElems;
    bf16* bs = as + BM * kALd;
#pragma unroll
    for (int i = 0; i < T::kAVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      *reinterpret_cast<uint4*>(as + (v / (kBK / 8)) * kALd + (v % (kBK / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < T::kBVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      *reinterpret_cast<uint4*>(bs + (v / (BN / 8)) * T::kBLd + (v % (BN / 8)) * 8) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  __syncthreads();  // the previous result may still be read
  fetch(0);
  stash(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) fetch(k0 + kBK);
    const bf16* as = stage0 + s * T::kStageElems;
    const bf16* bs = as + BM * kALd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * T::kBLd + wn * 32 + j * 16, T::kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more) stash(s ^ 1);
    __syncthreads();
    s ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * T::kCLd + wn * 32 + j * 16,
                              acc[i][j], T::kCLd, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace cmpc

extern "C" const char* cmpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
