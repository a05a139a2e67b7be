// Shared device code of the port's Hopper kernels: bf16 helpers, warp and
// block reductions, and one bf16 tile product on the tensor cores (WMMA,
// f32 accumulation) that graph_conv.cu and spa_affinity.cu build on (the
// other kernels' products are wgmma, csrc/hopper.cuh).
//
// The tile product is deliberately simple: a [BM, K] x [K, BN] block
// product staged through two shared-memory buffers in 32-deep slices with
// 16-byte vector loads (8 bf16), four 16x16 fragments per warp.  Ragged
// edges are masked at 8-element granularity, so K, the row strides and the
// column bounds must be multiples of 8 (the wrappers check this).  Each
// kernel customises how the A operand is loaded (a plain row block, or a
// row block computed on the fly by the kernel's prologue).
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

struct __align__(8) Vec4 {
  bf16 v[4];
};

__device__ __forceinline__ Vec4 as_vec4(uint2 u) {
  Vec4 r;
  *reinterpret_cast<uint2*>(&r) = u;
  return r;
}

__device__ __forceinline__ uint2 as_uint2(const Vec4& v) {
  return *reinterpret_cast<const uint2*>(&v);
}

__device__ __forceinline__ uint4 zero_vec() { return make_uint4(0u, 0u, 0u, 0u); }

// The vector type of VEC bf16 elements, and a load of one.
template <int VEC>
struct VecT;
template <>
struct VecT<8> {
  using type = uint4;
};
template <>
struct VecT<4> {
  using type = uint2;
};

template <int VEC>
__device__ __forceinline__ typename VecT<VEC>::type load_vec(const bf16* p) {
  return *reinterpret_cast<const typename VecT<VEC>::type*>(p);
}

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

// Two neighbouring bf16 (4-byte aligned) as floats, and the store of two.
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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

// Error codes at or above this are kTmapError + the CUresult of a refused
// cuTensorMapEncodeTiled (csrc/hopper.cuh).
constexpr int kTmapError = 20000;

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
};

// A operand: `nrows` rows of a row-major bf16 matrix starting at `a`;
// zero past the last row and past K.
struct RowsA {
  const bf16* a;
  int lda;
  int K;
  int nrows;
  __device__ __forceinline__ uint4 operator()(int r, int k) const {
    if (r < nrows && k < K) return load_vec<8>(a + static_cast<size_t>(r) * lda + k);
    return uint4{};
  }
};

// C[BM, BN] = A[BM, K] x B[K, col0:col0+BN] with f32 accumulation, left in
// shared memory as floats with leading dim GemmTile::kCLd.  Columns at or
// past `col_end` read as zero.  `load_a(r, k)` returns 8 elements of A
// (a uint4).  Two shared-memory stages: the global loads
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
  constexpr int VEC = 8;
  using V = uint4;
  using namespace nvcuda;
  constexpr int kAVecs = BM * kBK / VEC / T::kThreads;  // vector loads per thread
  constexpr int kBVecs = kBK * BN / VEC / T::kThreads;
  static_assert(kAVecs * T::kThreads * VEC == BM * kBK, "A slice must split evenly");
  static_assert(kBVecs * T::kThreads * VEC == kBK * BN, "B slice must split evenly");
  bf16* stage0 = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;

  V ra[kAVecs], rb[kBVecs];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      ra[i] = load_a(v / (kBK / VEC), k0 + (v % (kBK / VEC)) * VEC);
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      const int k = k0 + v / (BN / VEC), col = col0 + (v % (BN / VEC)) * VEC;
      rb[i] = (k < K && col < col_end) ? load_vec<VEC>(b + static_cast<size_t>(k) * ldb + col)
                                       : V{};
    }
  };
  auto stash = [&](int s) {
    bf16* as = stage0 + s * T::kStageElems;
    bf16* bs = as + BM * kALd;
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      *reinterpret_cast<V*>(as + (v / (kBK / VEC)) * kALd + (v % (kBK / VEC)) * VEC) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      *reinterpret_cast<V*>(bs + (v / (BN / VEC)) * T::kBLd + (v % (BN / VEC)) * VEC) = rb[i];
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
  if (code >= cmpc::kTmapError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 20000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
