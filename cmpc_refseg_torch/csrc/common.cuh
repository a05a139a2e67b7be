// Shared device code of the port's Hopper kernels: bf16 helpers and warp
// and block reductions (the Hopper building blocks are in csrc/hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace cmpc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint4 zero_vec() { return make_uint4(0u, 0u, 0u, 0u); }

// VEC neighbouring bf16 as one access of 2 * VEC bytes (VEC = 8, 4 or 2;
// the address aligned to that): the bits, and their floats.
template <int VEC> struct BfBits;
template <> struct BfBits<8> { using T = uint4; };
template <> struct BfBits<4> { using T = uint2; };
template <> struct BfBits<2> { using T = uint32_t; };
template <int VEC> using BfBitsT = typename BfBits<VEC>::T;

template <int VEC>
__device__ __forceinline__ void unpack_bf(const BfBitsT<VEC>& bits, float (&out)[VEC]) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&bits);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int VEC>
__device__ __forceinline__ void load_bf(const bf16* p, float (&out)[VEC]) {
  unpack_bf<VEC>(*reinterpret_cast<const BfBitsT<VEC>*>(p), out);
}

// VEC floats rounded to bf16 (nearest even) as bits, and their store as
// one access.
template <int VEC>
__device__ __forceinline__ BfBitsT<VEC> pack_bf(const float (&in)[VEC]) {
  BfBitsT<VEC> bits;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&bits);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) pairs[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return bits;
}

template <int VEC>
__device__ __forceinline__ void store_bf(bf16* p, const float (&in)[VEC]) {
  *reinterpret_cast<BfBitsT<VEC>*>(p) = pack_bf<VEC>(in);
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
// Round a float to bf16 precision and back (a bf16 store + reload).
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

// A bf16 pair as its 32 bits, and back.
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

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

// The sums over the warp of four values (each lane's a, b, c, d) by a
// fixed-order tree of 6 shuffles: one halving step per value pair, then a
// butterfly.  The sum of a ends in lanes 0-7, b in 8-15, c in 16-23, d in
// 24-31, the same bits in every lane of a group and in every warp that
// sums the same values.
__device__ __forceinline__ float warp_sum4_spread(float a, float b, float c, float d) {
  const int lane = threadIdx.x % 32;
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float k0 = hi16 ? c : a, k1 = hi16 ? d : b;
  k0 += __shfl_xor_sync(0xffffffffu, hi16 ? a : c, 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi16 ? b : d, 16);
  float k = hi8 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) k += __shfl_xor_sync(0xffffffffu, k, o);
  return k;
}

// Whether a device pointer is 16-byte aligned (TMA and bulk copies need it).
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Error codes at or above this are kTmapError + the CUresult of a refused
// cuTensorMapEncodeTiled (csrc/hopper.cuh).
constexpr int kTmapError = 20000;

}  // namespace cmpc

extern "C" const char* cmpc_error_string(int code) {
  if (code >= cmpc::kTmapError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 20000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
