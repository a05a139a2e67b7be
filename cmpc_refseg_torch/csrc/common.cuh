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

// Four neighbouring bf16 (8-byte aligned) as one load.
__device__ __forceinline__ uint2 load_vec4(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
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

}  // namespace cmpc

extern "C" const char* cmpc_error_string(int code) {
  if (code >= cmpc::kTmapError)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 20000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
