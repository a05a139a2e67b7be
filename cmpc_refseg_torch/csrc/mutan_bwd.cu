// Mutan backward from the bf16 residual v = tanh(x @ W + b) [M, heads*C]
// that the training forward writes (csrc/mutan.cu):
//
// 1. The dz pass.  Replaces the Pallas kernel of
//    cmpc_refseg_tpu/ops/pallas_kernels.py::mutan_bwd_fused.  Per row it
//    rebuilds acc = sum_h v_h * lang_h, y = tanh(acc), the row's sum of
//    squares sq, r = rsqrt(max(sq, 1e-12)) and out = y * r; then from the
//    cotangent g of out: gy = sum g * out, dy = (g - out * gy) * r (g * r
//    where sq <= 1e-12), dacc = dy * (1 - y^2), and writes
//    dz_h = dacc * lang_h * (1 - v_h^2) in bf16.  It also reduces
//    dlang[b] = sum over sample b's rows of dacc * v_h and db = sum over all
//    rows of dz_h (f32, before the bf16 rounding of dz).
//    Bound on the card: bytes (v in, dz out, 2 x 128 MB at the flagship's
//    bs=8 train step).  Design: the row norm needs whole rows, so a block
//    owns a few rows x all heads*C columns (as se_sum.cu owns whole rows);
//    each thread owns the same column pairs in every row (bf16x2 loads and
//    stores), so its dlang / db accumulators live in shared memory with no
//    barrier and no atomics.  The rows of a block divide the rows per
//    sample, so they never straddle two samples (the TPU kernel's _pick_tm
//    guards the same).  Each block writes its column sums to its own slot;
//    a second small pass adds the slots in a fixed order (per sample for
//    dlang, over all blocks for db), so the result is deterministic.
//
// 2. The dW product dW[K, heads*C] = x^T @ dz, f32 accumulation over all M
//    rows.  Replaces pallas_kernels.py::_mutan_dw_call.  Bound on the card:
//    operations (129 GFLOP at the flagship shapes).  x [M, K] and dz are
//    read in their row-major layout: each 32-row slice of x is staged in
//    shared memory as it lies in memory ([rows][K tile]) and the tensor
//    cores read it transposed, as a column-major A fragment, which is the
//    in-VMEM tile transpose of the TPU kernel at no extra cost.  One block
//    owns a [128 x 64] tile of dW and loops over all M rows; two register
//    staged shared-memory buffers, as in common.cuh's tile product.
// Not yet done: TMA / wgmma pipelining, a split over M for more blocks.
#include "common.cuh"

namespace cmpc {

// ---------------------------------------------------------------------------
// dz pass
// ---------------------------------------------------------------------------

constexpr int kDzThreads = 256;
constexpr int kDzMaxRows = 32;        // rows per block, at most
constexpr float kNormEps = 1e-12f;

__device__ __forceinline__ float2 load_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared memory: dl, db [W] f32 accumulators, lang row [W] f32, then y and
// g [C] f32 of the current row (W = heads * C).
__global__ void __launch_bounds__(kDzThreads)
mutan_dz_kernel(const bf16* __restrict__ v, const float* __restrict__ lang,
                const bf16* __restrict__ g, bf16* __restrict__ dz,
                float* __restrict__ part_dl, float* __restrict__ part_db, int C,
                int heads, int N, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[kDzThreads / 32];
  const int W = heads * C;
  float* dl = reinterpret_cast<float*>(smem);
  float* db = dl + W;
  float* ls = db + W;
  float* ys = ls + W;
  float* gs = ys + C;
  const int row0 = blockIdx.x * rows_per_block;
  const float* lrow = lang + static_cast<size_t>(row0 / N) * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    dl[j] = 0.f;
    db[j] = 0.f;
    ls[j] = lrow[j];
  }
  __syncthreads();

  const int pairs = C / 2;
  for (int r = 0; r < rows_per_block; ++r) {
    const size_t row = static_cast<size_t>(row0 + r);
    const bf16* vrow = v + row * W;
    // pass 1: y = tanh(sum_h v_h lang_h), sum y^2 and sum g y
    float sq = 0.f, gy = 0.f;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int c = 2 * p;
      float2 acc = make_float2(0.f, 0.f);
      for (int h = 0; h < heads; ++h) {
        const float2 vv = load_bf2(vrow + h * C + c);
        acc.x += vv.x * ls[h * C + c];
        acc.y += vv.y * ls[h * C + c + 1];
      }
      const float2 y = make_float2(tanhf(acc.x), tanhf(acc.y));
      const float2 gg = load_bf2(g + row * C + c);
      ys[c] = y.x;
      ys[c + 1] = y.y;
      gs[c] = gg.x;
      gs[c + 1] = gg.y;
      sq += y.x * y.x + y.y * y.y;
      gy += gg.x * y.x + gg.y * y.y;
    }
    sq = block_sum(sq, scratch);
    gy = block_sum(gy, scratch);
    const float rn = rsqrtf(fmaxf(sq, kNormEps));
    gy *= rn;   // sum g * out, out = y * rn
    const bool normed = sq > kNormEps;
    // pass 2: dacc, dz and this block's dlang / db column sums
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int c = 2 * p;
      float dacc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float y = ys[c + i], gg = gs[c + i];
        const float out = y * rn;
        const float dy = normed ? (gg - out * gy) * rn : gg * rn;
        dacc[i] = dy * (1.f - y * y);
      }
      for (int h = 0; h < heads; ++h) {
        const int j = h * C + c;
        const float2 vv = load_bf2(vrow + j);
        const float dz0 = dacc[0] * ls[j] * (1.f - vv.x * vv.x);
        const float dz1 = dacc[1] * ls[j + 1] * (1.f - vv.y * vv.y);
        *reinterpret_cast<__nv_bfloat162*>(dz + row * W + j) =
            __floats2bfloat162_rn(dz0, dz1);
        dl[j] += dacc[0] * vv.x;
        dl[j + 1] += dacc[1] * vv.y;
        db[j] += dz0;
        db[j + 1] += dz1;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    part_dl[static_cast<size_t>(blockIdx.x) * W + j] = dl[j];
    part_db[static_cast<size_t>(blockIdx.x) * W + j] = db[j];
  }
}

// Slot sums in a fixed order: y < samples gives dlang[y], y == samples db.
__global__ void mutan_dz_finalize_kernel(const float* __restrict__ part_dl,
                                         const float* __restrict__ part_db,
                                         float* __restrict__ dlang,
                                         float* __restrict__ db, int W,
                                         int blocks_per_sample, int samples) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const int b = blockIdx.y;
  float s = 0.f;
  if (b < samples) {
    for (int k = 0; k < blocks_per_sample; ++k)
      s += part_dl[static_cast<size_t>(b * blocks_per_sample + k) * W + j];
    dlang[static_cast<size_t>(b) * W + j] = s;
  } else {
    for (int k = 0; k < samples * blocks_per_sample; ++k)
      s += part_db[static_cast<size_t>(k) * W + j];
    db[j] = s;
  }
}

// ---------------------------------------------------------------------------
// dW product
// ---------------------------------------------------------------------------

constexpr int kDwBM = 128;                 // rows of dW (x's columns) per block
constexpr int kDwBN = 64;                  // columns of dW (dz's) per block
constexpr int kDwWarpsN = kDwBN / 32;
constexpr int kDwThreads = (kDwBM / 32) * kDwWarpsN * 32;
constexpr int kXLd = kDwBM + 8;            // x slice [kBK rows][kXLd]
constexpr int kZLd = kDwBN + 8;            // dz slice [kBK rows][kZLd]
constexpr int kDwStage = kBK * kXLd + kBK * kZLd;
constexpr int kDwABBytes = 2 * kDwStage * 2;
constexpr int kDwCLd = kDwBN + 4;
constexpr int kDwCBytes = kDwBM * kDwCLd * 4;
constexpr int kDwSmem = kDwABBytes > kDwCBytes ? kDwABBytes : kDwCBytes;
constexpr int kXVecs = kBK * kDwBM / 8 / kDwThreads;
constexpr int kZVecs = kBK * kDwBN / 8 / kDwThreads;
static_assert(kXVecs * kDwThreads * 8 == kBK * kDwBM, "x slice must split evenly");
static_assert(kZVecs * kDwThreads * 8 == kBK * kDwBN, "dz slice must split evenly");

__global__ void __launch_bounds__(kDwThreads)
mutan_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                float* __restrict__ dw, int M, int K, int W) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kDwSmem];
  bf16* stage0 = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int k0 = blockIdx.y * kDwBM;
  const int c0 = blockIdx.x * kDwBN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / kDwWarpsN, wn = warp % kDwWarpsN;

  uint4 rx[kXVecs], rz[kZVecs];
  auto fetch = [&](int m0) {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int e = threadIdx.x + i * kDwThreads;
      const int m = m0 + e / (kDwBM / 8), k = k0 + (e % (kDwBM / 8)) * 8;
      rx[i] = (m < M && k < K) ? load_vec<8>(x + static_cast<size_t>(m) * K + k) : zero_vec();
    }
#pragma unroll
    for (int i = 0; i < kZVecs; ++i) {
      const int e = threadIdx.x + i * kDwThreads;
      const int m = m0 + e / (kDwBN / 8), c = c0 + (e % (kDwBN / 8)) * 8;
      rz[i] = (m < M && c < W) ? load_vec<8>(dz + static_cast<size_t>(m) * W + c) : zero_vec();
    }
  };
  auto stash = [&](int s) {
    bf16* xs = stage0 + s * kDwStage;
    bf16* zs = xs + kBK * kXLd;
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int e = threadIdx.x + i * kDwThreads;
      *reinterpret_cast<uint4*>(xs + (e / (kDwBM / 8)) * kXLd + (e % (kDwBM / 8)) * 8) = rx[i];
    }
#pragma unroll
    for (int i = 0; i < kZVecs; ++i) {
      const int e = threadIdx.x + i * kDwThreads;
      *reinterpret_cast<uint4*>(zs + (e / (kDwBN / 8)) * kZLd + (e % (kDwBN / 8)) * 8) = rz[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  stash(0);
  __syncthreads();
  int s = 0;
  for (int m0 = 0; m0 < M; m0 += kBK) {
    const bool more = m0 + kBK < M;
    if (more) fetch(m0 + kBK);
    const bf16* xs = stage0 + s * kDwStage;
    const bf16* zs = xs + kBK * kXLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A = x^T: element (row k, depth m) sits at xs[m * kXLd + k], which is
      // a column-major A tile with leading dimension kXLd.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + kk * kXLd + wm * 32 + i * 16, kXLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], zs + kk * kZLd + wn * 32 + j * 16, kZLd);
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
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kDwCLd + wn * 32 + j * 16,
                              acc[i][j], kDwCLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kDwBM * kDwBN; e += kDwThreads) {
    const int r = e / kDwBN, c = e % kDwBN;
    if (k0 + r < K && c0 + c < W)
      dw[static_cast<size_t>(k0 + r) * W + c0 + c] = cs[r * kDwCLd + c];
  }
}

}  // namespace cmpc

// Rows per block of the dz pass: the largest divisor of N (rows per sample)
// up to kDzMaxRows, so a block never straddles two samples.
extern "C" int cmpc_mutan_dz_rows_per_block(int N) {
  for (int r = cmpc::kDzMaxRows; r > 1; --r)
    if (N % r == 0) return r;
  return 1;
}

// v [M, heads*C] bf16, lang [M/N, heads*C] f32, g [M, C] bf16 ->
// dz [M, heads*C] bf16, dlang [M/N, heads*C] f32, db [heads*C] f32.  part is
// scratch [2, M / rows_per_block, heads*C] f32.  C must be even.
extern "C" int cmpc_mutan_bwd_dz(const void* v, const void* lang, const void* g,
                                 void* dz, void* part, void* dlang, void* db,
                                 int M, int C, int N, int heads, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = heads * C;
  const int rpb = cmpc_mutan_dz_rows_per_block(N);
  const int blocks = M / rpb;
  const int smem = (3 * W + 2 * C) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mutan_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part_dl = static_cast<float*>(part);
  float* part_db = part_dl + static_cast<size_t>(blocks) * W;
  mutan_dz_kernel<<<blocks, kDzThreads, smem, s>>>(
      static_cast<const bf16*>(v), static_cast<const float*>(lang),
      static_cast<const bf16*>(g), static_cast<bf16*>(dz), part_dl, part_db, C,
      heads, N, rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + 255) / 256, M / N + 1);
  mutan_dz_finalize_kernel<<<grid, 256, 0, s>>>(
      part_dl, part_db, static_cast<float*>(dlang), static_cast<float*>(db), W,
      N / rpb, M / N);
  return static_cast<int>(cudaGetLastError());
}

// x [M, K] bf16, dz [M, W] bf16 -> dw [K, W] f32 = x^T @ dz.  K and W must
// be multiples of 8 (16-byte loads).
extern "C" int cmpc_mutan_dw(const void* x, const void* dz, void* dw, int M, int K,
                             int W, void* stream) {
  using namespace cmpc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kDwBN - 1) / kDwBN, (K + kDwBM - 1) / kDwBM);
  mutan_dw_kernel<<<grid, kDwThreads, 0, s>>>(static_cast<const bf16*>(x),
                                              static_cast<const bf16*>(dz),
                                              static_cast<float*>(dw), M, K, W);
  return static_cast<int>(cudaGetLastError());
}
