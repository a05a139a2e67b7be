// One ConvLSTM step with a 1x1 kernel, peepholes and whole-sample layer
// norms (util/cell.py:36-79), as two kernels around a plain-PyTorch
// finalize:
//   gates: y_g = bf16([x | h] @ W[:, g*C:(g+1)*C]) for g = j, i, f, o;
//          i += bf16(W_ci * c), f += bf16(W_cf * c) (bf16 adds);
//          and the (sum, sum of squares) of j, i, f per block
//   raw:   j, i, f layer-normed from those statistics;
//          new_c_raw = bf16(bf16(c * bf16(sigmoid(f + 1))) + bf16(bf16(sigmoid(i)) * bf16(tanh(j))))
//          o_raw     = bf16(o + bf16(W_co * new_c_raw))
//          and the (sum, sum of squares) of new_c_raw and o_raw per block
// The peepholes W_ci, W_cf, W_co are [N, C], shared across the batch.
//
// gates replaces cmpc_refseg_tpu/ops/pallas_kernels.py::_convlstm_gates_call.
// Bound on the card: operations (the [B*N, 2C] x [2C, 4C] product, 51
// GFLOP at the flagship shapes, against ~97 MB).  Design: a block owns 128
// rows of one sample and 64 columns of each gate and loops over the 4
// gates with the tensor-core tile product of common.cuh; its A loader
// reads [x | h] from two pointers (K = 2C = 1000, split at 500, never
// concatenated).  C = 500 rows are 8-byte aligned, so loads are 8 bytes
// (VEC = 4).  The statistics partials go to per-block slots: no atomics,
// a fixed summing order.
//
// raw replaces ::_convlstm_raw_call.  Bound on the card: bytes (reads 4
// gates, c and W_co, writes 2 tensors, 91 MB at the flagship shapes).
// Design: one block per 32 rows of one sample; each thread handles 4-
// element vectors; the block first sums its sample's gate statistics in a
// fixed order, then writes its own partials.
#include "common.cuh"

namespace cmpc {

constexpr int kGateBM = 128;
constexpr int kGateBN = 64;
using GateTile = GemmTile<kGateBM, kGateBN>;
constexpr int kRawRows = 32;
constexpr int kRawThreads = 256;
constexpr float kForgetBias = 1.f;   // the cell's fixed forget bias

// A operand [x | h]: columns below C from x, the rest from h.
struct XHLoad {
  const bf16* x;
  const bf16* h;
  int C;
  int nrows;
  __device__ __forceinline__ uint2 operator()(int r, int k) const {
    if (r >= nrows || k >= 2 * C) return uint2{};
    const size_t o = static_cast<size_t>(r) * C;
    return load_vec<4>(k < C ? x + o + k : h + o + (k - C));
  }
};

__global__ void __launch_bounds__(GateTile::kThreads, 2)
convlstm_gates_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                      const bf16* __restrict__ c, const bf16* __restrict__ w,
                      const bf16* __restrict__ ci, const bf16* __restrict__ cf,
                      bf16* __restrict__ gates, float* __restrict__ stats, int N, int C,
                      int M) {
  __shared__ __align__(128) unsigned char smem[GateTile::kSmemBytes];
  __shared__ float red[GateTile::kThreads / 32];
  const int s = blockIdx.z, rb = blockIdx.y, ct = blockIdx.x;
  const int row0 = rb * kGateBM, c0 = ct * kGateBN;
  const int nrows = min(kGateBM, N - row0);
  const size_t grow0 = static_cast<size_t>(s) * N + row0;
  const XHLoad load{x + grow0 * C, h + grow0 * C, C, nrows};
  const float* cs = reinterpret_cast<const float*>(smem);
  float part[6];

  for (int g = 0; g < 4; ++g) {
    tile_gemm<kGateBM, kGateBN, 4>(load, w, 4 * C, 2 * C, g * C + c0, g * C + C, smem);
    float sum = 0.f, sumsq = 0.f;
    for (int e = threadIdx.x; e < kGateBM * kGateBN; e += GateTile::kThreads) {
      const int r = e / kGateBN, cc = e % kGateBN, col = c0 + cc;
      if (r < nrows && col < C) {
        float y = round_bf(cs[r * GateTile::kCLd + cc]);
        if (g == 1 || g == 2) {
          const bf16* peep = g == 1 ? ci : cf;
          const float cv = bf2f(c[(grow0 + r) * C + col]);
          y = round_bf(y + round_bf(bf2f(peep[static_cast<size_t>(row0 + r) * C + col]) * cv));
        }
        gates[(static_cast<size_t>(g) * M + grow0 + r) * C + col] = f2bf(y);
        sum += y;
        sumsq += y * y;
      }
    }
    if (g < 3) {
      part[2 * g] = block_sum(sum, red);
      part[2 * g + 1] = block_sum(sumsq, red);
    }
  }
  if (threadIdx.x == 0) {
    const size_t p = (static_cast<size_t>(s) * gridDim.y + rb) * gridDim.x + ct;
    for (int q = 0; q < 6; ++q) stats[p * 6 + q] = part[q];
  }
}

__device__ __forceinline__ float logistic(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void __launch_bounds__(kRawThreads)
convlstm_raw_kernel(const bf16* __restrict__ gates, const bf16* __restrict__ c,
                    const bf16* __restrict__ co, const float* __restrict__ stats,
                    int parts, const float* __restrict__ gamma,
                    const float* __restrict__ beta, bf16* __restrict__ ncr,
                    bf16* __restrict__ oraw, float* __restrict__ stats2, int N, int C,
                    int M) {
  __shared__ float tot[6];
  __shared__ float red[kRawThreads / 32];
  const int s = blockIdx.y, rb = blockIdx.x;
  const int row0 = rb * kRawRows;
  const int nrows = min(kRawRows, N - row0);
  const size_t grow0 = static_cast<size_t>(s) * N + row0;

  if (threadIdx.x < 6) {
    float a = 0.f;
    for (int p = 0; p < parts; ++p) a += stats[(static_cast<size_t>(s) * parts + p) * 6 + threadIdx.x];
    tot[threadIdx.x] = a;
  }
  __syncthreads();
  const float cnt = static_cast<float>(N) * static_cast<float>(C);
  float mean[3], inv[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    mean[q] = tot[2 * q] / cnt;
    const float var = fmaxf(tot[2 * q + 1] / cnt - mean[q] * mean[q], 0.f);
    inv[q] = rsqrtf(var + 1e-12f);
  }

  const int vecs = C / 4;
  float s_c = 0.f, q_c = 0.f, s_o = 0.f, q_o = 0.f;
  for (int v = threadIdx.x; v < nrows * vecs; v += kRawThreads) {
    const int r = v / vecs, col = (v % vecs) * 4;
    const size_t o = (grow0 + r) * C + col;
    const size_t gs = static_cast<size_t>(M) * C;
    const Vec4 gj = as_vec4(load_vec<4>(gates + o));
    const Vec4 gi = as_vec4(load_vec<4>(gates + gs + o));
    const Vec4 gf = as_vec4(load_vec<4>(gates + 2 * gs + o));
    const Vec4 go = as_vec4(load_vec<4>(gates + 3 * gs + o));
    const Vec4 cv = as_vec4(load_vec<4>(c + o));
    const Vec4 cov = as_vec4(load_vec<4>(co + static_cast<size_t>(row0 + r) * C + col));
    Vec4 nc, orw;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = col + e;
      const float lj = (bf2f(gj.v[e]) - mean[0]) * inv[0] * gamma[cc] + beta[cc];
      const float li = (bf2f(gi.v[e]) - mean[1]) * inv[1] * gamma[C + cc] + beta[C + cc];
      const float lf = (bf2f(gf.v[e]) - mean[2]) * inv[2] * gamma[2 * C + cc] + beta[2 * C + cc];
      const float jn = round_bf(tanhf(lj));
      const float is = round_bf(logistic(li));
      const float fs = round_bf(logistic(lf + kForgetBias));
      const float n = round_bf(round_bf(bf2f(cv.v[e]) * fs) + round_bf(is * jn));
      const float ov = round_bf(bf2f(go.v[e]) + round_bf(bf2f(cov.v[e]) * n));
      nc.v[e] = f2bf(n);
      orw.v[e] = f2bf(ov);
      s_c += n;
      q_c += n * n;
      s_o += ov;
      q_o += ov * ov;
    }
    *reinterpret_cast<uint2*>(ncr + o) = as_uint2(nc);
    *reinterpret_cast<uint2*>(oraw + o) = as_uint2(orw);
  }
  s_c = block_sum(s_c, red);
  q_c = block_sum(q_c, red);
  s_o = block_sum(s_o, red);
  q_o = block_sum(q_o, red);
  if (threadIdx.x == 0) {
    float* st = stats2 + (static_cast<size_t>(s) * gridDim.x + rb) * 4;
    st[0] = s_c;
    st[1] = q_c;
    st[2] = s_o;
    st[3] = q_o;
  }
}

}  // namespace cmpc

extern "C" int cmpc_convlstm_gates_parts(int N, int C) {
  return ((N + cmpc::kGateBM - 1) / cmpc::kGateBM) * ((C + cmpc::kGateBN - 1) / cmpc::kGateBN);
}

extern "C" int cmpc_convlstm_raw_parts(int N) {
  return (N + cmpc::kRawRows - 1) / cmpc::kRawRows;
}

// x, h, c [B*N, C] bf16; w [2C, 4C] bf16 (gate g in columns g*C..g*C+C-1,
// order j, i, f, o); ci, cf [N, C] bf16 -> gates [4, B*N, C] bf16 and
// stats [B, gates_parts, 3, 2] f32 (sum, sum of squares of j, i, f).
// C must be a multiple of 4.
extern "C" int cmpc_convlstm_gates(const void* x, const void* h, const void* c,
                                   const void* w, const void* ci, const void* cf,
                                   void* gates, void* stats, int B, int N, int C,
                                   void* stream) {
  using namespace cmpc;
  if (C % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kGateBN - 1) / kGateBN, (N + kGateBM - 1) / kGateBM, B);
  convlstm_gates_kernel<<<grid, GateTile::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(h), static_cast<const bf16*>(c),
      static_cast<const bf16*>(w), static_cast<const bf16*>(ci), static_cast<const bf16*>(cf),
      static_cast<bf16*>(gates), static_cast<float*>(stats), N, C, B * N);
  return static_cast<int>(cudaGetLastError());
}

// gates [4, B*N, C] bf16 and stats [B, parts, 3, 2] f32 (convlstm_gates');
// c [B*N, C], co [N, C] bf16; gamma, beta [5, C] f32 (layer norms j, i, f,
// o, c; rows 0-2 used) -> new_c_raw, o_raw [B*N, C] bf16 and stats2
// [B, raw_parts, 2, 2] f32 (sum, sum of squares of new_c_raw, then o_raw).
extern "C" int cmpc_convlstm_raw(const void* gates, const void* c, const void* co,
                                 const void* stats, int parts, const void* gamma,
                                 const void* beta, void* ncr, void* oraw, void* stats2,
                                 int B, int N, int C, void* stream) {
  using namespace cmpc;
  if (C % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cmpc_convlstm_raw_parts(N), B);
  convlstm_raw_kernel<<<grid, kRawThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gates), static_cast<const bf16*>(c),
      static_cast<const bf16*>(co), static_cast<const float*>(stats), parts,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(ncr), static_cast<bf16*>(oraw), static_cast<float*>(stats2), N, C,
      B * N);
  return static_cast<int>(cudaGetLastError());
}
