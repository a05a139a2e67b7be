// Graph convolution over the factored adjacency (CMPC_model.py:359-374):
//   msg = w_aff @ pooled                       (graph_msg)
//   z   = relu(x + LN1(msg)) @ W + b           (graph_update)
// each with the whole-sample layer-norm statistics (sum, sum of squares) of
// its bf16-rounded output.  The final relu(LN2(z)) and pooled = v_aff^T @ x
// stay plain PyTorch, as the JAX package leaves them to XLA.
//
// graph_msg replaces cmpc_refseg_tpu/ops/pallas_kernels.py::_graph_msg_call.
// Bound on the card: bytes (2*T = 40 FLOP per 2-byte output element; the
// [B*N, C] bf16 store dominates, 26 MB at the flagship shapes).  Design: a
// block takes 32 rows of one sample; each thread holds one column pair of
// pooled [T, C] in registers, reads the w_aff rows as shared-memory
// broadcasts and writes coalesced bf16 pairs.  The block's (sum, sum of
// squares) partial goes to its own slot, so the statistics need no atomics
// and are summed in a fixed order by graph_update.
//
// graph_update replaces ::_graph_update_call, in both forms: one weight set,
// or G groups (w [G, C, C], bias, g1, b1 [G, C]; sample s uses group
// s / (B / G), the level-packed layout).  Bound on the
// card: operations (the [B*N, C] x [C, C] product, 25.6 GFLOP at the
// flagship shapes).  Design: the tensor-core tile product of common.cuh
// with an A loader that forms relu(x + LN1(msg)) from x, msg and the
// summed statistics while staging each slice, so y never reaches device
// memory; the epilogue adds the bias, stores z in bf16 and writes the
// block's statistics partial.
#include "common.cuh"

namespace cmpc {

constexpr int kMsgRows = 32;
constexpr int kMsgThreads = 256;
constexpr int kMsgMaxT = 32;
constexpr int kUpdBM = 128;
constexpr int kUpdBN = 64;
using UpdTile = GemmTile<kUpdBM, kUpdBN>;

__global__ void __launch_bounds__(kMsgThreads)
graph_msg_kernel(const bf16* __restrict__ w_aff, const bf16* __restrict__ pooled,
                 bf16* __restrict__ msg, float* __restrict__ stats, int N, int C,
                 int T) {
  __shared__ float ws[kMsgRows * kMsgMaxT];
  __shared__ float red[kMsgThreads / 32];
  const int s = blockIdx.y, rb = blockIdx.x;
  const int row0 = rb * kMsgRows;
  const int nrows = min(kMsgRows, N - row0);
  const size_t grow0 = static_cast<size_t>(s) * N + row0;
  const int pairs = C / 2;

  for (int i = threadIdx.x; i < nrows * T; i += kMsgThreads)
    ws[i] = bf2f(w_aff[grow0 * T + i]);
  __syncthreads();

  // Each thread keeps one column pair of pooled[s] in registers and sweeps
  // the block's rows; w_aff reads are shared-memory broadcasts.
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(
      pooled + static_cast<size_t>(s) * T * C);
  __nv_bfloat162* m2 = reinterpret_cast<__nv_bfloat162*>(msg + grow0 * C);
  float sum = 0.f, sumsq = 0.f;
  for (int cp = threadIdx.x; cp < pairs; cp += kMsgThreads) {
    float2 p[kMsgMaxT];
#pragma unroll
    for (int t = 0; t < kMsgMaxT; ++t)
      if (t < T) p[t] = __bfloat1622float2(p2[t * pairs + cp]);
    for (int r = 0; r < nrows; ++r) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int t = 0; t < kMsgMaxT; ++t) {
        if (t < T) {
          const float wv = ws[r * T + t];
          a0 += wv * p[t].x;
          a1 += wv * p[t].y;
        }
      }
      const __nv_bfloat162 o = __floats2bfloat162_rn(a0, a1);
      m2[static_cast<size_t>(r) * pairs + cp] = o;
      const float2 q = __bfloat1622float2(o);
      sum += q.x + q.y;
      sumsq += q.x * q.x + q.y * q.y;
    }
  }
  sum = block_sum(sum, red);
  sumsq = block_sum(sumsq, red);
  if (threadIdx.x == 0) {
    float* st = stats + (static_cast<size_t>(s) * gridDim.x + rb) * 2;
    st[0] = sum;
    st[1] = sumsq;
  }
}

// A loader of graph_update: relu(bf16(x + bf16(LN1(msg)))) for one row block;
// g1, b1 (the LN1 affine) point to shared memory.
struct UpdateA {
  const bf16* x;
  const bf16* msg;
  const float* g1;
  const float* b1;
  int C;
  int nrows;
  float mean;
  float inv;
  __device__ __forceinline__ uint4 operator()(int r, int k) const {
    if (r >= nrows || k >= C) return zero_vec();
    const size_t o = static_cast<size_t>(r) * C + k;
    const Vec8 xv = as_vec8(*reinterpret_cast<const uint4*>(x + o));
    const Vec8 mv = as_vec8(*reinterpret_cast<const uint4*>(msg + o));
    Vec8 y;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float ln = round_bf((bf2f(mv.v[e]) - mean) * inv * g1[k + e] + b1[k + e]);
      y.v[e] = f2bf(fmaxf(round_bf(bf2f(xv.v[e]) + ln), 0.f));
    }
    return as_uint4(y);
  }
};

__global__ void __launch_bounds__(UpdTile::kThreads, 3)
graph_update_kernel(const bf16* __restrict__ x, const bf16* __restrict__ msg,
                    const float* __restrict__ stats1, int parts1,
                    const bf16* __restrict__ w, const bf16* __restrict__ bias,
                    const float* __restrict__ g1, const float* __restrict__ b1,
                    bf16* __restrict__ z, float* __restrict__ stats2, int N, int C,
                    int per_group) {
  __shared__ __align__(128) unsigned char smem[UpdTile::kSmemBytes];
  __shared__ float red[UpdTile::kThreads / 32];
  __shared__ float ln1[2];
  extern __shared__ float affine[];   // [2][C]: LN1 gamma, beta
  const int s = blockIdx.z, rb = blockIdx.y, ct = blockIdx.x;
  const int row0 = rb * kUpdBM, c0 = ct * kUpdBN;
  const int nrows = min(kUpdBM, N - row0);
  const size_t grow0 = static_cast<size_t>(s) * N + row0;
  const size_t goff = static_cast<size_t>(s / per_group) * C;
  w += goff * C;
  bias += goff;
  g1 += goff;
  b1 += goff;

  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < parts1; ++j) {
      a += stats1[(static_cast<size_t>(s) * parts1 + j) * 2];
      b += stats1[(static_cast<size_t>(s) * parts1 + j) * 2 + 1];
    }
    ln1[0] = a;
    ln1[1] = b;
  }
  for (int c = threadIdx.x; c < C; c += UpdTile::kThreads) {
    affine[c] = g1[c];
    affine[C + c] = b1[c];
  }
  __syncthreads();
  const float cnt = static_cast<float>(N) * static_cast<float>(C);
  const float mean = ln1[0] / cnt;
  const float var = fmaxf(ln1[1] / cnt - mean * mean, 0.f);
  const UpdateA load{x + grow0 * C, msg + grow0 * C, affine, affine + C, C,
                     nrows, mean, rsqrtf(var + 1e-12f)};

  tile_gemm<kUpdBM, kUpdBN>(load, w, C, C, c0, C, smem);
  const float* cs = reinterpret_cast<const float*>(smem);
  float sum = 0.f, sumsq = 0.f;
  for (int e = threadIdx.x; e < kUpdBM * kUpdBN; e += UpdTile::kThreads) {
    const int r = e / kUpdBN, c = e % kUpdBN, col = c0 + c;
    if (r < nrows && col < C) {
      const bf16 zb = f2bf(round_bf(cs[r * UpdTile::kCLd + c]) + bf2f(bias[col]));
      z[(grow0 + r) * C + col] = zb;
      const float q = bf2f(zb);
      sum += q;
      sumsq += q * q;
    }
  }
  sum = block_sum(sum, red);
  sumsq = block_sum(sumsq, red);
  if (threadIdx.x == 0) {
    const size_t part = (static_cast<size_t>(s) * gridDim.y + rb) * gridDim.x + ct;
    stats2[part * 2] = sum;
    stats2[part * 2 + 1] = sumsq;
  }
}

}  // namespace cmpc

extern "C" int cmpc_graph_msg_parts(int N) {
  return (N + cmpc::kMsgRows - 1) / cmpc::kMsgRows;
}

extern "C" int cmpc_graph_update_parts(int N, int C) {
  return ((N + cmpc::kUpdBM - 1) / cmpc::kUpdBM) * ((C + cmpc::kUpdBN - 1) / cmpc::kUpdBN);
}

// w_aff [B*N, T] bf16, pooled [B, T, C] bf16 -> msg [B*N, C] bf16 and
// stats [B, parts, 2] f32 (per-block sum, sum of squares of the bf16 msg).
extern "C" int cmpc_graph_msg(const void* w_aff, const void* pooled, void* msg,
                              void* stats, int B, int N, int C, int T, void* stream) {
  using namespace cmpc;
  if (T > kMsgMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cmpc_graph_msg_parts(N), B);
  graph_msg_kernel<<<grid, kMsgThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w_aff), static_cast<const bf16*>(pooled),
      static_cast<bf16*>(msg), static_cast<float*>(stats), N, C, T);
  return static_cast<int>(cudaGetLastError());
}

// x, msg [B*N, C] bf16; stats1 [B, parts1, 2] f32 (graph_msg's); w
// [G, C, C], bias [G, C] bf16; g1, b1 [G, C] f32 (LN1 affine) -> z [B*N, C]
// bf16 and stats2 [B, update_parts, 2] f32.  G divides B; sample s uses
// group s / (B / G).
extern "C" int cmpc_graph_update(const void* x, const void* msg, const void* stats1,
                                 int parts1, const void* w, const void* bias,
                                 const void* g1, const void* b1, void* z, void* stats2,
                                 int B, int N, int C, int groups, void* stream) {
  using namespace cmpc;
  if (groups < 1 || B % groups) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kUpdBN - 1) / kUpdBN, (N + kUpdBM - 1) / kUpdBM, B);
  graph_update_kernel<<<grid, UpdTile::kThreads, 2 * C * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(msg),
      static_cast<const float*>(stats1), parts1, static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<bf16*>(z), static_cast<float*>(stats2),
      N, C, B / groups);
  return static_cast<int>(cudaGetLastError());
}
