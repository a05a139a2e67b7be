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
// GFLOP at the flagship shapes, against ~97 MB).  Design (csrc/hopper.cuh):
// a block owns 128 rows of one sample and one 64-column chunk c0 of all
// four gates, so its [x | h] rows are read once for the four.  A producer
// warpgroup keeps a 4-stage ring full: the A tile [128 x 64 of K] by
// cp.async (C = 500 rows are 1000 bytes apart, which a TMA tensor map
// refuses: 8-byte copies written into the 128-byte swizzled layout, zeros
// past the sample's rows and past C), and the B tile by TMA, four boxes
// [64 of K x 64 columns] of w as it lies, one per gate, which make one
// N = 256 operand.  Two tensor maps over w, rows 0..C-1 (the x part) and
// rows C..2C-1 (the h part), each zero past its C rows, so the K loop runs
// ceil(C/64) tiles over x, then as many over h, and [x | h] is never
// concatenated.  TMA takes a box only at a 16-byte aligned column, and
// g*C is not one for odd g when C % 8 == 4 (C = 500): gate g's box starts
// box_shift(g) = 4 columns early, at g*C + c0 - 4, and the block owns the
// columns its box covers.  Columns of a neighbouring gate in a box are
// masked in the epilogue; gate o's box past 4C reads zero.  The issuing
// threads wait for their copies, fence them to the async proxy and arrive
// on the stage's full barrier two iterations later, before they wait for
// the next free stage, so copies stay in flight.  Each of two consumer
// warpgroups runs one m64n256k16 wgmma per k16 step into 128 f32
// registers a thread; the epilogue rounds, adds the peepholes (reading c,
// ci and cf as bf16 pairs) and stores bf16 pairs straight from the
// fragment, and sums the statistics per thread, then per warp, then per
// block in a fixed order (no atomics).  Blocks run in pairs along the rows
// (2-block clusters): each loads two of the four weight boxes and
// multicasts them to both (3-4% faster than single blocks at bs=1, 8
// and 64, PERF.md).  At N = 1600 the 13th row tile of each sample is half
// empty (4% of the rows).
//
// raw replaces ::_convlstm_raw_call.  Bound on the card: bytes (reads 4
// gates, c and W_co, writes 2 tensors: 91 MB, 0.027 ms at the flagship's
// bs=8; 12.8 MB, 0.0038 ms at bs=1).  Design: a stream over each sample's
// flat index.  A sample's c, each gate's slice, new_c_raw, o_raw and W_co
// are contiguous runs of N*C elements, so each thread moves VEC-element
// vectors along that index (16 bytes where N*C % 8 == 0, else 8), the
// column of gamma / beta being idx mod C (a 4-element quad never crosses
// a row, as C % 4 == 0) and W_co's index the sample-local one.  The grid
// is sized to the card: (blocks per sample, B) with at most one wave of
// blocks in all, each block a contiguous share of its sample's vectors, so
// the statistic slots stay per sample.  A block first issues its first
// vectors' loads, then sums its sample's gate statistics in parallel (warp
// q sums statistic q over the slots, a fixed-order shuffle tree) and
// stages gamma / beta of j, i, f in shared memory, so no serial chain
// stands before the stream.  Its (sum, sum of squares) of new_c_raw and
// o_raw go to its own slot, per warp and then over the warps in order.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace cmpc {

constexpr int kGateBM = 128;                         // rows per block (2 x 64)
constexpr int kGateBN = 64;                          // columns of each gate
constexpr int kGateN = 4 * kGateBN;                  // wgmma N: the 4 gates
constexpr int kGateStages = 4;
constexpr int kGateLag = 2;   // iterations between a cp.async issue and its arrival
constexpr int kGateCluster = 2;                      // blocks along the rows
constexpr int kGateThreads = 3 * 128;   // 2 consumer warpgroups, 1 producer
constexpr int kGateABytes = kGateBM * kSwizzleBytes;          // [128][64]
constexpr int kGateBoxBytes = kTileK * kSwizzleBytes;         // [64][64]
constexpr int kGateStageBytes = kGateABytes + 4 * kGateBoxBytes;
constexpr int kGateSmem = 1024 + kGateStages * kGateStageBytes;
constexpr int kRawThreads = 256;
constexpr int kRawBlocksPerSM = 3;   // 85 registers a thread at most
constexpr float kForgetBias = 1.f;   // the cell's fixed forget bias

// TMA reads boxes from 16-byte aligned columns only: gate g's boxes start
// this many columns before its chunk (4 when C % 8 == 4, for odd g), and
// the block owns the columns its boxes cover.  ceil(C/64) chunks still
// cover every column: C % 8 == 4 leaves at least 4 columns in the last.
__device__ __forceinline__ int box_shift(int g, int C) { return (g * C) % 8; }

// blockIdx.x: the 64-column chunk, y: the 128-row tile of sample z, in
// clusters of kGateCluster along y.  The grid's y may be padded to whole
// clusters; a padded block loads and computes like the others (its A rows
// read zero), stores no gate and writes zero statistics.
__global__ void __cluster_dims__(1, kGateCluster, 1) __launch_bounds__(kGateThreads, 1)
convlstm_gates_kernel(const __grid_constant__ CUtensorMap wx_map,
                      const __grid_constant__ CUtensorMap wh_map,
                      const bf16* __restrict__ x, const bf16* __restrict__ h,
                      const bf16* __restrict__ c, const bf16* __restrict__ ci,
                      const bf16* __restrict__ cf, bf16* __restrict__ gates,
                      float* __restrict__ stats, int N, int C, int M) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kGateStages], empty[kGateStages];
  __shared__ float red[8][6];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int ct = blockIdx.x, rb = blockIdx.y, s = blockIdx.z;
  const int c0 = ct * kGateBN, row0 = rb * kGateBM;
  const int nrows = max(0, min(kGateBM, N - row0));
  const size_t grow0 = static_cast<size_t>(s) * N + row0;
  const int kx = (C + kTileK - 1) / kTileK;   // k tiles of x, then as many of h
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int q = 0; q < kGateStages; ++q) {
      mbar_init(&full[q], 128 + 1);   // the producer's 128 threads + the TMA bytes
      mbar_init(&empty[q], 2 * kGateCluster);
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (warp >= 8) {
    // producer: all 128 threads copy A; thread 256 also issues this
    // block's two weight boxes (gates rank, rank + 2) to both blocks
    const int tid = threadIdx.x - 256;
    const uint32_t rank = cluster_rank();
    const uint32_t base = smem_u32(smem);
    if (tid == 0) {
      tma_prefetch(&wx_map);
      tma_prefetch(&wh_map);
    }
    const int iters = 2 * kx;
    for (int it = 0; it < iters + kGateLag; ++it) {
      // first publish the stage issued kGateLag iterations ago (its copies
      // are in), then wait for a free stage: the consumers never wait on a
      // stage whose copies landed while the producer sat on an empty barrier
      if (it >= kGateLag) {
        cp_async_wait<kGateLag - 1>();
        fence_proxy_async();
        mbar_arrive(&full[(it - kGateLag) % kGateStages]);
      }
      if (it < iters) {
        const int q = it % kGateStages;
        mbar_wait(&empty[q], ((it / kGateStages) & 1) ^ 1);
        const bool hpart = it >= kx;
        const int k0 = (hpart ? it - kx : it) * kTileK;
        const uint32_t a = base + q * kGateStageBytes;
        if (tid == 0) {
          mbar_arrive_expect_tx(&full[q], 4 * kGateBoxBytes);
          unsigned char* b = smem + q * kGateStageBytes + kGateABytes;
#pragma unroll
          for (int g = rank; g < 4; g += kGateCluster)
            tma_load_2d_mc(b + g * kGateBoxBytes, hpart ? &wh_map : &wx_map, &full[q],
                           g * C - box_shift(g, C) + c0, k0, (1u << kGateCluster) - 1);
        }
        const bf16* src = (hpart ? h : x) + grow0 * C + k0;
        cp_async_tile<kGateBM, kTileK, 128>(a, src, C, nrows, C - k0, x, tid);
      }
      cp_async_commit();   // empty groups in the tail keep the lag's count
    }
    // the tail: until every stage is released by the consumers of both
    // blocks, so no peer arrives at or multicasts into a block that exited
    for (int it = iters; it < iters + kGateStages; ++it)
      mbar_wait(&empty[it % kGateStages], ((it / kGateStages) & 1) ^ 1);
    return;
  }

  // consumers: warpgroup wg owns rows row0 + 64 wg ... + 63
  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const uint32_t base = smem_u32(smem);
  constexpr uint32_t kStepB = (16 * kSwizzleBytes) >> 4;   // 16 rows of K
  float acc[kGateN / 2];
  const int iters = 2 * kx;
  int q = 0;
  for (int it = 0; it < iters; ++it) {
    q = it % kGateStages;
    mbar_wait(&full[q], (it / kGateStages) & 1);
    const uint32_t a = base + q * kGateStageBytes + wg * 64 * kSwizzleBytes;
    const uint32_t b = base + q * kGateStageBytes + kGateABytes;
    wgmma_fence();
    mma_stage<kGateN, 0, 1>(acc, sw128_desc(a, 16, 1024), sw128_desc(b, kGateBoxBytes, 1024),
                            2, kStepB, it == 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0 && wtid < kGateCluster)
      mbar_arrive_remote(&empty[(it + kGateStages - 1) % kGateStages], wtid);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (wtid < kGateCluster) mbar_arrive_remote(&empty[q], wtid);

  // epilogue from the fragment: register 4 (8 g + j) + 2 hf + e holds gate g
  // at row r_lo + 8 hf, column c0 - box_shift(g) + 8 j + 2 (lane % 4) + e;
  // this block owns the gate's columns its box covers (ragged ends masked)
  const int r_lo = wg * 64 + wl * 16 + lane / 4;
  float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r_lo + 8 * hf;
    const bool row_ok = r < nrows;
    // loads from clamped, valid addresses, masked afterwards: the unrolled
    // loads issue together instead of one L2 round trip after another
    const int rc = min(r, max(nrows - 1, 0));
    const size_t grow = grow0 + r;
    const bf16* crow = c + min(grow0 + rc, static_cast<size_t>(M) - 1) * C;
    const bf16* peep[2] = {ci + static_cast<size_t>(min(row0 + rc, N - 1)) * C,
                           cf + static_cast<size_t>(min(row0 + rc, N - 1)) * C};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col_t = c0 - box_shift(g, C) + 2 * (lane % 4);
      bf16* out = gates + (static_cast<size_t>(g) * M + grow) * C;
#pragma unroll
      for (int j = 0; j < kGateBN / 8; ++j) {
        const int col = col_t + 8 * j;
        const bool ok = row_ok && col >= 0 && col < C;
        float y0 = round_bf(acc[4 * (8 * g + j) + 2 * hf]);
        float y1 = round_bf(acc[4 * (8 * g + j) + 2 * hf + 1]);
        if (g == 1 || g == 2) {   // the peepholes of i and f
          const int colc = max(0, min(col, C - 2));
          const float2 cv = ld_bf2(crow + colc), pv = ld_bf2(peep[g - 1] + colc);
          y0 = round_bf(y0 + round_bf(pv.x * cv.x));
          y1 = round_bf(y1 + round_bf(pv.y * cv.y));
        }
        if (!ok) continue;
        st_bf2(out + col, y0, y1);
        if (g < 3) {
          part[2 * g] += y0 + y1;
          part[2 * g + 1] += y0 * y0 + y1 * y1;
        }
      }
    }
  }
  // the block's statistics: per warp, then the 8 consumer warps in order
#pragma unroll
  for (int v = 0; v < 6; ++v) part[v] = warp_sum(part[v]);
  if (lane == 0)
#pragma unroll
    for (int v = 0; v < 6; ++v) red[warp][v] = part[v];
  named_bar_sync(1, 256);
  if (threadIdx.x < 6) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[w][threadIdx.x];
    const size_t p = (static_cast<size_t>(s) * gridDim.y + rb) * gridDim.x + ct;
    stats[p * 6 + threadIdx.x] = t;
  }
}

__device__ __forceinline__ float logistic(float v) { return 1.f / (1.f + expf(-v)); }

// blockIdx.y: the sample s, x: the block's share of its VEC-element
// vectors [x per_block, (x + 1) per_block).  Dynamic shared memory: gamma
// then beta of j, i, f, [6][C] f32.
template <int VEC>
__global__ void __launch_bounds__(kRawThreads, kRawBlocksPerSM)
convlstm_raw_kernel(const bf16* __restrict__ gates, const bf16* __restrict__ c,
                    const bf16* __restrict__ co, const float* __restrict__ stats,
                    int parts, const float* __restrict__ gamma,
                    const float* __restrict__ beta, bf16* __restrict__ ncr,
                    bf16* __restrict__ oraw, float* __restrict__ stats2, int L, int C,
                    float cnt, size_t ML, int per_block) {
  extern __shared__ __align__(16) float gb[];
  __shared__ float tot[6];
  __shared__ float red[kRawThreads / 32][4];
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v0 = blockIdx.x * per_block;
  const int v1 = min(L / VEC, v0 + per_block);
  const size_t base = static_cast<size_t>(s) * L;   // the sample's first element

  // gates j, i, f, o, then c and W_co, at vector idx
  BfBitsT<VEC> in[6];
  auto load = [&](int idx) {
    const size_t e = static_cast<size_t>(idx) * VEC, o = base + e;
#pragma unroll
    for (int g = 0; g < 4; ++g) in[g] = *reinterpret_cast<const BfBitsT<VEC>*>(gates + g * ML + o);
    in[4] = *reinterpret_cast<const BfBitsT<VEC>*>(c + o);
    in[5] = *reinterpret_cast<const BfBitsT<VEC>*>(co + e);
  };
  const int first = v0 + threadIdx.x;
  if (first < v1) load(first);

  // the sample's gate statistics, warp q < 6 on statistic q; gamma, beta
  if (warp < 6) {
    float a = 0.f;
    for (int p = lane; p < parts; p += 32)
      a += stats[(static_cast<size_t>(s) * parts + p) * 6 + warp];
    a = warp_sum(a);
    if (lane == 0) tot[warp] = a;
  }
  for (int i = threadIdx.x; i < 3 * C; i += kRawThreads) {
    gb[i] = gamma[i];
    gb[3 * C + i] = beta[i];
  }
  __syncthreads();
  float mean[3], inv[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    mean[q] = tot[2 * q] / cnt;
    const float var = fmaxf(tot[2 * q + 1] / cnt - mean[q] * mean[q], 0.f);
    inv[q] = rsqrtf(var + 1e-12f);
  }

  float s_c = 0.f, q_c = 0.f, s_o = 0.f, q_o = 0.f;
  for (int idx = first; idx < v1; idx += kRawThreads) {
    if (idx != first) load(idx);
    const int col0 = static_cast<int>((static_cast<size_t>(idx) * VEC) % C);
    BfBitsT<VEC> nc_bits, ov_bits;
#pragma unroll
    for (int q4 = 0; q4 < VEC / 4; ++q4) {
      // quad q4: 4 elements of one row (C % 4 == 0), its columns from cq
      const int cq = col0 + 4 * q4 < C ? col0 + 4 * q4 : col0 + 4 * q4 - C;
      // the layer norms and gate activations of j, i, f in f32
      float x[3][4];
#pragma unroll
      for (int t = 0; t < 3; ++t) unpack_bf<4>(reinterpret_cast<const uint2*>(&in[t])[q4], x[t]);
      float ga[3][4], be[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        *reinterpret_cast<float4*>(ga[q]) = *reinterpret_cast<const float4*>(gb + q * C + cq);
        *reinterpret_cast<float4*>(be[q]) = *reinterpret_cast<const float4*>(gb + (3 + q) * C + cq);
      }
      float jn[4], is[4], fs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        jn[e] = tanhf((x[0][e] - mean[0]) * inv[0] * ga[0][e] + be[0][e]);
        is[e] = logistic((x[1][e] - mean[1]) * inv[1] * ga[1][e] + be[1][e]);
        fs[e] = logistic((x[2][e] - mean[2]) * inv[2] * ga[2][e] + be[2][e] + kForgetBias);
      }
      // the cell and output updates in bf16 pairs: a product or sum of two
      // bf16 values rounded once to bf16 is the f32 result rounded to bf16
      // (the _rn forms keep the compiler from fusing a product into an add)
      const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&in[3]) + 2 * q4;
      const uint32_t* c2 = reinterpret_cast<const uint32_t*>(&in[4]) + 2 * q4;
      const uint32_t* co2 = reinterpret_cast<const uint32_t*>(&in[5]) + 2 * q4;
      uint32_t nc2[2], ov2[2];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int e = 2 * pr;
        const __nv_bfloat162 n =
            __hadd2_rn(__hmul2_rn(bits_bf2(c2[pr]), __floats2bfloat162_rn(fs[e], fs[e + 1])),
                       __hmul2_rn(__floats2bfloat162_rn(is[e], is[e + 1]),
                                  __floats2bfloat162_rn(jn[e], jn[e + 1])));
        const __nv_bfloat162 ov = __hadd2_rn(bits_bf2(o2[pr]), __hmul2_rn(bits_bf2(co2[pr]), n));
        nc2[pr] = bf2_bits(n);
        ov2[pr] = bf2_bits(ov);
        const float2 nf = __bfloat1622float2(n), of = __bfloat1622float2(ov);
        s_c += nf.x + nf.y;
        q_c += nf.x * nf.x + nf.y * nf.y;
        s_o += of.x + of.y;
        q_o += of.x * of.x + of.y * of.y;
      }
      reinterpret_cast<uint2*>(&nc_bits)[q4] = make_uint2(nc2[0], nc2[1]);
      reinterpret_cast<uint2*>(&ov_bits)[q4] = make_uint2(ov2[0], ov2[1]);
    }
    const size_t o = base + static_cast<size_t>(idx) * VEC;
    *reinterpret_cast<BfBitsT<VEC>*>(ncr + o) = nc_bits;
    *reinterpret_cast<BfBitsT<VEC>*>(oraw + o) = ov_bits;
  }
  // the block's statistics: per warp, then the warps in order
  float part[4] = {warp_sum(s_c), warp_sum(q_c), warp_sum(s_o), warp_sum(q_o)};
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) red[warp][q] = part[q];
  __syncthreads();
  if (threadIdx.x < 4) {
    float t = 0.f;
    for (int w = 0; w < kRawThreads / 32; ++w) t += red[w][threadIdx.x];
    stats2[(static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 4 + threadIdx.x] = t;
  }
}

using RawKernel = decltype(&convlstm_raw_kernel<8>);

// Blocks per sample: at most one wave of blocks in all (the blocks of the
// 16-byte form that fit on the card at once), at least one, and no more
// than one 8-element vector per thread; the same for either vector width.
inline int raw_parts(int B, int N, int C) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, convlstm_raw_kernel<8>, kRawThreads,
          6 * static_cast<size_t>(C) * sizeof(float)) != cudaSuccess)
    return 0;
  const long long cap = (static_cast<long long>(N) * C + 8 * kRawThreads - 1) /
                        (8 * kRawThreads);
  const long long wave = static_cast<long long>(sms) * std::max(per_sm, 1);
  return static_cast<int>(std::max(1LL, std::min(cap, wave / std::max(B, 1))));
}

}  // namespace cmpc

// Row tiles of a sample, padded to whole clusters.
static int gate_row_tiles(int N) {
  const int tiles = (N + cmpc::kGateBM - 1) / cmpc::kGateBM;
  return (tiles + cmpc::kGateCluster - 1) / cmpc::kGateCluster * cmpc::kGateCluster;
}

extern "C" int cmpc_convlstm_gates_parts(int N, int C) {
  return gate_row_tiles(N) * ((C + cmpc::kGateBN - 1) / cmpc::kGateBN);
}

// Statistic slots per sample of the raw kernel (blocks per sample), 0 if
// the card cannot be queried.
extern "C" int cmpc_convlstm_raw_parts(int B, int N, int C) {
  return cmpc::raw_parts(B, N, C);
}

// x, h, c [B*N, C] bf16; w [2C, 4C] bf16 (gate g in columns g*C..g*C+C-1,
// order j, i, f, o); ci, cf [N, C] bf16 -> gates [4, B*N, C] bf16 and
// stats [B, gates_parts, 3, 2] f32 (sum, sum of squares of j, i, f).
// C must be a multiple of 4 (8-byte rows); w 16-byte aligned (TMA).
extern "C" int cmpc_convlstm_gates(const void* x, const void* h, const void* c,
                                   const void* w, const void* ci, const void* cf,
                                   void* gates, void* stats, int B, int N, int C,
                                   void* stream) {
  using namespace cmpc;
  if (C % 4) return static_cast<int>(cudaErrorInvalidValue);
  // w's x rows and h rows as two [C][4C] maps, each zero past its C rows
  const uint64_t dims[2] = {static_cast<uint64_t>(4 * C), static_cast<uint64_t>(C)};
  const uint64_t strides[1] = {static_cast<uint64_t>(4 * C) * sizeof(bf16)};
  const uint32_t box[2] = {kChunk, kTileK};
  CUtensorMap wx_map, wh_map;
  int rc = encode_tmap(&wx_map, w, 2, dims, strides, box);
  if (rc) return rc;
  rc = encode_tmap(&wh_map, static_cast<const bf16*>(w) + static_cast<size_t>(C) * 4 * C, 2,
                   dims, strides, box);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      convlstm_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGateSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kGateBN - 1) / kGateBN, gate_row_tiles(N), B);
  convlstm_gates_kernel<<<grid, kGateThreads, kGateSmem, static_cast<cudaStream_t>(stream)>>>(
      wx_map, wh_map, static_cast<const bf16*>(x), static_cast<const bf16*>(h),
      static_cast<const bf16*>(c), static_cast<const bf16*>(ci), static_cast<const bf16*>(cf),
      static_cast<bf16*>(gates), static_cast<float*>(stats), N, C, B * N);
  return static_cast<int>(cudaGetLastError());
}

// gates [4, B*N, C] bf16 and stats [B, parts, 3, 2] f32 (convlstm_gates');
// c [B*N, C], co [N, C] bf16; gamma, beta [5, C] f32 (layer norms j, i, f,
// o, c; rows 0-2 used) -> new_c_raw, o_raw [B*N, C] bf16 and stats2
// [B, raw_parts, 2, 2] f32 (sum, sum of squares of new_c_raw, then o_raw).
// C must be a multiple of 4; the bf16 tensors 8-byte aligned.  The layer
// norms count N * width elements per sample: columns width..C-1 are zero
// padding (zero gates, peepholes, gamma and beta), which adds nothing to
// the sums.
extern "C" int cmpc_convlstm_raw(const void* gates, const void* c, const void* co,
                                 const void* stats, int parts, const void* gamma,
                                 const void* beta, void* ncr, void* oraw, void* stats2,
                                 int B, int N, int C, int width, void* stream) {
  using namespace cmpc;
  if (C % 4 || width < 1 || width > C) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = raw_parts(B, N, C);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(gates) | reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(co) | reinterpret_cast<uintptr_t>(ncr) |
                         reinterpret_cast<uintptr_t>(oraw);
  if (addr % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  const int L = N * C;
  const int vec = (L % 8 == 0 && addr % 16 == 0) ? 8 : 4;
  const RawKernel kernel = vec == 8 ? convlstm_raw_kernel<8> : convlstm_raw_kernel<4>;
  const int smem = 6 * C * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nvec = L / vec;
  const dim3 grid(blocks, B);
  kernel<<<grid, kRawThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gates), static_cast<const bf16*>(c),
      static_cast<const bf16*>(co), static_cast<const float*>(stats), parts,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(ncr), static_cast<bf16*>(oraw), static_cast<float*>(stats2), L, C,
      static_cast<float>(N) * static_cast<float>(width), static_cast<size_t>(B) * L,
      (nvec + blocks - 1) / blocks);
  return static_cast<int>(cudaGetLastError());
}
