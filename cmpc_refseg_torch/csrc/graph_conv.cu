// Graph convolution over the factored adjacency (CMPC_model.py:359-374):
//   msg = w_aff @ pooled                       (graph_msg)
//   z   = relu(x + LN1(msg)) @ W + b           (graph_update)
// each with the whole-sample layer-norm statistics (sum, sum of squares) of
// its bf16-rounded output.  The final relu(LN2(z)) and pooled = v_aff^T @ x
// stay plain PyTorch, as the JAX package leaves them to XLA.
//
// graph_msg replaces cmpc_refseg_tpu/ops/pallas_kernels.py::_graph_msg_call.
// Bound on the card: bytes (2*T = 40 FLOP per 2-byte output element; the
// [B*N, C] bf16 store dominates, 77 MB at the flagship bs=8 packed shapes).
// Design: a block takes 32 rows of one sample; each thread keeps the sums of
// one column pair for all 32 rows in registers and sweeps the words in
// chunks of 32 (any T): per chunk the rows' w_aff slice is staged in shared
// memory (read as broadcasts) and the column pair of pooled [T, C] in
// registers; the sums are rounded to bf16 once and written as coalesced
// pairs.  The block's (sum, sum of squares) partial goes to its own slot,
// so the statistics need no atomics and are summed in a fixed order by
// graph_update.
//
// graph_update replaces ::_graph_update_call, in both forms: one weight set,
// or G groups (w [G, C, C], bias, g1, b1 [G, C]; sample s uses group
// s / (B / G), the level-packed layout).  Bound on the card: operations
// (the [B*N, C] x [C, C] product, 205 GFLOP at bs=64, against ~620 MB).
// Design (csrc/hopper.cuh): a block owns 128 rows of one sample x 256
// output columns (4 blocks cover C = 1000).  Thread 0 keeps a 3-stage ring
// of TMA loads in flight, refilling each stage as soon as both consumer
// warpgroups are done with it: the x and msg tiles [128 x 64 of K]
// through 3D maps [B][N][C] (zero past the sample's rows and past C) and
// the W boxes [64 of K x 64 columns] x 4 (N-major, trans-b).  The A operand
// y = relu(bf16(x + bf16(LN1(msg)))) is formed on chip: each consumer
// warpgroup rewrites its 64 rows of the next stage's x tile in place (x,
// msg and y share the 128-byte swizzled layout, so the map from bytes to
// columns is the same) while the tensor cores run this stage's wgmmas,
// fences it to the async proxy and syncs the warpgroup, so each y element
// is formed once per block (4x per row tile, not 16x) and never reaches
// device memory.  A stage is released as soon as its wgmmas are done,
// before the next stage's transform waits for data, so the refill overlaps
// the transform.  Two consumer warpgroups run m64n256k16 wgmmas into 128
// f32 registers a thread; the epilogue rounds and adds the bias from the
// fragment, stages z swizzled in the (then free) ring for TMA stores, and
// sums the block's statistics per warp, then over the 8 warps in order (no
// atomics).  Row tiles stay inside one sample (N = 1600 is 12.5 tiles: the
// 13th is half empty), so the LN1 constants and the weight group are per
// block.  Clusters of 4 blocks multicasting the x and msg boxes measured
// 7% slower at bs=64 (4-block clusters of one block per SM keep only 120
// of the 132 SMs busy; PERF.md).
#include "common.cuh"
#include "hopper.cuh"

namespace cmpc {

constexpr int kMsgRows = 32;
constexpr int kMsgThreads = 256;
constexpr int kMsgChunk = 32;   // words staged at a time

__global__ void __launch_bounds__(kMsgThreads)
graph_msg_kernel(const bf16* __restrict__ w_aff, const bf16* __restrict__ pooled,
                 bf16* __restrict__ msg, float* __restrict__ stats, int N, int C,
                 int T) {
  __shared__ float ws[kMsgRows * kMsgChunk];
  __shared__ float red[kMsgThreads / 32];
  const int s = blockIdx.y, rb = blockIdx.x;
  const int row0 = rb * kMsgRows;
  const int nrows = min(kMsgRows, N - row0);
  const size_t grow0 = static_cast<size_t>(s) * N + row0;
  const int pairs = C / 2;

  // Each thread keeps one column pair's sums for all the block's rows in
  // registers and sweeps the words in chunks: the rows' w_aff chunk is
  // staged in shared memory (read as broadcasts), the column pair's pooled
  // chunk in registers.  The sums are rounded to bf16 once, at the end.
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(
      pooled + static_cast<size_t>(s) * T * C);
  __nv_bfloat162* m2 = reinterpret_cast<__nv_bfloat162*>(msg + grow0 * C);
  float sum = 0.f, sumsq = 0.f;
  for (int cp0 = 0; cp0 < pairs; cp0 += kMsgThreads) {   // the same trip count in every thread
    const int cp = cp0 + threadIdx.x;
    const bool active = cp < pairs;
    float a0[kMsgRows], a1[kMsgRows];
#pragma unroll
    for (int r = 0; r < kMsgRows; ++r) a0[r] = a1[r] = 0.f;
    for (int t0 = 0; t0 < T; t0 += kMsgChunk) {
      const int tn = min(kMsgChunk, T - t0);
      __syncthreads();   // the previous chunk's reads are done
      for (int i = threadIdx.x; i < kMsgRows * kMsgChunk; i += kMsgThreads) {
        const int r = i / kMsgChunk, t = i % kMsgChunk;
        ws[i] = r < nrows && t < tn ? bf2f(w_aff[(grow0 + r) * T + t0 + t]) : 0.f;
      }
      __syncthreads();
      float2 p[kMsgChunk];
#pragma unroll
      for (int t = 0; t < kMsgChunk; ++t)
        p[t] = active && t < tn ? __bfloat1622float2(p2[static_cast<size_t>(t0 + t) * pairs + cp])
                                : make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMsgRows; ++r) {
#pragma unroll
        for (int t = 0; t < kMsgChunk; ++t) {
          const float wv = ws[r * kMsgChunk + t];
          a0[r] += wv * p[t].x;
          a1[r] += wv * p[t].y;
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int r = 0; r < kMsgRows; ++r) {
      if (r >= nrows) break;
      const __nv_bfloat162 o = __floats2bfloat162_rn(a0[r], a1[r]);
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

// graph_update.  blockIdx.x: the 256-column block, y: the 128-row tile of
// sample z.  Two consumer warpgroups of 64 rows; thread 0 also issues the
// TMA loads (a third warpgroup would cap the registers at 168 a thread).
constexpr int kUpdBM = 128;
constexpr int kUpdBN = 256;
constexpr int kUpdStages = 3;
constexpr int kUpdThreads = 2 * 128;   // two consumer warpgroups
constexpr int kUpdBox = kTileK * kSwizzleBytes;        // [64][64] bf16
constexpr int kUpdTile = kUpdBM * kSwizzleBytes;       // [128][64] bf16: x or msg
constexpr int kUpdStage = 2 * kUpdTile + (kUpdBN / kChunk) * kUpdBox;
constexpr int kUpdSmem = 1024 + kUpdStages * kUpdStage;   // + the LN1 affine [2][C] f32
constexpr int kUpdMaxC = 4096;

__global__ void __launch_bounds__(kUpdThreads, 1)
graph_update_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap msg_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap z_map,
                    const float* __restrict__ stats1, int parts1,
                    const bf16* __restrict__ bias, const float* __restrict__ g1,
                    const float* __restrict__ b1, float* __restrict__ stats2, int N,
                    int C, int per_group) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kUpdStages], empty[kUpdStages];
  __shared__ float red[8][2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int ct = blockIdx.x, rb = blockIdx.y, s = blockIdx.z;
  const int c0 = ct * kUpdBN, row0 = rb * kUpdBM;
  const int grp = s / per_group;
  const int ktiles = (C + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int q = 0; q < kUpdStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], 2);   // both consumer warpgroups
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0 also issues the TMA loads: stage it % kUpdStages receives the
  // x and msg boxes of the row tile (two of 64 rows each) and the four W
  // boxes of the block's columns
  auto issue = [&](int it) {
    const int q = it % kUpdStages;
    unsigned char* st = smem + q * kUpdStage;
    const int k0 = it * kTileK;
    mbar_arrive_expect_tx(&full[q], kUpdStage);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      tma_load_3d(st + b * kUpdBox, b < 2 ? &x_map : &msg_map, &full[q], k0,
                  row0 + (b % 2) * 64, s);
#pragma unroll
    for (int j = 0; j < kUpdBN / kChunk; ++j)
      tma_load_3d(st + 2 * kUpdTile + j * kUpdBox, &w_map, &full[q], c0 + j * kChunk, k0,
                  grp);
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < kUpdStages && it < ktiles; ++it) issue(it);

  // consumers: warpgroup wg owns rows row0 + 64 wg ... + 63.  It forms
  // its rows of y = relu(bf16(x + bf16(LN1(msg)))) over the next stage's x
  // tile in place (x, msg and y share the swizzled layout) while the
  // tensor cores work on this stage: thread wtid rewrites the 16-byte
  // group wtid % 8 of rows wtid / 8 + 16 i, i < 4, which holds columns
  // k0 + 8 kq ... + 7 in every stage (kq below; zero past C).  The LN1
  // affine of the weight group is staged in shared memory.
  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const uint32_t base = smem_u32(smem);
  float* affine = reinterpret_cast<float*>(smem + kUpdStages * kUpdStage);   // [2][C]
  for (int c = threadIdx.x; c < C; c += 256) {
    affine[c] = g1[static_cast<size_t>(grp) * C + c];
    affine[C + c] = b1[static_cast<size_t>(grp) * C + c];
  }
  float mean, inv;
  {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < parts1; ++j) {
      sa += stats1[(static_cast<size_t>(s) * parts1 + j) * 2];
      sb += stats1[(static_cast<size_t>(s) * parts1 + j) * 2 + 1];
    }
    const float cnt = static_cast<float>(N) * static_cast<float>(C);
    mean = sa / cnt;
    inv = rsqrtf(fmaxf(sb / cnt - mean * mean, 0.f) + 1e-12f);
  }
  named_bar_sync(3, 256);   // the affine is staged
  const int kq = (wtid % 8) ^ ((wtid / 8) % 8);
  const int xoff = (wg * 64 + wtid / 8) * kSwizzleBytes + 16 * (wtid % 8);
  auto transform = [&](int it) {
    unsigned char* xs = smem + (it % kUpdStages) * kUpdStage + xoff;
    const int k = it * kTileK + 8 * kq;
    const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4* px = reinterpret_cast<uint4*>(xs + i * 16 * kSwizzleBytes);
      uint4 out = zero_vec();
      if (k < C) {
        const uint4 xv = *px;
        const uint4 mv = *reinterpret_cast<const uint4*>(xs + kUpdTile + i * 16 * kSwizzleBytes);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
        const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
        uint32_t yw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 m = __bfloat1622float2(bits_bf2(mw[e]));
          const float2 ga = *reinterpret_cast<const float2*>(affine + k + 2 * e);
          const float2 be = *reinterpret_cast<const float2*>(affine + C + k + 2 * e);
          const __nv_bfloat162 ln = __floats2bfloat162_rn((m.x - mean) * inv * ga.x + be.x,
                                                          (m.y - mean) * inv * ga.y + be.y);
          yw[e] = bf2_bits(__hmax2(__hadd2(bits_bf2(xw[e]), ln), zero2));
        }
        out = make_uint4(yw[0], yw[1], yw[2], yw[3]);
      }
      *px = out;
    }
  };

  // Stage it - 1 is released right after this stage's wgmmas are issued
  // (wait<1>), before the next stage's transform waits for its data, so
  // the producer's refill overlaps the transform.
  constexpr uint32_t kStepB = (16 * kSwizzleBytes) >> 4;   // 16 rows of K
  float acc[kUpdBN / 2];
  mbar_wait(&full[0], 0);
  transform(0);
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);
  int q = 0;
  for (int it = 0; it < ktiles; ++it) {
    q = it % kUpdStages;
    const uint32_t a = base + q * kUpdStage + wg * kUpdBox;
    const uint32_t b = base + q * kUpdStage + 2 * kUpdTile;
    wgmma_fence();
    mma_stage<kUpdBN, 0, 1>(acc, sw128_desc(a, 16, 1024), sw128_desc(b, kUpdBox, 1024), 2,
                            kStepB, it == 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0) {   // stage it - 1 is done: refill it with stage it - 1 + kUpdStages
      const int qp = (it - 1) % kUpdStages;
      if (wtid == 0) mbar_arrive(&empty[qp]);
      if (threadIdx.x == 0 && it - 1 + kUpdStages < ktiles) {
        mbar_wait(&empty[qp], ((it - 1) / kUpdStages) & 1);
        issue(it - 1 + kUpdStages);
      }
    }
    if (it + 1 < ktiles) {   // the next stage's y, while this stage's wgmmas run
      mbar_wait(&full[(it + 1) % kUpdStages], ((it + 1) / kUpdStages) & 1);
      transform(it + 1);
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue from the fragment: register 4 j + 2 hf + e holds row
  // r_lo + 8 hf, column c0 + 8 j + 2 (lane % 4) + e.  z goes through the
  // (now free) ring as four [128 x 64] swizzled sub-tiles, written to
  // device memory by TMA stores (rows past N and columns past C clipped).
  named_bar_sync(3, 256);   // both warpgroups are done reading the ring
  const int nrows = min(kUpdBM, N - row0);
  const int r_lo = wg * 64 + wl * 16 + lane / 4;
  const int col_t = c0 + 2 * (lane % 4);
  const bf16* bg = bias + static_cast<size_t>(grp) * C;
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r_lo + 8 * hf;
    unsigned char* zrow = smem + r * kSwizzleBytes + 4 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kUpdBN / 8; ++j) {
      const int col = col_t + 8 * j;
      const float2 bb = ld_bf2(bg + min(col, C - 2));
      const float z0 = round_bf(round_bf(acc[4 * j + 2 * hf]) + bb.x);
      const float z1 = round_bf(round_bf(acc[4 * j + 2 * hf + 1]) + bb.y);
      *reinterpret_cast<__nv_bfloat162*>(zrow + (j / 8) * kUpdTile +
                                         (((j % 8) ^ (r % 8)) << 4)) =
          __floats2bfloat162_rn(z0, z1);
      if (r < nrows && col < C) {
        sum += z0 + z1;
        sumsq += z0 * z0 + z1 * z1;
      }
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);
  if (wtid == 0 && row0 + 64 * wg < N) {
    for (int j = 0; j < kUpdBN / kChunk && c0 + j * kChunk < C; ++j)
      tma_store_3d(&z_map, smem + j * kUpdTile + wg * kUpdBox, c0 + j * kChunk,
                   row0 + 64 * wg, s);
    bulk_commit();
  }
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  if (lane == 0) {
    red[warp][0] = sum;
    red[warp][1] = sumsq;
  }
  named_bar_sync(3, 256);
  if (threadIdx.x < 2) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[w][threadIdx.x];
    const size_t part = (static_cast<size_t>(s) * gridDim.y + rb) * gridDim.x + ct;
    stats2[part * 2 + threadIdx.x] = t;
  }
  if (wtid == 0) bulk_wait_read();   // the stores have read shared memory
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
// C even.
extern "C" int cmpc_graph_msg(const void* w_aff, const void* pooled, void* msg,
                              void* stats, int B, int N, int C, int T, void* stream) {
  using namespace cmpc;
  const dim3 grid(cmpc_graph_msg_parts(N), B);
  graph_msg_kernel<<<grid, kMsgThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w_aff), static_cast<const bf16*>(pooled),
      static_cast<bf16*>(msg), static_cast<float*>(stats), N, C, T);
  return static_cast<int>(cudaGetLastError());
}

// x, msg [B*N, C] bf16; stats1 [B, parts1, 2] f32 (graph_msg's); w
// [G, C, C], bias [G, C] bf16; g1, b1 [G, C] f32 (LN1 affine) -> z [B*N, C]
// bf16 and stats2 [B, update_parts, 2] f32.  G divides B; sample s uses
// group s / (B / G).  x, msg, w and z 16-byte aligned, C a multiple of 8
// (TMA strides) and at most kUpdMaxC (the LN1 affine in shared memory).
extern "C" int cmpc_graph_update(const void* x, const void* msg, const void* stats1,
                                 int parts1, const void* w, const void* bias,
                                 const void* g1, const void* b1, void* z, void* stats2,
                                 int B, int N, int C, int groups, void* stream) {
  using namespace cmpc;
  if (groups < 1 || B % groups || C % 8 || C > kUpdMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t bf = sizeof(bf16);
  CUtensorMap x_map, msg_map, w_map, z_map;
  const uint32_t box[3] = {kChunk, 64, 1};
  // [B][N][C] innermost first: a row tile's boxes read zero past its sample
  const uint64_t x_dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(N),
                              static_cast<uint64_t>(B)};
  const uint64_t x_strides[2] = {C * bf, static_cast<uint64_t>(N) * C * bf};
  int rc = encode_tmap(&x_map, x, 3, x_dims, x_strides, box);
  if (rc) return rc;
  rc = encode_tmap(&msg_map, msg, 3, x_dims, x_strides, box);
  if (rc) return rc;
  const uint64_t w_dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(C),
                              static_cast<uint64_t>(groups)};
  const uint64_t w_strides[2] = {C * bf, static_cast<uint64_t>(C) * C * bf};
  rc = encode_tmap(&w_map, w, 3, w_dims, w_strides, box);
  if (rc) return rc;
  rc = encode_tmap(&z_map, z, 3, x_dims, x_strides, box);
  if (rc) return rc;
  const int smem = kUpdSmem + 2 * C * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      graph_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kUpdBN - 1) / kUpdBN, (N + kUpdBM - 1) / kUpdBM, B);
  graph_update_kernel<<<grid, kUpdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x_map, msg_map, w_map, z_map, static_cast<const float*>(stats1), parts1,
      static_cast<const bf16*>(bias), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<float*>(stats2), N, C, B / groups);
  return static_cast<int>(cudaGetLastError());
}
