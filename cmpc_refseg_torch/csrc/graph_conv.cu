// Graph convolution over the factored adjacency (CMPC_model.py:359-374):
//   msg = w_aff @ pooled                       (graph_msg)
//   z   = relu(x + LN1(msg)) @ W + b           (graph_update)
// each with the whole-sample layer-norm statistics (sum, sum of squares) of
// its bf16-rounded output.  The final relu(LN2(z)) and pooled = v_aff^T @ x
// stay plain PyTorch, as the JAX package leaves them to XLA.
//
// graph_msg replaces cmpc_refseg_tpu/ops/pallas_kernels.py::_graph_msg_call.
// Bound on the card: bytes (the [B*N, C] bf16 store, 77 MB at the flagship
// bs=8 packed shapes).  At T = 20 each 2-byte output takes 40 FLOP, so on
// the f32 pipes the product alone would need the card's whole 67 TFLOP/s
// to keep up with 3.35 TB/s: it runs on the tensor cores, mma.sync
// m16n8k16 (bf16 in, f32 sums; K is T rounded up to 16, zero past T in
// both operands), whose register fragments suit the epilogue below.
// Design: one persistent block per SM walks a contiguous range of (sample,
// 32-row group) pairs.  Its producer thread loads pooled's boxes [32 words
// x 64 columns] by TMA (zero past T and C; kept resident while the block
// stays in one sample) and copies each row tile's w_aff rows (2T bytes:
// too narrow for TMA) by one 1-D bulk copy into a 4-stage ring.  8
// consumer warps take two 64-column chunks each: a warp gathers its A
// fragments (two m16 tiles) from the w_aff stage once per tile, reads B
// by ldmatrix.trans and stages each rounded [32 x 64] result in msg's own
// row layout; the block then stores the tile's 32 whole rows (64 KB) by one
// 1-D bulk copy, double-buffered.  Whole rows because rows of 2000 bytes
// start off the 128-byte lines: stores cut at 64-column boundaries (2D
// TMA boxes) measured 1.7x slower.  The statistics come from the rounded
// fragments: row sums by a product with ones on the tensor cores, sums of
// squares by one fma a value; per warp by shuffles, then over the warps
// in order into the group's own slot (no atomics: two launches agree bit
// for bit).  Tried and slower (PERF.md): 2D box stores from per-warp
// tiles, 16 consumer warps, 16-row tiles, one block per group, pooled
// streamed per tile, squares on the tensor cores, sums on the f32 pipes.
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

constexpr int kMsgWarps = 8;                  // consumer warps
constexpr int kMsgThreads = 32 * (kMsgWarps + 1);   // + the producer warp
constexpr int kMsgGroupRows = 32;             // rows of one statistics slot
constexpr int kMsgMaxK = 64;                  // words of one pooled box at most
constexpr int kMsgMaxSlots = 64;              // pooled boxes in shared memory at most
constexpr int kMsgAStages = 4;                // tiles of w_aff rows in flight
constexpr int kMsgMaxC = 4096;
constexpr int kMsgSmemMax = 230400;           // dynamic shared memory (227 KB less static)

// How a launch lays out shared memory.  A row tile is mt m16 tiles: 32
// rows (one statistics group) or, where two [32 x C] staging buffers do
// not fit, 16.  pooled: boxes of [kbox words x 64 columns] (128-byte
// swizzled), kchunks of them down T for each chunk of 64 columns;
// consumer warp w uses the boxes of chunks w, w + 8, ....  When all
// `boxes` fit, they stay resident, each in its own slot, and are loaded
// once per sample a block visits; else each warp streams its boxes
// through a ring of `ring` slots of its own for every row tile.  Either
// way a slot serves one warp only, so a warp never waits on a slot two
// loads ahead of it (an mbarrier's parity tells only one phase from the
// next).  a_bytes: one stage of a tile's w_aff rows (16 mt T bf16, from
// the 16-byte bound below them).  nbuf: msg staging buffers of [16 mt x
// C] (two, so a tile's store drains while the next is formed, when they
// fit).  smem = 0: C and T do not fit.
struct MsgPlan {
  int mt, kbox, kchunks, chunks, boxes, ring, a_bytes, nbuf, smem;
};

inline MsgPlan msg_plan(int C, int T) {
  MsgPlan p;
  p.kbox = T < kMsgMaxK ? (T + 15) / 16 * 16 : kMsgMaxK;
  p.kchunks = (T + p.kbox - 1) / p.kbox;
  p.chunks = (C + kChunk - 1) / kChunk;
  p.boxes = p.chunks * p.kchunks;
  const int box_bytes = p.kbox * kSwizzleBytes;
  const int row = C * static_cast<int>(sizeof(bf16));
  auto a_bytes = [&](int mt) {
    return (16 * mt * T * static_cast<int>(sizeof(bf16)) + 31) / 16 * 16;
  };
  p.mt = 1024 + kMsgAStages * a_bytes(2) + 2 * 32 * row + kMsgWarps * box_bytes <= kMsgSmemMax
             ? 2 : 1;
  p.a_bytes = a_bytes(p.mt);
  const int stage = 16 * p.mt * row;
  const int fixed = 1024 + kMsgAStages * p.a_bytes;
  p.nbuf = fixed + 2 * stage + kMsgWarps * box_bytes <= kMsgSmemMax ? 2 : 1;
  int fit = (kMsgSmemMax - fixed - p.nbuf * stage) / box_bytes;
  fit = fit < kMsgMaxSlots ? fit : kMsgMaxSlots;
  p.ring = p.boxes <= fit ? 0 : fit / kMsgWarps;   // 0: resident
  const int slots = p.ring ? kMsgWarps * p.ring : p.boxes;
  p.smem = p.boxes <= fit || p.ring > 0 ? fixed + slots * box_bytes + p.nbuf * stage : 0;
  return p;
}

// The row tiles of a block in order: tile i of group grp of sample s
// holds rows grp * 32 + 16 mt i ... of sample s, if it starts below N.
struct MsgTile {
  int g, s, grp, i;   // g = s * parts + grp
  __device__ void next(int parts, int N, int tile_rows) {
    if (++i < kMsgGroupRows / tile_rows && grp * kMsgGroupRows + i * tile_rows < N) return;
    i = 0;
    ++g;
    if (++grp == parts) {
      grp = 0;
      ++s;
    }
  }
};

// One persistent block per SM walks a contiguous range of the (sample,
// 32-row group) pairs.  Lane 0 of warp kMsgWarps is the producer.  For
// each row tile it copies the tile's w_aff rows into a ring of kMsgAStages
// stages (one 1-D bulk copy: w_aff rows are 2T bytes, too narrow for TMA
// and not even 4-byte aligned at odd T), and it loads pooled's boxes by
// TMA (once per sample while they stay resident, else for every tile).
// The consumers release a box after its last use before the next load, a
// w_aff stage after the tile.
__global__ void __launch_bounds__(kMsgThreads, 1)
graph_msg_kernel(const __grid_constant__ CUtensorMap p_map, const bf16* __restrict__ w_aff,
                 bf16* __restrict__ msg, float* __restrict__ stats, int B, int N, int C,
                 int T, MsgPlan plan) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMsgMaxSlots], empty[kMsgMaxSlots];
  __shared__ __align__(8) uint64_t a_full[kMsgAStages], a_empty[kMsgAStages];
  __shared__ float red[2][kMsgWarps][2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int parts = (N + kMsgGroupRows - 1) / kMsgGroupRows;
  const long long groups = static_cast<long long>(B) * parts;
  const int g0 = static_cast<int>(groups * blockIdx.x / gridDim.x);
  const int g1 = static_cast<int>(groups * (blockIdx.x + 1) / gridDim.x);
  const int tile_rows = 16 * plan.mt;
  const int box_bytes = plan.kbox * kSwizzleBytes;
  const bool stream = plan.ring > 0;   // reload the boxes every tile

  // warp w's boxes per tile, and its first slot
  auto boxes_of = [&](int w) {
    return (plan.chunks > w ? (plan.chunks - w + kMsgWarps - 1) / kMsgWarps : 0) *
           plan.kchunks;
  };
  auto first_slot = [&](int w) {   // the chunks j < chunks with j % kMsgWarps < w
    const int rem = plan.chunks % kMsgWarps;
    return stream ? w * plan.ring
                  : ((plan.chunks / kMsgWarps) * w + (rem < w ? rem : w)) * plan.kchunks;
  };
  const int slots = first_slot(kMsgWarps);
  // slot q of warp w's box lr (its index among the warp's boxes of a
  // round) at load round r, and the load's phase ph on the slot's barriers
  auto slot_of = [&](int w, int lr, int r, int& q, int& ph) {
    if (!stream) {   // a slot per box, loaded once a round
      q = first_slot(w) + lr;
      ph = r;
    } else {
      const int l = r * boxes_of(w) + lr;
      q = first_slot(w) + l % plan.ring;
      ph = l / plan.ring;
    }
  };
  unsigned char* a_ring = smem + slots * box_bytes;
  bf16* staging = reinterpret_cast<bf16*>(a_ring + kMsgAStages * plan.a_bytes);

  // A tile's w_aff rows are elements [e0, e0 + 16 mt T) of w_aff; its stage
  // holds the bytes from the 16-byte bound below e0 up to the next 16-byte
  // bound, short of the last bound below w_aff's end (w_tail), so nothing
  // past w_aff is read.  A tile that reaches past w_tail reads its rows
  // from device memory instead.
  const unsigned char* wbytes = reinterpret_cast<const unsigned char*>(w_aff);
  const size_t w_tail = static_cast<size_t>(B) * N * T * sizeof(bf16) / 16 * 16;
  const size_t tile_bytes = static_cast<size_t>(tile_rows) * T * sizeof(bf16);
  auto a_span = [&](const MsgTile& x, size_t& lo, uint32_t& bytes) {
    const size_t e0 = (static_cast<size_t>(x.s) * N + x.grp * kMsgGroupRows +
                       x.i * tile_rows) * T * sizeof(bf16);
    lo = e0 / 16 * 16;
    size_t hi = (e0 + tile_bytes + 15) / 16 * 16;
    hi = hi < w_tail ? hi : w_tail;
    bytes = hi > lo ? static_cast<uint32_t>(hi - lo) : 0u;
    return e0;
  };
  const MsgTile start{g0, g0 / parts, g0 % parts, 0};

  if (threadIdx.x == 0) {
    for (int q = 0; q < slots; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], 1);
    }
    for (int q = 0; q < kMsgAStages; ++q) {
      mbar_init(&a_full[q], 1);
      mbar_init(&a_empty[q], kMsgWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kMsgWarps) {   // the producer
    if (lane == 0) {
      tma_prefetch(&p_map);
      int cur = -1, t = 0, round = -1;
      for (MsgTile x = start; x.g < g1; x.next(parts, N, tile_rows), ++t) {
        const int aq = t % kMsgAStages;
        if (t >= kMsgAStages) mbar_wait(&a_empty[aq], ((t / kMsgAStages) - 1) & 1);
        size_t lo;
        uint32_t bytes;
        a_span(x, lo, bytes);
        mbar_arrive_expect_tx(&a_full[aq], bytes);
        if (bytes) bulk_load(a_ring + aq * plan.a_bytes, wbytes + lo, bytes, &a_full[aq]);

        if (!stream && x.s == cur) continue;
        cur = x.s;
        ++round;
        // in each warp's order of use: chunk j is warp j % 8's chunk j / 8
        for (int j = 0, w = 0, pj = 0; j < plan.chunks; ++j) {
          for (int kc = 0; kc < plan.kchunks; ++kc) {
            int q, ph;
            slot_of(w, pj * plan.kchunks + kc, round, q, ph);
            if (ph > 0) mbar_wait(&empty[q], (ph - 1) & 1);
            mbar_arrive_expect_tx(&full[q], box_bytes);
            tma_load_3d(smem + q * box_bytes, &p_map, &full[q], j * kChunk, kc * plan.kbox,
                        x.s);
          }
          if (++w == kMsgWarps) {
            w = 0;
            ++pj;
          }
        }
      }
    }
    return;
  }

  // The consumers.  Lane (gq, c) = (l / 4, l % 4) gathers its m16n8k16 A
  // fragments from the tile's w_aff stage: for m16 tile mi and k16 step v,
  // rows 16 mi + gq and + 8, words 16 v + 2c, + 1 and + 8, + 9, zero past
  // T and past the sample's last row, so the product's K padding is zero
  // in A as TMA makes it zero in B.  ldmatrix addresses: lane l gives row
  // l % 8 of matrix m = l / 8, which is (k half, n8 tile of the pair) =
  // (m % 2, m / 2) of a k16 step.
  const int gq = lane / 4, c = lane % 4;
  const int ksteps = plan.kbox / 16;
  const int m = lane / 8;
  const uint32_t lrow = smem_u32(smem) + ((m % 2) * 8 + lane % 8) * kSwizzleBytes;
  const int stage = tile_rows * C;   // bf16 of one staging buffer
  const int row_bytes = T * static_cast<int>(sizeof(bf16));
  constexpr uint32_t kOnes = 0x3f803f80u;   // two bf16 ones
  int round = -1, cur = -1, buf = 0, parity = 0, t = 0;
  // The statistics of the rounded msg x over the group.  The row sums on
  // the tensor cores: the accumulator layout of an n8 tile pair is the A
  // layout of an m16n8k16 product, so sx = x * ones sums 16 columns of each
  // row exactly (two sets, used in turns, so the chains interleave).  The
  // sums of squares on the f32 pipes, one fma a value into sq.  (The
  // squares as the diagonals of x * x^T too measured 3% slower; PERF.md.)
  float sx[2][4] = {}, sq[4] = {};
  for (MsgTile x = start; x.g < g1; ++t) {
    const int r0 = x.grp * kMsgGroupRows + x.i * tile_rows;
    if (stream || x.s != cur) {   // this tile's boxes are a new load round
      ++round;
      cur = x.s;
    }
    MsgTile xn = x;
    xn.next(parts, N, tile_rows);
    const bool last = xn.g != x.g;   // the group's last tile
    const bool release = stream || xn.g == g1 || xn.s != x.s;
    const int aq = t % kMsgAStages;
    size_t lo;
    uint32_t bytes;
    const size_t e0 = a_span(x, lo, bytes);
    // rows 16 mi + gq of the tile, in the stage or, past w_tail, in device
    // memory; the rows 8 further are row_bytes * 8 on
    const unsigned char* rows = e0 + tile_bytes <= w_tail
                                    ? a_ring + aq * plan.a_bytes + (e0 - lo) + gq * row_bytes
                                    : wbytes + e0 + gq * row_bytes;
    auto a_pair = [&](int r, int k) {   // words k, k + 1 of row gq + r of the tile
      const unsigned short* w =
          reinterpret_cast<const unsigned short*>(rows + r * row_bytes) + k;
      const bool ok = r0 + gq + r < N;
      const uint32_t x0 = ok && k < T ? static_cast<uint32_t>(w[0]) : 0u;
      const uint32_t x1 = ok && k + 1 < T ? static_cast<uint32_t>(w[1]) : 0u;
      return x0 | (x1 << 16);
    };
    mbar_wait(&a_full[aq], (t / kMsgAStages) & 1);
    // the tile's A fragments, [k16 step][m16 tile]: gathered once per tile
    // when K is one chunk, else for each chunk and K chunk
    uint32_t a[kMsgMaxK / 16][2][4];
    auto gather = [&](int kc) {
#pragma unroll
      for (int ks = 0; ks < kMsgMaxK / 16; ++ks) {
        if (ks >= ksteps) break;
        const int k = kc * plan.kbox + ks * 16 + 2 * c;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          a[ks][mi][0] = mi < plan.mt ? a_pair(16 * mi, k) : 0u;
          a[ks][mi][1] = mi < plan.mt ? a_pair(16 * mi + 8, k) : 0u;
          a[ks][mi][2] = mi < plan.mt ? a_pair(16 * mi, k + 8) : 0u;
          a[ks][mi][3] = mi < plan.mt ? a_pair(16 * mi + 8, k + 8) : 0u;
        }
      }
    };
    if (plan.kchunks == 1) gather(0);

    bf16* out = staging + buf * stage;
    bf16* out_row = out + gq * C + 2 * c;   // this lane's row gq, column 2c
    for (int j = warp, lr = 0; j < plan.chunks; j += kMsgWarps) {
      float acc[2][8][4];   // [m16 tile][n8 tile]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;
      for (int kc = 0; kc < plan.kchunks; ++kc, ++lr) {
        if (plan.kchunks > 1) gather(kc);
        int q, ph;
        slot_of(warp, lr, round, q, ph);
        mbar_wait(&full[q], ph & 1);
        const uint32_t st = lrow + q * box_bytes;
#pragma unroll
        for (int ks = 0; ks < kMsgMaxK / 16; ++ks) {
          if (ks >= ksteps) break;
#pragma unroll
          for (int pr = 0; pr < 4; ++pr) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, st + ks * 16 * kSwizzleBytes +
                                     (((2 * pr + m / 2) ^ (lane % 8)) << 4));
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if (mi >= plan.mt) break;
              mma_m16n8k16(acc[mi][2 * pr], a[ks][mi], b[0], b[1]);
              mma_m16n8k16(acc[mi][2 * pr + 1], a[ks][mi], b[2], b[3]);
            }
          }
        }
        if (release) {   // the box's last use before it is loaded again
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[q]);
        }
      }

      // Epilogue: round to bf16 and stage the tile's rows in msg's own
      // layout, [16 mt x C], so one bulk copy of whole rows stores them:
      // rows of 2C = 2000 bytes start 16 bytes into a 32-byte sector at
      // every other row, and stores cut at 64-column boundaries split
      // those sectors between two stores (measured 1.7x slower, PERF.md).
      // Rows past N and columns past C are zero: they add nothing to the
      // sums.
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi >= plan.mt) break;
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          uint32_t xf[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xf[e] = bf2_bits(__floats2bfloat162_rn(acc[mi][2 * pr + e / 2][2 * (e % 2)],
                                                   acc[mi][2 * pr + e / 2][2 * (e % 2) + 1]));
          mma_m16n8k16(sx[(mi + pr) & 1], xf, kOnes, kOnes);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lo = __uint_as_float(xf[e] << 16);
            const float hi = __uint_as_float(xf[e] & 0xffff0000u);
            sq[e] = fmaf(lo, lo, fmaf(hi, hi, sq[e]));
          }
          const int col = j * kChunk + 16 * pr;   // of this lane: + 2c
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + 8 * (e / 2) < C)
              *reinterpret_cast<uint32_t*>(out_row + (16 * mi + 8 * (e % 2)) * C + col +
                                           8 * (e / 2)) = xf[e];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&a_empty[aq]);   // this warp is done with the w_aff stage

    // The tile is staged: every thread fences its writes to the async
    // proxy; thread 0 waits until the previous tile's store has read the
    // buffer the next tile writes; after the barrier it stores the tile's
    // rows below N.  At a group's last tile each warp sums its row sums
    // and squares, the warps' sums go to `red` (alternating by group)
    // and warp 1 adds them in order into the group's slot: no atomics, so
    // two launches agree bit for bit.
    fence_proxy_async();
    if (last) {
      // every column of sx holds the row sums: rows gq and gq + 8 in
      // lanes c = 0
      const float s1 = warp_sum(c == 0 ? sx[0][0] + sx[0][2] + sx[1][0] + sx[1][2] : 0.f);
      const float s2 = warp_sum(sq[0] + sq[1] + sq[2] + sq[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) sx[0][e] = sx[1][e] = sq[e] = 0.f;
      if (lane == 0) {
        red[parity][warp][0] = s1;
        red[parity][warp][1] = s2;
      }
    }
    if (threadIdx.x == 0) bulk_wait_read();
    named_bar_sync(1, 32 * kMsgWarps);
    if (threadIdx.x == 0) {
      const int n_rows = N - r0 < tile_rows ? N - r0 : tile_rows;
      bulk_store(msg + (static_cast<size_t>(x.s) * N + r0) * C, out,
                 static_cast<uint32_t>(n_rows) * C * sizeof(bf16));
      bulk_commit();
      if (plan.nbuf == 1) bulk_wait_read();
    }
    if (plan.nbuf == 1) named_bar_sync(1, 32 * kMsgWarps);
    if (last && warp == 1 && lane < 2) {
      float v = 0.f;
      for (int w = 0; w < kMsgWarps; ++w) v += red[parity][w][lane];
      stats[static_cast<size_t>(x.g) * 2 + lane] = v;
    }
    if (last) parity ^= 1;
    buf = plan.nbuf == 2 ? buf ^ 1 : 0;
    x = xn;
  }
  if (threadIdx.x == 0) bulk_wait_read();   // the stores have read shared memory
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
                    int C, float cnt, int per_group) {
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
  return (N + cmpc::kMsgGroupRows - 1) / cmpc::kMsgGroupRows;
}

// Shared memory of a launch at C columns and T words, 0 where they do not
// fit (C past kMsgMaxC, or C * T too large for the staging and pooled).
extern "C" int cmpc_graph_msg_smem(int C, int T) {
  return C < 8 || C > cmpc::kMsgMaxC || T < 1 ? 0 : cmpc::msg_plan(C, T).smem;
}

extern "C" int cmpc_graph_update_parts(int N, int C) {
  return ((N + cmpc::kUpdBM - 1) / cmpc::kUpdBM) * ((C + cmpc::kUpdBN - 1) / cmpc::kUpdBN);
}

// w_aff [B*N, T] bf16, pooled [B, T, C] bf16 -> msg [B*N, C] bf16 and
// stats [B, parts, 2] f32 (per 32-row group: sum, sum of squares of the
// bf16 msg).  T >= 1; w_aff, pooled and msg 16-byte aligned (bulk copies,
// TMA), C a multiple of 8 (TMA strides, 16-byte bulk copies of whole rows)
// and at most kMsgMaxC (a [16 x C] staging buffer), and the plan must fit
// in shared memory (C = 4096 takes T up to ~250).  One block per SM, at
// most one per group.
extern "C" int cmpc_graph_msg(const void* w_aff, const void* pooled, void* msg,
                              void* stats, int B, int N, int C, int T, void* stream) {
  using namespace cmpc;
  if (B < 1 || N < 1 || C % 8 || cmpc_graph_msg_smem(C, T) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MsgPlan plan = msg_plan(C, T);
  CUtensorMap p_map;
  // [B][T][C] innermost first: the boxes read zero past T and past C
  const uint64_t bf = sizeof(bf16);
  const uint64_t p_dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(T),
                              static_cast<uint64_t>(B)};
  const uint64_t p_strides[2] = {C * bf, static_cast<uint64_t>(T) * C * bf};
  const uint32_t p_box[3] = {kChunk, static_cast<uint32_t>(plan.kbox), 1};
  int rc = encode_tmap(&p_map, pooled, 3, p_dims, p_strides, p_box);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      graph_msg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const long long groups = static_cast<long long>(B) * cmpc_graph_msg_parts(N);
  const int grid = groups < sms ? static_cast<int>(groups) : sms;
  graph_msg_kernel<<<grid, kMsgThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      p_map, static_cast<const bf16*>(w_aff), static_cast<bf16*>(msg),
      static_cast<float*>(stats), B, N, C, T, plan);
  return static_cast<int>(cudaGetLastError());
}

// x, msg [B*N, C] bf16; stats1 [B, parts1, 2] f32 (graph_msg's); w
// [G, C, C], bias [G, C] bf16; g1, b1 [G, C] f32 (LN1 affine) -> z [B*N, C]
// bf16 and stats2 [B, update_parts, 2] f32.  G divides B; sample s uses
// group s / (B / G).  x, msg, w and z 16-byte aligned, C a multiple of 8
// (TMA strides) and at most kUpdMaxC (the LN1 affine in shared memory).
// LN1 counts N * width elements per sample: columns width..C-1 are zero
// padding (zero in msg, g1 and b1), which adds nothing to the sums.
extern "C" int cmpc_graph_update(const void* x, const void* msg, const void* stats1,
                                 int parts1, const void* w, const void* bias,
                                 const void* g1, const void* b1, void* z, void* stats2,
                                 int B, int N, int C, int width, int groups, void* stream) {
  using namespace cmpc;
  if (groups < 1 || B % groups || C % 8 || C > kUpdMaxC || width < 1 || width > C)
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
      static_cast<const float*>(b1), static_cast<float*>(stats2), N, C,
      static_cast<float>(N) * static_cast<float>(width), B / groups);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wide forms.  No TPU kernel of their own: the Pallas blocks span the
// whole row at any C and T.  Simple tiled products (csrc/wide.cuh), a
// block per 64 x 64 output tile of one sample; each block writes its own
// statistics slot (sum, sum of squares of its rounded outputs, summed over
// its threads in a fixed order), so the statistics keep the [B, parts, 2]
// layout with parts = cmpc_graph_wide_parts(N, C).
//  - msg, where the message kernel's plan does not fit (C > kMsgMaxC, or
//    C * T past its shared memory): the tile of w_aff[s] @ pooled[s],
//    rounded to bf16.  The product has no reduction over C.
//  - update, for C > kUpdMaxC, where LN1's affine [2][C] no longer fits
//    shared memory: the A operand y = relu(bf16(x + bf16(LN1(msg)))) is
//    formed as each 32-column step of it is loaded, reading gamma and beta
//    of those columns from device memory, so nothing is staged per C.
// Bound on the card: operations at such widths (the [B*N, C] x [C, C]
// product of the update; the message's [N, T] x [T, C] per sample).
// ---------------------------------------------------------------------------
#include "wide.cuh"

namespace cmpc {

// 8 entries of y = relu(bf16(x + bf16((msg - mean) * inv * g1 + b1))) at
// row r, columns k .. k + 7 of one sample (C a multiple of 8, x and msg
// 16-byte aligned), zero past the rows and C.
struct GraphYLoad {
  const bf16* x;
  const bf16* msg;
  const float* g1;
  const float* b1;
  int rows, C;
  float mean, inv;
  __device__ uint4 operator()(int r, int k) const {
    if (r >= rows || k >= C) return zero_vec();
    const size_t o = static_cast<size_t>(r) * C + k;
    float xf[8], mf[8], y[8];
    load_bf<8>(x + o, xf);
    load_bf<8>(msg + o, mf);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float ln = round_bf((mf[e] - mean) * inv * g1[k + e] + b1[k + e]);
      y[e] = fmaxf(round_bf(xf[e] + ln), 0.f);
    }
    return pack_bf<8>(y);
  }
};

// The block's (sum, sum of squares) into its slot of `stats` [B, parts, 2].
__device__ __forceinline__ void wide_stats(float sum, float sumsq, float* stats, int s,
                                           float* red) {
  sum = block_sum(sum, red);
  sumsq = block_sum(sumsq, red);
  if (threadIdx.x == 0) {
    const size_t part =
        (static_cast<size_t>(s) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    stats[part * 2] = sum;
    stats[part * 2 + 1] = sumsq;
  }
}

__global__ void __launch_bounds__(kWideThreads)
graph_msg_wide_kernel(const bf16* __restrict__ w_aff, const bf16* __restrict__ pooled,
                      bf16* __restrict__ msg, float* __restrict__ stats, int N, int C, int T,
                      bool avec) {
  __shared__ WideSmem sm;
  __shared__ float red[kWideThreads / 32];
  const int c0 = blockIdx.x * kWideTile, row0 = blockIdx.y * kWideTile, s = blockIdx.z;
  const size_t srow = static_cast<size_t>(s) * N;
  const RowsLoad wa{w_aff + srow * T, T, N, T, avec};
  const RowsLoad pb{pooled + static_cast<size_t>(s) * T * C, C, T, C, true};
  wide_product<false>(sm, wa, pb, row0, c0, T);
  float sum = 0.f, sumsq = 0.f;
#pragma unroll 4
  for (int i = 0; i < kWidePerThread; ++i) {
    const int e = threadIdx.x + i * kWideThreads, r = e / kWideTile, j = e % kWideTile;
    const int row = row0 + r, col = c0 + j;
    if (row >= N || col >= C) continue;
    const float v = round_bf(sm.c[r][j]);
    msg[(srow + row) * C + col] = f2bf(v);
    sum += v;
    sumsq += v * v;
  }
  wide_stats(sum, sumsq, stats, s, red);
}

__global__ void __launch_bounds__(kWideThreads)
graph_update_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ msg,
                         const float* __restrict__ stats1, int parts1,
                         const bf16* __restrict__ w, const bf16* __restrict__ bias,
                         const float* __restrict__ g1, const float* __restrict__ b1,
                         bf16* __restrict__ z, float* __restrict__ stats2, int N, int C,
                         float cnt, int per_group) {
  __shared__ WideSmem sm;
  __shared__ float red[kWideThreads / 32];
  const int c0 = blockIdx.x * kWideTile, row0 = blockIdx.y * kWideTile, s = blockIdx.z;
  const int grp = s / per_group;
  const size_t srow = static_cast<size_t>(s) * N;
  float sa = 0.f, sb = 0.f;
  for (int j = 0; j < parts1; ++j) {
    sa += stats1[(static_cast<size_t>(s) * parts1 + j) * 2];
    sb += stats1[(static_cast<size_t>(s) * parts1 + j) * 2 + 1];
  }
  const float mean = sa / cnt;
  const float inv = rsqrtf(fmaxf(sb / cnt - mean * mean, 0.f) + 1e-12f);
  const GraphYLoad ya{x + srow * C, msg + srow * C, g1 + static_cast<size_t>(grp) * C,
                      b1 + static_cast<size_t>(grp) * C, N, C, mean, inv};
  const RowsLoad wb{w + static_cast<size_t>(grp) * C * C, C, C, C, true};
  wide_product<false>(sm, ya, wb, row0, c0, C);
  const bf16* bg = bias + static_cast<size_t>(grp) * C;
  float sum = 0.f, sumsq = 0.f;
#pragma unroll 4
  for (int i = 0; i < kWidePerThread; ++i) {
    const int e = threadIdx.x + i * kWideThreads, r = e / kWideTile, j = e % kWideTile;
    const int row = row0 + r, col = c0 + j;
    if (row >= N || col >= C) continue;
    const float v = round_bf(round_bf(sm.c[r][j]) + bf2f(bg[col]));
    z[(srow + row) * C + col] = f2bf(v);
    sum += v;
    sumsq += v * v;
  }
  wide_stats(sum, sumsq, stats2, s, red);
}

}  // namespace cmpc

// Statistics slots per sample of the wide forms: one per 64 x 64 tile.
extern "C" int cmpc_graph_wide_parts(int N, int C) {
  return cmpc::wide_tiles(N) * cmpc::wide_tiles(C);
}

// The contract of cmpc_graph_msg for any C (a multiple of 8) and T >= 1,
// with stats [B, cmpc_graph_wide_parts(N, C), 2]; pooled 16-byte aligned.
extern "C" int cmpc_graph_msg_wide(const void* w_aff, const void* pooled, void* msg,
                                   void* stats, int B, int N, int C, int T, void* stream) {
  using namespace cmpc;
  if (B < 1 || N < 1 || T < 1 || C % 8 || C < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(pooled)) return static_cast<int>(cudaErrorMisalignedAddress);
  graph_msg_wide_kernel<<<dim3(wide_tiles(C), wide_tiles(N), B), kWideThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w_aff), static_cast<const bf16*>(pooled),
      static_cast<bf16*>(msg), static_cast<float*>(stats), N, C, T,
      T % 8 == 0 && aligned16(w_aff));
  return static_cast<int>(cudaGetLastError());
}

// The contract of cmpc_graph_update for any C (a multiple of 8), with
// stats2 [B, cmpc_graph_wide_parts(N, C), 2]; x, msg and w 16-byte aligned.
extern "C" int cmpc_graph_update_wide(const void* x, const void* msg, const void* stats1,
                                      int parts1, const void* w, const void* bias,
                                      const void* g1, const void* b1, void* z, void* stats2,
                                      int B, int N, int C, int width, int groups,
                                      void* stream) {
  using namespace cmpc;
  if (groups < 1 || B % groups || N < 1 || C % 8 || C < 8 || width < 1 || width > C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(msg) || !aligned16(w))
    return static_cast<int>(cudaErrorMisalignedAddress);
  graph_update_wide_kernel<<<dim3(wide_tiles(C), wide_tiles(N), B), kWideThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(msg),
      static_cast<const float*>(stats1), parts1, static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<bf16*>(z), static_cast<float*>(stats2), N, C,
      static_cast<float>(N) * static_cast<float>(width), B / groups);
  return static_cast<int>(cudaGetLastError());
}
