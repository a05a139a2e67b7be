// Hopper building blocks of the port's wgmma kernels (csrc/mutan.cu, the dW
// product of csrc/mutan_bwd.cu, convlstm.cu's gates, se_sum.cu,
// graph_conv.cu's update, spa_affinity.cu), of the dz pass's bulk-copy
// ring (mutan_bwd.cu) and of graph_conv.cu's message kernel, as inline PTX
// for sm_90a:
//
// - mbarriers: init, arrive (plain or with an expected byte count), parity
//   wait;
// - cp.async 8-byte copies with zero fill, written into the 128-byte
//   swizzled layout below, for operands TMA cannot load (rows whose stride
//   is not a multiple of 16 bytes, such as C = 500 bf16);
// - TMA (cp.async.bulk.tensor) 2D / 3D loads that complete on an mbarrier,
//   into this block or multicast to the blocks of a cluster, and a 3D store from
//   shared memory tracked by bulk groups; the 1-D bulk copies (cp.async.bulk)
//   of a contiguous byte range to and from shared memory, which need no
//   tensor map;
// - cluster position, rank, masks and sync, arrivals on another block's
//   mbarrier, and reads of another block's shared memory (DSMEM);
// - the 64-bit wgmma shared-memory descriptor for 128-byte swizzled tiles;
// - wgmma.fence / commit_group / wait_group and the m64n128k16 and
//   m64n256k16 bf16 products with f32 accumulators, trans-a / trans-b as
//   immediates, and m64n32k16 with A from registers;
// - setmaxnreg, to move registers from a producer to consumer warpgroups;
// - the warp-level bf16 product mma.sync m16n8k16 and its ldmatrix feeds,
//   plain and transposed (graph_conv.cu's message kernel, the word product
//   of spa_affinity.cu's wide form);
// - a host helper that encodes a CUtensorMap (cuTensorMapEncodeTiled, a
//   driver-API symbol fetched through the runtime, so no -lcuda).
//
// Tile layout.  Every operand tile is loaded by TMA with 128-byte swizzle,
// an inner box of 64 bf16 (128 bytes) and rows 128 bytes apart, into shared
// memory aligned to 1024 bytes.  Eight rows form one 1024-byte swizzle atom.
// - K-major tile ([rows][64 of K], K contiguous): a k16 step advances the
//   descriptor's start by 32 bytes; SBO = 1024 (next 8 rows); LBO unused.
// - MN-major tile ([64 of K][64 of M or N], M/N contiguous, trans = 1): a
//   k16 step advances the start by 16 rows = 2048 bytes; SBO = 1024 (next 8
//   rows of K); LBO = the distance between 64-wide chunks along M/N.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace cmpc {

constexpr int kSwizzleBytes = 128;   // one swizzled row: 64 bf16
constexpr int kTileK = 64;           // depth of one pipeline stage
constexpr int kChunk = 64;           // bf16 per swizzled row (TMA inner box)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's current phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---- thread-block clusters -------------------------------------------------

// The kernels that share tiles run as clusters of 2 x 2 blocks: the blocks
// of a cluster row (same y) read the same tile of one operand, those of a
// cluster column (same x) the same tile of the other.  Each block loads a
// share of each tile and multicasts it to the blocks that need it, so a
// tile crosses from L2 once per cluster row or column instead of once per
// block.  (Without clusters both kernels measured slower at every shape
// timed; PERF.md.)
constexpr int kClusterX = 2, kClusterY = 2;
constexpr int kClusterSize = kClusterX * kClusterY;

// This block's position (x, y) in its cluster; its rank there is
// x + kClusterX y.
__device__ __forceinline__ int cluster_x() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctaid.x;\n" : "=r"(v));
  return static_cast<int>(v);
}

__device__ __forceinline__ int cluster_y() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctaid.y;\n" : "=r"(v));
  return static_cast<int>(v);
}

// Multicast masks: the blocks of cluster row y, of cluster column x.
__device__ __forceinline__ uint16_t cluster_row_mask(int y) {
  return static_cast<uint16_t>(((1u << kClusterX) - 1) << (kClusterX * y));
}

__device__ __forceinline__ uint16_t cluster_col_mask(int x) {
  uint32_t m = 0;
#pragma unroll
  for (int y = 0; y < kClusterY; ++y) m |= 1u << (x + kClusterX * y);
  return static_cast<uint16_t>(m);
}

// Every thread of every block of the cluster; orders barrier inits and
// shared-memory writes before the other blocks' later accesses.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This block's rank in its cluster, and the cluster's size in blocks.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v));
  return v;
}

// The float at the same shared-memory offset as `p` in block `rank` of the
// cluster (the block must still be running: see cluster_sync).
__device__ __forceinline__ float ld_cluster_f32(const float* p, uint32_t rank) {
  float v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [remote];\n}\n"
      : "=f"(v) : "r"(smem_u32(p)), "r"(rank) : "memory");
  return v;
}

// Arrive on the barrier at the same shared-memory offset in block `rank`.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank) : "memory");
}

// A consumer warpgroup's release of a stage (called by all its threads;
// `wtid` is the thread's index in the warpgroup): the stage of every block
// of the cluster may be refilled by a multicast from any of them, so thread
// r arrives at block r's barrier, all in one instruction.
__device__ __forceinline__ void release_stage_cluster(uint64_t* empty, int wtid) {
  if (wtid < kClusterSize) mbar_arrive_remote(empty, wtid);
}

// ---- cp.async into swizzled tiles -----------------------------------------

// 8 bytes from global `src` to shared `dst`; src_bytes = 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies a [kRows x kCols] block of a row-major bf16 matrix into shared
// memory at `dst` (1024-byte aligned) in the layout a TMA load with 128-byte
// swizzle and an inner box of 64 would give: kCols / 64 chunks of [kRows][64],
// kRows * 128 bytes apart, 16-byte group q of row r at q ^ (r % 8).  `src`
// is the block's first element, `ld` the matrix's row stride in elements,
// `rows` / `cols` how many of the block's rows / columns exist (the rest
// read zero; `safe` is any readable address, passed for them).  Rows must
// be 8-byte aligned and `cols` a multiple of 4: each copy moves 4 bf16.
// The kThreads threads `tid` = 0 .. kThreads - 1 share the copies;
// consecutive threads copy consecutive 8 bytes of a row.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void cp_async_tile(uint32_t dst, const bf16* src, size_t ld,
                                              int rows, int cols, const bf16* safe,
                                              int tid) {
  constexpr int kPieces = kCols / 4;   // 8-byte copies per row
  constexpr int kCopies = kRows * kPieces;
  static_assert(kCopies % kThreads == 0, "copies must split evenly");
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kPieces, q = e % kPieces;
    const bool ok = r < rows && q * 4 < cols;
    const uint32_t d = dst + (q / 16) * (kRows * kSwizzleBytes) + r * kSwizzleBytes +
                       ((((q / 2) % 8) ^ (r % 8)) << 4) + (q % 2) * 8;
    cp_async8(d, ok ? src + r * ld + q * 4 : safe, ok ? 8 : 0);
  }
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Loads: coordinates innermost first, in elements; out-of-bounds parts read
// zero.  The box is written, and the barrier signalled, at the same offsets
// in every block of `mask` (see the clusters above).
__device__ __forceinline__ void tma_load_2d_mc(void* dst, const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "h"(mask) : "memory");
}

__device__ __forceinline__ void tma_load_3d_mc(void* dst, const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1, int c2,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask) : "memory");
}

// The same into this block's shared memory only.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 1-D bulk copy of `bytes` contiguous bytes from global `src` into this
// block's shared memory at `dst`, completing on `bar` (which must expect
// the bytes).  src, dst and bytes must all be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Out-of-bounds parts of the box are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// A 1-D bulk copy of `bytes` contiguous bytes from this block's shared
// memory at `src` to global `dst`, tracked by bulk groups; src, dst and
// bytes must all be multiples of 16.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the committed stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until the committed stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes (plain stores, or cp.async
// copies it has waited for) before later async-proxy reads (a TMA store or
// a wgmma of the same buffer).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Hand registers from one warpgroup to another (all of its warps execute it).
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a 128-byte swizzled tile at shared address `addr` (1024-byte
// aligned atoms); lbo / sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[16] += A[64x16] * B[16x32] with A from registers: a[4] holds a
// thread's 8 bf16 of the 64x16 A tile in the layout of an f32 accumulator
// fragment's two 8-column groups (a[0]: row r, columns 2c, 2c+1; a[1]:
// row r + 8; a[2], a[3]: the same 8 columns on), so one wgmma's result
// feeds the next.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// d[64] += A[64x16] * B[16x128]; scale_d = 0 overwrites d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d[128] += A[64x16] * B[16x256]; scale_d = 0 overwrites d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}


// One 64-deep stage: four k16 products of a 64-row A tile and an N-wide B
// tile.  a_step / b_step: the descriptor advance of one k16 step in 16-byte
// units (2 for a K-major tile, 128 for an MN-major one).  `zero` starts the
// accumulator from 0 instead of adding to it.
template <int N, int kTransA, int kTransB>
__device__ __forceinline__ void mma_stage(float (&d)[N / 2], uint64_t desc_a,
                                          uint64_t desc_b, uint32_t a_step,
                                          uint32_t b_step, bool zero) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const int scale_d = (zero && kk == 0) ? 0 : 1;
    if constexpr (N == 128)
      wgmma_m64n128k16<kTransA, kTransB>(d, desc_a + kk * a_step, desc_b + kk * b_step,
                                         scale_d);
    else
      wgmma_m64n256k16<kTransA, kTransB>(d, desc_a + kk * a_step, desc_b + kk * b_step,
                                         scale_d);
  }
}

// ---- mma.sync --------------------------------------------------------------

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8m .. 8m + 7
// give the addresses of matrix m's 8 rows (16 bytes each), and register m
// of lane l receives rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4.  A
// [k][n] tile so loaded is the B operand of mma_m16n8k16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The same, not transposed: register m of lane l receives elements
// 2 (l % 4) and 2 (l % 4) + 1 of row l / 4 of matrix m.  A [16 rows][16]
// tile so loaded (matrices: rows 0-7 and 8-15 of the first 8 columns, then
// of the next 8) is the A operand of mma_m16n8k16; an [8 n][16 k] tile
// (matrices: the first 8 k, then the next 8) its B operand (b0, b1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d[4] += A[16x16] * B[16x8] in bf16 with f32 sums (g = lane / 4, c =
// lane % 4): a[0] holds A row g, columns 2c, 2c + 1 (the lower column in the
// low half), a[1] row g + 8, a[2] and a[3] the same at columns + 8; b0 holds
// B rows 2c, 2c + 1 of column g, b1 rows + 8; d[0], d[1] are row g, columns
// 2c, 2c + 1 of the result, d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- host: tensor maps -----------------------------------------------------

// A bf16 tensor map of `rank` dims (innermost first, in elements; strides of
// dims 1.. in bytes) with a box of `box` elements and 128-byte swizzle.
// Returns 0, a cudaError_t of the entry-point lookup, or kTmapError + the
// CUresult of the encode.
inline int encode_tmap(CUtensorMap* map, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), reinterpret_cast<const cuuint64_t*>(dims),
      reinterpret_cast<const cuuint64_t*>(strides),
      reinterpret_cast<const cuuint32_t*>(box), elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTmapError + static_cast<int>(res);
}

}  // namespace cmpc
