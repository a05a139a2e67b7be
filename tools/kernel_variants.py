#!/usr/bin/env python3
"""Time a port kernel against edited builds of its CUDA source, in turns.

A variant is a list of (old, new) text edits to one csrc/*.cu source.  The
tool compiles every variant of a group (one nvcc each, in parallel, with
the flags of ops/build.py) into <out>/<group>/<variant>/, points the
kernel's wrapper at each build in turn and times it with CUDA events
(chip_smoke.gpu_ms) at the shapes chip_smoke.kernel_inputs gives it on
the group's phase-3 paths (`path_specs`), with its
largest error against the plain version (diagnostic variants compute
something else, so theirs is large; statistics partials are compared
summed over their slots).  The first variant, the committed source, runs
again at the end to show the drift.  Diagnostic variants (no compute, no
stores, no transcendental math) show what holds a kernel; the others are
the designs measured against it.  For the groups in SASS_KERNEL the tool
also counts the kernel's SASS opcodes in each build (cuobjdump): the
tensor-core products (HMMA), TMA loads and stores (UTMALDG, UTMASTG).

    python3 tools/kernel_variants.py dz|raw|msg|msg_wide|se_wide|dz_wide [--out build/kernel_variants]

Needs a CUDA GPU and nvcc; prints one line per shape and one JSON line.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from cmpc_refseg_torch.config import get_config  # noqa: E402
from cmpc_refseg_torch.models import cmpc  # noqa: E402
from cmpc_refseg_torch.ops import build, kernels  # noqa: E402


def _const(name, old, new):
    return [(f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")]


_DZ_NO_COMPUTE = [
    ("      if (j < n && active) {", "      if (j < n && active && C < 0) {"),
    ("      if (j >= n || !active) continue;",
     "      if (j >= n || !active || C > 0) continue;")]
_DZ_NO_STORE = [("        store_bf<VEC>(dzrow + h * C, d);",
                 "        if (C < 0) store_bf<VEC>(dzrow + h * C, d);")]
_DZ_VEC4 = [("  for (int vec = 2; vec <= 8; vec *= 2)",
             "  for (int vec = 4; vec <= 8; vec *= 2)")]
_DZ_VEC8 = [("  for (int vec = 2; vec <= 8; vec *= 2)",
             "  for (int vec = 8; vec <= 8; vec *= 2)"),
            ("__launch_bounds__(32 * (kDzMaxWarps + 1), 1)",
             "__launch_bounds__(160, 1)")]
_DZ_TWO_PER_SM = [("  p.grid = std::min(M, sms);", "  p.grid = std::min(M, 2 * sms);")]
# the producer warp's 32 lanes copy each stage by 16-byte cp.async and
# arrive on its full barrier when their copies land
_DZ_CP_ASYNC = [
    ("      mbar_init(&full[s], 1);", "      mbar_init(&full[s], 32);"),
    ("    if (lane == 0) {\n      int it = 0;", "    {\n      int it = 0;"),
    ("""        mbar_arrive_expect_tx(&full[s], static_cast<uint32_t>(v_hi - v_lo + g_hi - g_lo));
        bulk_load(buf, reinterpret_cast<const unsigned char*>(v) + v_lo,
                  static_cast<uint32_t>(v_hi - v_lo), &full[s]);
        bulk_load(buf + vbuf, reinterpret_cast<const unsigned char*>(g) + g_lo,
                  static_cast<uint32_t>(g_hi - g_lo), &full[s]);""",
     """        const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(v) + v_lo;
        for (size_t o = lane * 16; o < v_hi - v_lo; o += 512)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"
                       ::"r"(smem_u32(buf + o)), "l"(vsrc + o) : "memory");
        const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(g) + g_lo;
        for (size_t o = lane * 16; o < g_hi - g_lo; o += 512)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"
                       ::"r"(smem_u32(buf + vbuf + o)), "l"(gsrc + o) : "memory");
        asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\\n"
                     ::"r"(smem_u32(&full[s])) : "memory");""")]

_RAW_NO_MATH = [("        jn[e] = tanhf(", "        jn[e] = ("),
                ("        is[e] = logistic(", "        is[e] = ("),
                ("        fs[e] = logistic(", "        fs[e] = (")]
# the cell and output updates in f32, each product and sum rounded to bf16
_RAW_F32_UPDATE = [(
    """      const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&in[3]) + 2 * q4;""",
    """      float xo[4], xc[4], xco[4], nc[4], ov[4];
      unpack_bf<4>(reinterpret_cast<const uint2*>(&in[3])[q4], xo);
      unpack_bf<4>(reinterpret_cast<const uint2*>(&in[4])[q4], xc);
      unpack_bf<4>(reinterpret_cast<const uint2*>(&in[5])[q4], xco);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        nc[e] = round_bf(round_bf(xc[e] * round_bf(fs[e])) + round_bf(round_bf(is[e]) * round_bf(jn[e])));
        ov[e] = round_bf(xo[e] + round_bf(xco[e] * nc[e]));
        s_c += nc[e];
        q_c += nc[e] * nc[e];
        s_o += ov[e];
        q_o += ov[e] * ov[e];
      }
      reinterpret_cast<uint2*>(&nc_bits)[q4] = pack_bf<4>(nc);
      reinterpret_cast<uint2*>(&ov_bits)[q4] = pack_bf<4>(ov);
      if (C > 0) continue;
      const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&in[3]) + 2 * q4;""")]

# graph_msg: the committed source without the bulk stores of msg, without
# the product (pooled is still loaded and waited for), without both,
# without the A fragments' gather from the w_aff stage, without the
# statistics, without the staging writes; the sums of squares on the
# tensor cores instead of the f32 pipes; one block per
# 32-row group instead of one block per SM walking a range of them; 16-row
# tiles instead of 32; pooled streamed through a ring of one box a warp
# for every tile instead of resident; 16 consumer warps; and each tile's rows stored in 64-column pieces (the 2D-box
# stores' sector split) by one 1-D bulk copy per row and chunk, from the
# same staging
_MSG_NO_STORE = [("      bulk_store(msg + (static_cast<size_t>(x.s) * N + r0) * C, out,",
                  "      if (C < 0) bulk_store(msg + (static_cast<size_t>(x.s) * N + r0) * C, out,")]
_MSG_NO_PRODUCT = [("          if (ks >= ksteps) break;",
                    "          if (ks >= ksteps || C > 0) break;")]
_MSG_NO_A_GATHER = [("      const uint32_t x0 = ok && k < T ? static_cast<uint32_t>(w[0]) : 0u;\n"
                     "      const uint32_t x1 = ok && k + 1 < T ? static_cast<uint32_t>(w[1]) : 0u;",
                     "      const uint32_t x0 = ok && k < T ? 0x3c00u + k : 0u;\n"
                     "      const uint32_t x1 = ok && k + 1 < T ? 0x3c00u + r : 0u;")]
_MSG_NO_STATS = [
    ("          mma_m16n8k16(sx[(mi + pr) & 1], xf, kOnes, kOnes);\n", ""),
    ("            sq[e] = fmaf(lo, lo, fmaf(hi, hi, sq[e]));", "")]
_MSG_NO_STAGING = [("            if (SLICED || col + 8 * (e / 2) < C)\n",
                    "            if ((SLICED || col + 8 * (e / 2) < C) && C < 0)\n")]
# the sums of squares on the tensor cores too, as the diagonals of x * x^T
# (rows 0-7 and 8-15 of each m16 tile apart)
_MSG_SQ_MMA = [
    ("  float sx[2][4] = {}, sq[4] = {};",
     "  float sx[2][4] = {}, sq[4] = {}, sq0[4] = {}, sq1[4] = {};"),
    ("""#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lo = __uint_as_float(xf[e] << 16);
            const float hi = __uint_as_float(xf[e] & 0xffff0000u);
            sq[e] = fmaf(lo, lo, fmaf(hi, hi, sq[e]));
          }
""", """          mma_m16n8k16(sq0, xf, xf[0], xf[2]);
          mma_m16n8k16(sq1, xf, xf[1], xf[3]);
"""),
    ("      const float s2 = warp_sum(sq[0] + sq[1] + sq[2] + sq[3]);",
     "      const float s2 = warp_sum(2 * c == gq ? sq0[0] + sq1[2]\n"
     "                                : 2 * c + 1 == gq ? sq0[1] + sq1[3] : 0.f);\n"
     "#pragma unroll\n"
     "      for (int e = 0; e < 4; ++e) sq0[e] = sq1[e] = 0.f;")]
_MSG_GRID_PER_GROUP = [
    ("  const int grid = items < sms ? static_cast<int>(items) : sms;",
     "  const int grid = static_cast<int>(items);")]
_MSG_16_ROW_TILES = [("  p.mt = 1024 + tail", "  p.mt = width < 0 && 1024 + tail")]
_MSG_SPLIT_STORES = [
    ("    if (threadIdx.x == 0) bulk_wait_read();\n    named_bar_sync(1, 32 * kMsgWarps);",
     "    bulk_wait_read();\n    named_bar_sync(1, 32 * kMsgWarps);"),
    ("""    if (threadIdx.x == 0) {
      const int n_rows = N - r0 < tile_rows ? N - r0 : tile_rows;""",
     """    for (int e = threadIdx.x; e < tile_rows * plan.chunks; e += 32 * kMsgWarps) {
      const int r = e / plan.chunks, col = (e % plan.chunks) * kChunk;
      if (r0 + r < N)
        bulk_store(msg + (static_cast<size_t>(x.s) * N + r0 + r) * C + col, out + r * C + col,
                   (C - col < kChunk ? C - col : kChunk) * 2);
    }
    bulk_commit();
    if (C < 0) {
      const int n_rows = N - r0 < tile_rows ? N - r0 : tile_rows;"""),
    ("  if (!SLICED && threadIdx.x == 0) bulk_wait_read();   // the stores have read shared memory",
     "  if (!SLICED) bulk_wait_read();")]

# graph_msg's wide form: no msg stores; one or three staging buffers; the
# items ordered slices innermost (a block's boxes reloaded at every item)
# instead of groups innermost
_MSGW_NO_STORE = [("        if (lane < n_rows)\n          bulk_store(",
                   "        if (lane < n_rows && C < 0)\n          bulk_store(")]
_MSGW_THREE_BUFFERS = _const("kMsgMaxBufs", 2, 3) + [
    ("  p.slices = slices;\n  return p;",
     "  p.slices = slices;\n"
     "  if (p.nbuf == 2 && p.smem + 16 * p.mt * p.pitch * 2 <= kMsgSmemMax) {\n"
     "    p.smem += 16 * p.mt * p.pitch * 2;\n"
     "    p.nbuf = 3;\n"
     "  }\n  return p;")]
# the chunks turned over the warps from tile to tile (warp w takes j = (w +
# t) % 8, + 8, ... of tile t; resident boxes only), so a box has no single
# user: every warp waits on all of a slice's boxes when it enters the slice
# and releases all of them when it leaves (empty counts every warp)
_MSGW_ROTATE = [
    ("  const bool stream = plan.ring > 0;   // reload the boxes every tile\n",
     "  const bool stream = plan.ring > 0;   // reload the boxes every tile\n"
     "  const bool rotate = SLICED && !stream;\n"),
    ("      mbar_init(&empty[q], 1);", "      mbar_init(&empty[q], rotate ? kMsgWarps : 1);"),
    ("      cur = panel(x);\n    }",
     "      cur = panel(x);\n"
     "      if (rotate)\n"
     "        for (int q = 0; q < slots; ++q) mbar_wait(&full[q], round & 1);\n    }"),
    ("    for (int j = warp, lr = 0; j < plan.chunks; j += kMsgWarps) {",
     "    for (int j = rotate ? (warp + t) % kMsgWarps : warp, lr = 0; j < plan.chunks;\n"
     "         j += kMsgWarps) {"),
    ("        slot_of(warp, lr, round, q, ph);\n",
     "        if (rotate) {\n"
     "          q = first_slot(j % kMsgWarps) + (j / kMsgWarps) * plan.kchunks + kc;\n"
     "          ph = round;\n"
     "        } else {\n"
     "          slot_of(warp, lr, round, q, ph);\n"
     "        }\n"),
    ("        if (release) {   // the box's last use",
     "        if (release && !rotate) {   // the box's last use"),
    ("    if (lane == 0) mbar_arrive(&a_empty[aq]);   // this warp is done with the w_aff stage\n",
     "    if (lane == 0) mbar_arrive(&a_empty[aq]);   // this warp is done with the w_aff stage\n"
     "    if (rotate && release && lane == 0)\n"
     "      for (int q = 0; q < slots; ++q) mbar_arrive(&empty[q]);\n")]
# w_aff pairs read by one 4-byte load where T is even (rows 4-byte aligned)
_MSGW_A_WORDS = [
    ("      const bool ok = r0 + gq + r < N;\n",
     "      const bool ok = r0 + gq + r < N;\n"
     "      if (SLICED && T % 2 == 0)\n"
     "        return ok && k < T ? *reinterpret_cast<const uint32_t*>(w) : 0u;\n")]
# the widest slice capped at `cap` columns instead of kMsgSliceMax (None:
# as wide as shared memory holds, 1088 columns at phase 17's shape)
def _slice_cap(cap):
    return [("    int w = cols < kMsgSliceMax ? cols : kMsgSliceMax;",
             f"    int w = cols < {cap} ? cols : {cap};" if cap else "    int w = cols;")]


_MSGW_ONE_BUFFER = [("  p.slices = slices;\n", "  p.slices = slices;\n  p.nbuf = 1;\n")]
_MSGW_SLICES_INNERMOST = [
    ("""    ++g;
    if (++grp == parts) {
      grp = 0;
      if constexpr (SLICED) {
        if (++sl < slices) return;
        sl = 0;
      }
      ++s;
    }""", """    ++g;
    if constexpr (SLICED) {
      if (++sl < slices) return;
      sl = 0;
    }
    if (++grp == parts) {
      grp = 0;
      ++s;
    }"""),
    ("  const MsgTile start{g0, g0 / (parts * slices), g0 % parts, 0, (g0 / parts) % slices};",
     "  const MsgTile start{g0, g0 / (parts * slices), (g0 / slices) % parts, 0, g0 % slices};")]

# the SE sum's wide form: two blocks per SM (a 128-register cap)
_SE_WIDE_TWO_PER_SM = [
    ("__global__ void __launch_bounds__(kSeThreads, 1)\nse_sum_wide_kernel",
     "__global__ void __launch_bounds__(kSeThreads, 2)\nse_sum_wide_kernel")]
# the dz pass's wide form: no dz stores, or dz stored evict-first; the row
# scalars' loads of v and g evict-first (ld.global.cs)
_DZ_WIDE_NO_STORE = [("      store_bf<VEC>(dzrow + h * C, d);",
                      "      if (C < 0) store_bf<VEC>(dzrow + h * C, d);")]
_DZ_WIDE_STREAMING_STORES = [
    ("      store_bf<VEC>(dzrow + h * C, d);",
     "      __stcs(reinterpret_cast<BfBitsT<VEC>*>(dzrow + h * C), pack_bf<VEC>(d));")]
_DZ_WIDE_SCALARS_STREAMING_LOADS = [
    ("vb[h] = *reinterpret_cast<const BfBitsT<VEC>*>(vr + h * C + c);",
     "vb[h] = __ldcs(reinterpret_cast<const BfBitsT<VEC>*>(vr + h * C + c));"),
    ("const BfBitsT<VEC> gb = *reinterpret_cast<const BfBitsT<VEC>*>(gr + c);",
     "const BfBitsT<VEC> gb = __ldcs(reinterpret_cast<const BfBitsT<VEC>*>(gr + c));")]
_DZ_WIDE_SCALARS_UNROLL4 = [("#pragma unroll 2\n  for (int c = VEC * lane;",
                             "#pragma unroll 4\n  for (int c = VEC * lane;")]

# group -> (source, wrapper, [chip_smoke path], {variant: edits})
GROUPS = {
    "dz": ("mutan_bwd", "mutan_bwd_dz", ["train_bs8"], {
        "final": [],
        "no compute (the ring's reads only)": _DZ_NO_COMPUTE,
        "no dz stores": _DZ_NO_STORE,
        "ring of 3 stages": _const("kDzStages", 2, 3),
        "ring of 4 stages": _const("kDzStages", 2, 4),
        "8-byte vectors, 8 consumer warps": _DZ_VEC4,
        "8-byte vectors, two blocks per SM": _DZ_VEC4 + _DZ_TWO_PER_SM,
        "16-byte vectors, 4 consumer warps": _DZ_VEC8,
        "cp.async warp producer": _DZ_CP_ASYNC,
    }),
    "raw": ("convlstm", "convlstm_raw", ["forward_bs8", "serving_bs1",
                                         "forward_bs64"], {
        "final": [],
        "no transcendental math": _RAW_NO_MATH,
        "two blocks per SM": _const("kRawBlocksPerSM", 3, 2),
        "four blocks per SM": _const("kRawBlocksPerSM", 3, 4),
        "f32 cell update": _RAW_F32_UPDATE,
    }),
    "msg": ("graph_conv", "graph_msg", ["forward_bs8", "serving_bs1",
                                        "forward_bs64"], {
        "final": [],
        "no msg stores": _MSG_NO_STORE,
        "no product": _MSG_NO_PRODUCT,
        "no product, no stores (pooled loads alone)": _MSG_NO_PRODUCT + _MSG_NO_STORE,
        "no A gather (a constant A)": _MSG_NO_A_GATHER,
        "no statistics": _MSG_NO_STATS,
        "no staging writes": _MSG_NO_STAGING,
        "sums of squares on the tensor cores": _MSG_SQ_MMA,
        "one block per group": _MSG_GRID_PER_GROUP,
        "16-row tiles": _MSG_16_ROW_TILES,
        "pooled streamed every tile (8 slots)": _const("kMsgMaxSlots", 64, 8),
        "16 consumer warps": _const("kMsgWarps", 8, 16),
        "rows stored in 64-column pieces": _MSG_SPLIT_STORES,
    }),
    "se_wide": ("se_sum", "se_sum", ["wide_bs2"], {
        "final": [],
        "two blocks per SM": _SE_WIDE_TWO_PER_SM,
    }),
    "msg_wide": ("graph_conv", "graph_msg", ["wide_bs2"], {
        "final": [],
        "no msg stores": _MSGW_NO_STORE,
        "no product": _MSG_NO_PRODUCT,
        "no staging writes": _MSG_NO_STAGING,
        "no statistics": _MSG_NO_STATS,
        "no A gather (a constant A)": _MSG_NO_A_GATHER,
        "no product, staging, statistics or stores": _MSG_NO_PRODUCT + _MSG_NO_STAGING
        + _MSG_NO_STATS + _MSGW_NO_STORE,
        "three staging buffers": _MSGW_THREE_BUFFERS,
        "chunks turned over the warps by tile": _MSGW_ROTATE,
        "A pairs by 4-byte loads (even T)": _MSGW_A_WORDS,
        "slices of at most 512 columns": _slice_cap(512),
        "slices of at most 768 columns": _slice_cap(768),
        "slices as wide as fit (1088 columns)": _slice_cap(None),
        "one staging buffer": _MSGW_ONE_BUFFER,
        "slices innermost": _MSGW_SLICES_INNERMOST,
    }),
    "dz_wide": ("mutan_bwd", "mutan_bwd_dz", ["wide_train_bs2"], {
        "final": [],
        "no dz stores": _DZ_WIDE_NO_STORE,
        "dz stores evict-first (st.global.cs)": _DZ_WIDE_STREAMING_STORES,
        "ring of 2 rows": _const("kDzWideDepth", 4, 2),
        "ring of 6 rows": _const("kDzWideDepth", 4, 6),
        "three stream blocks per SM": _const("kDzWideMinBlocks", 2, 3),
        "scalars: 4 rows a block": _const("kDzWideRowWarps", 8, 4),
        "scalars: loop unrolled 4": _DZ_WIDE_SCALARS_UNROLL4,
        "scalars: v and g loads evict-first": _DZ_WIDE_SCALARS_STREAMING_LOADS,
    }),
}
# the kernel whose SASS opcodes (tensor-core products, TMA, shared-memory
# traffic) the tool counts in each variant's build
SASS_KERNEL = {"msg": "graph_msg_kernel", "msg_wide": "graph_msg_wide_kernel"}
SASS_OPS = ("HMMA", "LDSM", "UTMALDG", "UTMASTG", "UBLKCP", "STS", "LDG", "BAR",
            "SYNCS")


def edited_source(src, edits):
    text = (build.CSRC / f"{src}.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"kernel_variants: an edit no longer applies to "
                             f"{src}.cu: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(out, src, variants):
    """Compile each variant in parallel; returns {name: loaded library}."""
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = out / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in build.CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        (d / f"{src}.cu").write_text(edited_source(src, edits))
        log = open(d / "nvcc.log", "w")
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / f"lib{src}.so"), str(d / f"{src}.cu")], stdout=log,
            stderr=subprocess.STDOUT), d, log)
    libs = {}
    for name, (proc, d, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            raise SystemExit(f"kernel_variants: {name}: nvcc exit {rc}\n"
                             + (d / "nvcc.log").read_text()[-4000:])
        lib = ctypes.CDLL(str(d / f"lib{src}.so"))
        for fn, (argtypes, restype) in build.SIGNATURES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.cmpc_error_string.argtypes = [ctypes.c_int]
        lib.cmpc_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def sass_counts(lib_path, kernel):
    """Counts of SASS_OPS in the compiled `kernel` of a library (cuobjdump
    from the CUDA toolkit), or None where cuobjdump is missing."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    counts, inside = dict.fromkeys(SASS_OPS, 0), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?);", line)
        if inside and m:
            words = m.group(1).split()
            op = words[1] if words[0].startswith("@") and len(words) > 1 \
                else words[0]
            base = op.split(".")[0]
            if base in counts:
                counts[base] += 1
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("group", choices=sorted(GROUPS))
    ap.add_argument("--out", default="build/kernel_variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA GPU")
    src, name, cases, variants = GROUPS[args.group]
    libs = build_variants(Path(args.out) / args.group, src, variants)
    card = chip_smoke.card_line()
    sass = {}
    if args.group in SASS_KERNEL:
        for i, variant in enumerate(libs):
            sass[variant] = sass_counts(
                Path(args.out) / args.group / f"v{i}" / f"lib{src}.so",
                SASS_KERNEL[args.group])
            print(f"[{card}] SASS of {SASS_KERNEL[args.group]}, {variant}: "
                  f"{sass[variant]}", flush=True)
    wrapper = getattr(kernels, name)
    dev = torch.device("cuda")
    order = list(libs) + list(libs)[:1]
    results = []
    specs = chip_smoke.path_specs(get_config)
    for path in cases:
        spec = specs[path]
        inputs = chip_smoke.kernel_inputs(torch, kernels, cmpc, dev, spec)
        fargs, kw, bk, groups = inputs[name]
        del inputs
        want = kernels.PLAIN[wrapper](*fargs, **kw)
        others = len(fargs[1]) if name == "se_sum" else 2
        bound_ms = chip_smoke.bound(*chip_smoke.kernel_cost(
            name, bk, groups, spec, others))[0]
        row = []
        for variant in order:
            build._loaded[src] = libs[variant]
            got = wrapper(*fargs, **kw)
            torch.cuda.synchronize()
            # statistics partials are held summed over their slots
            err = max(((a.float().sum(1) - b.float().sum(1)).abs().max()
                       / b.float().sum(1).abs().max()).item()
                      if a.shape != b.shape else
                      ((a.float() - b.float()).abs().max()
                       / b.float().abs().max()).item()
                      for a, b in zip(got[:2], want[:2]))
            ms = chip_smoke.gpu_ms(torch, lambda: wrapper(*fargs, **kw))
            row.append({"variant": variant, "ms": ms, "norm_err": err})
        print(f"[{card}] {name} at {path} (bound {bound_ms:.4f} ms): "
              + "; ".join(f"{r['variant']} {r['ms']:.4f} ms (err "
                          f"{r['norm_err']:.1e})" for r in row), flush=True)
        results.append({"path": path, "bound_ms": bound_ms, "runs": row})
    build._loaded.pop(src, None)
    print(json.dumps({"card": card, "kernel": name, "results": results,
                      "sass": sass}))


if __name__ == "__main__":
    main()
