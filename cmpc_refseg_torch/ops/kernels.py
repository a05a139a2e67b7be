"""The port's hand-written Hopper kernels: wrappers, plain versions, counts.

Counterpart of the JAX package's ops/pallas_kernels.py.  Each kernel is CUDA
C++ for sm_90a under ``csrc/`` (built by ``ops/build.py``) and has here:

- a wrapper that checks its tensors and launches the kernel on PyTorch's
  current stream, outputs allocated with ``torch.empty``;
- a plain PyTorch version of the same function, which the wrapper runs
  only when its tensors lie on the CPU (for a CUDA tensor it launches the
  kernel or raises);
- a launch count (``wrapper.launches``), raised by one per kernel launch.

The wrappers of five kernels also have a wide form, hand-written in the
same source file, which they launch exactly where the main kernel refuses
the shape: a row wider than the affinity's or the SE sum's cluster covers,
a graph width past the update's or the message's shared memory, a dz row
past its ring.  The affinity's, the update's and the SE sum's run their
main kernel's pipeline with the whole-row reduction carried in device
memory, the message's runs its main pipeline over column slices, and the
dz pass's is a three-launch vector stream.  A wide launch counts in
the wrapper's ``launches`` like any other, and also in its
``wide_launches`` (`wide_launch_counts`), so a run can show which form it
took.

The plain versions' products, and the head's other products in the
compute dtype, go through `matmul_f32`: bf16 on cuBLAS's tensor cores with
f32 accumulation on the card, widened to f32 elsewhere, each call counted
by route (`product_route_counts`).

Which TPU kernel each replaces, what bounds it on the card and what its
design does about that is noted at the top of its source file.
"""

from __future__ import annotations

import ctypes

import torch

from cmpc_refseg_torch.ops import build

_LN_EPS = 1e-12
# the widths past which the main kernels refuse a shape and the wrappers
# launch the wide forms (csrc/spa_affinity.cu kAffMaxCluster * kAffBN,
# csrc/se_sum.cu kSeMaxCluster * kSeBN, csrc/graph_conv.cu kUpdMaxC; the
# message and dz kernels' plans are asked of their libraries)
AFFINITY_MAX_A = 2048
SE_SUM_MAX_C = 1024
UPDATE_MAX_C = 4096


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU, False when all are on one CUDA
    device; raises on anything else."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors on {sorted(map(str, devices))}: expected all "
                     "on the CPU or all on one CUDA device")


def _expect(name: str, t, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _multiple_of(vec: int, **dims) -> None:
    for name, v in dims.items():
        if v % vec:
            raise ValueError(f"{name}={v}: this CUDA kernel needs a multiple "
                             f"of {vec} ({2 * vec}-byte vector loads)")


def _aligned16(**tensors) -> None:
    """TMA reads and writes these tensors: their base addresses must be
    16-byte aligned."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data_ptr() {t.data_ptr():#x} is not "
                             "16-byte aligned (TMA needs it)")


def _check_groups(bsz: int, groups: int, what: str) -> None:
    if groups < 1 or bsz % groups:
        raise ValueError(f"{what}: batch {bsz} not divisible by {groups} "
                         "weight groups")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# products with f32 accumulation (cuBLAS)
# ---------------------------------------------------------------------------

def _mm_f32(a, b):
    """a @ b of two matrices or two equal batches of them, f32 result."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """a @ b of bf16 CUDA operands with an f32 result (cuBLAS on the tensor
    cores, f32 accumulation), differentiable: the backward's two products
    take the cotangent in bf16 (see `matmul_f32`) and accumulate in f32,
    and each gradient comes back in its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        need_a, need_b = ctx.needs_input_grad
        ga = _mm_f32(g, b.mT).to(a.dtype) if need_a else None
        gb = _mm_f32(a.mT, g).to(b.dtype) if need_b else None
        return ga, gb


# `matmul_f32`'s calls by route (`product_route_counts`)
_ROUTES = {"tensor_core": 0, "widened": 0}


def matmul_f32(a, b):
    """a @ b with f32 accumulation and an f32 result, whatever the inputs'
    dtype (the JAX package's ``preferred_element_type=float32``).  Two bf16
    CUDA operands, `b` a matrix (shared by a's leading axes) or both
    batches [B, M, K] @ [B, K, N] (transposed views too), go to cuBLAS as
    they are through `_MatmulF32`; anything else (f32, f64, mixed dtypes,
    CPU tensors) is widened to f32 first: the same exact products and f32
    sums.  `product_route_counts` counts the calls by route.

    `_MatmulF32`'s backward rounds the cotangent to bf16, which loses
    nothing where the caller rounds the product to bf16.  A product whose
    f32 result is used as it is (attention logits, a pooled vector) is
    called with widened operands, so that its backward keeps the f32
    cotangent, as the JAX package's transpose of the product does."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and (
            b.dim() == 2 or a.dim() == b.dim() == 3
            and a.shape[0] == b.shape[0]):
        _ROUTES["tensor_core"] += 1
        if b.dim() == 3:
            return _MatmulF32.apply(a, b)
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    _ROUTES["widened"] += 1
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# mutan (csrc/mutan.cu)
# ---------------------------------------------------------------------------

def _acc(t):
    """`t` in the accumulation dtype of the mutan plain versions: f32, or
    f64 for f64 inputs (gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _mutan_terms(x, w, b, lang, heads, rows_per_sample):
    """v = tanh(x @ W + b) [M, heads*C] and out = l2norm_row(tanh(sum_h v_h *
    lang_h)) [M, C], both f32 (the product accumulates in f32)."""
    m = x.shape[0]
    c = w.shape[1] // heads
    bsz = m // rows_per_sample
    v = torch.tanh(_acc(x) @ _acc(w) + _acc(b))
    prod = v.view(bsz, rows_per_sample, heads, c) \
        * _acc(lang).view(bsz, 1, heads, c)
    y = torch.tanh(prod.sum(dim=2)).view(m, c)
    sq = torch.sum(y * y, dim=-1, keepdim=True)
    return v, y * torch.rsqrt(torch.clamp(sq, min=1e-12))


def mutan_plain(x, w, b, lang, *, heads: int, rows_per_sample: int):
    """l2norm_row(tanh(sum_h tanh(x @ W_h + b_h) * lang_h)).

    x [M, K]; w [K, heads*C] (x dtype); b [heads*C] f32; lang [M/N, heads*C]
    f32, row r of x using lang row r // rows_per_sample -> [M, C] x dtype.
    The product accumulates in f32; the tanh chain and norm run in f32."""
    return _mutan_terms(x, w, b, lang, heads, rows_per_sample)[1].to(x.dtype)


def mutan_fwd_residual_plain(x, w, b, lang, *, heads: int,
                             rows_per_sample: int):
    """`mutan_plain` that also returns the training residual v = tanh(x @ W
    + b) [M, heads*C] in x's dtype: (out, v).  out is computed from the f32
    v, as the kernel computes it."""
    v, out = _mutan_terms(x, w, b, lang, heads, rows_per_sample)
    return out.to(x.dtype), v.to(x.dtype)


def _mutan_launch(x, w, b, lang, heads, rows_per_sample, residual):
    """One launch of the mutan kernel; with `residual` it also writes v."""
    m, k = x.shape
    c = w.shape[1] // heads
    if m % rows_per_sample:
        raise ValueError(f"rows {m} not a multiple of rows_per_sample "
                         f"{rows_per_sample}")
    bsz = m // rows_per_sample
    _expect("x", x, torch.bfloat16, (m, k))
    _expect("w", w, torch.bfloat16, (k, heads * c))
    _expect("b", b, torch.float32, (heads * c,))
    _expect("lang", lang, torch.float32, (bsz, heads * c))
    _multiple_of(8, K=k, C=c)
    _aligned16(x=x, w=w)
    lib = build.library("mutan")
    tiles = lib.cmpc_mutan_col_tiles(c)
    y = torch.empty((m, c), dtype=torch.float32, device=x.device)
    rowsq = torch.empty((m, tiles), dtype=torch.float32, device=x.device)
    out = torch.empty((m, c), dtype=torch.bfloat16, device=x.device)
    v = torch.empty((m, heads * c), dtype=torch.bfloat16, device=x.device) \
        if residual else None
    rc = lib.cmpc_mutan_fused(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                              lang.data_ptr(), y.data_ptr(), rowsq.data_ptr(),
                              out.data_ptr(), None if v is None else
                              v.data_ptr(), m, k, c, rows_per_sample, heads,
                              _stream())
    build.check(lib, rc, "mutan_fused")
    return out, v


def mutan_fused(x, w, b, lang, *, heads: int, rows_per_sample: int):
    """Wrapper of the mutan kernel; same contract as `mutan_plain`."""
    if _on_cpu(x, w, b, lang):
        return mutan_plain(x, w, b, lang, heads=heads,
                           rows_per_sample=rows_per_sample)
    out, _ = _mutan_launch(x, w, b, lang, heads, rows_per_sample, False)
    mutan_fused.launches += 1
    return out


mutan_fused.launches = 0


def mutan_fwd_residual(x, w, b, lang, *, heads: int, rows_per_sample: int):
    """Wrapper of the mutan kernel's training form (out and the bf16
    residual v); same contract as `mutan_fwd_residual_plain`."""
    if _on_cpu(x, w, b, lang):
        return mutan_fwd_residual_plain(x, w, b, lang, heads=heads,
                                        rows_per_sample=rows_per_sample)
    out = _mutan_launch(x, w, b, lang, heads, rows_per_sample, True)
    mutan_fwd_residual.launches += 1
    return out


mutan_fwd_residual.launches = 0


def mutan_bwd_dz_plain(v, lang, g, *, heads: int, rows_per_sample: int):
    """The mutan backward's dz pass (pallas_kernels.py:506-524 of the JAX
    package), in f32 from the residual v: per row acc = sum_h v_h * lang_h,
    y = tanh(acc), out = y * rsqrt(max(sum y^2, 1e-12)); from the cotangent
    g of out, dacc = dy * (1 - y^2) with dy the l2norm's vjp, and
    dz_h = dacc * lang_h * (1 - v_h^2).

    v [M, heads*C]; lang [M/N, heads*C] f32; g [M, C] -> (dz [M, heads*C]
    in v's dtype, dlang [M/N, heads*C] f32 = the sum over each sample's rows
    of dacc * v_h, db [heads*C] f32 = the sum over all rows of the f32 dz)."""
    m, wd = v.shape
    c = wd // heads
    bsz = m // rows_per_sample
    eps = 1e-12
    vf = _acc(v).view(bsz, rows_per_sample, heads, c)
    lf = _acc(lang).view(bsz, 1, heads, c)
    y = torch.tanh((vf * lf).sum(dim=2))                     # [B, N, C]
    sq = torch.sum(y * y, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.clamp(sq, min=eps))
    out = y * r
    gt = _acc(g).view(bsz, rows_per_sample, c)
    gy = torch.sum(gt * out, dim=-1, keepdim=True)
    dy = torch.where(sq > eps, (gt - out * gy) * r, gt * r)
    dacc = (dy * (1.0 - y * y))[:, :, None, :]              # [B, N, 1, C]
    dz = dacc * lf * (1.0 - vf * vf)                         # [B, N, H, C]
    dlang = (dacc * vf).sum(dim=1).reshape(bsz, wd)
    db = dz.sum(dim=(0, 1)).reshape(wd)
    return dz.reshape(m, wd).to(v.dtype), dlang, db


def mutan_bwd_dz_scratch(m: int, rows_per_sample: int, c: int,
                         heads: int) -> tuple:
    """Shape of the dz pass's f32 scratch for m rows of heads * c columns:
    one dlang slot per (block, sample) it holds and one db slot per block,
    so it is bounded by the grid (sized to the card), not by m.  Where the
    main kernel does not take the shape (heads * C past its ring), the wide
    form's: the same slots for its row ranges (one wave of stream
    threads), then the per-row norm and gy.  Needs the card; raises for
    heads outside 1..8 or an odd C."""
    if not 1 <= heads <= 8 or c < 2 or c % 2:
        raise ValueError(f"mutan_bwd_dz: C={c}, heads={heads}: the dz pass "
                         "takes 1 to 8 heads of an even C")
    lib = build.library("mutan_bwd")
    wd, bsz = heads * c, m // rows_per_sample
    blocks = lib.cmpc_mutan_dz_blocks(m, c, heads)
    if blocks >= 1:
        return (2 * blocks + bsz - 1, wd)
    ranges = lib.cmpc_mutan_dz_wide_ranges(m, c, heads)
    return (2 * ranges + bsz - 1 + -(-2 * m // wd), wd)


def mutan_bwd_dz(v, lang, g, *, heads: int, rows_per_sample: int):
    """Wrapper of the dz kernel; same contract as `mutan_bwd_dz_plain`."""
    if _on_cpu(v, lang, g):
        return mutan_bwd_dz_plain(v, lang, g, heads=heads,
                                  rows_per_sample=rows_per_sample)
    m, wd = v.shape
    c = wd // heads
    if m % rows_per_sample:
        raise ValueError(f"rows {m} not a multiple of rows_per_sample "
                         f"{rows_per_sample}")
    bsz = m // rows_per_sample
    _expect("v", v, torch.bfloat16, (m, heads * c))
    _expect("lang", lang, torch.float32, (bsz, heads * c))
    _expect("g", g, torch.bfloat16, (m, c))
    _multiple_of(2, C=c)
    _aligned16(v=v, g=g)
    lib = build.library("mutan_bwd")
    part = torch.empty(mutan_bwd_dz_scratch(m, rows_per_sample, c, heads),
                       dtype=torch.float32, device=v.device)
    dz = torch.empty((m, wd), dtype=torch.bfloat16, device=v.device)
    dlang = torch.empty((bsz, wd), dtype=torch.float32, device=v.device)
    db = torch.empty((wd,), dtype=torch.float32, device=v.device)
    # heads * C past the main kernel's ring: the wide form, whose vector
    # loads of lang need it 16-byte aligned (a copy where it is not)
    wide = lib.cmpc_mutan_dz_blocks(m, c, heads) < 1
    if wide and lang.data_ptr() % 16:
        lang = lang.clone()
    launch = lib.cmpc_mutan_bwd_dz_wide if wide else lib.cmpc_mutan_bwd_dz
    rc = launch(v.data_ptr(), lang.data_ptr(), g.data_ptr(), dz.data_ptr(),
                part.data_ptr(), dlang.data_ptr(), db.data_ptr(), m, c,
                rows_per_sample, heads, _stream())
    build.check(lib, rc, "mutan_bwd_dz")
    mutan_bwd_dz.launches += 1
    mutan_bwd_dz.wide_launches += wide
    return dz, dlang, db


mutan_bwd_dz.launches = 0
mutan_bwd_dz.wide_launches = 0


def mutan_dw_plain(x, dz):
    """dW = x^T @ dz with f32 accumulation: x [M, K], dz [M, W] -> [K, W]
    f32."""
    return _acc(x).t() @ _acc(dz)


def mutan_dw(x, dz):
    """Wrapper of the dW kernel; same contract as `mutan_dw_plain`."""
    if _on_cpu(x, dz):
        return mutan_dw_plain(x, dz)
    m, k = x.shape
    wd = dz.shape[1]
    _expect("x", x, torch.bfloat16, (m, k))
    _expect("dz", dz, torch.bfloat16, (m, wd))
    _multiple_of(8, K=k, W=wd)
    _aligned16(x=x, dz=dz)
    lib = build.library("mutan_bwd")
    splits = lib.cmpc_mutan_dw_splits(m)
    dw = torch.empty((k, wd), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, k, wd), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    rc = lib.cmpc_mutan_dw(x.data_ptr(), dz.data_ptr(), dw.data_ptr(),
                           None if part is None else part.data_ptr(), m, k,
                           wd, _stream())
    build.check(lib, rc, "mutan_dw")
    mutan_dw.launches += 1
    return dw


mutan_dw.launches = 0


# ---------------------------------------------------------------------------
# spatial-graph affinity (csrc/spa_affinity.cu)
# ---------------------------------------------------------------------------

def spa_affinity_plain(x, wg, bg, wt, rel, mask, *, scale: float, l2n: bool,
                       masked: bool):
    """Graph projection, scaled word-node affinity, relation scale and the
    two softmaxes (CMPC_model.py:380-399).

    x [B, N, C]; wg [C, A], bg [A], wt [B, T, A] (x dtype; wt already
    l2-normalized when l2n); rel, mask [B, 1, T] f32 -> (w_aff, v_aff)
    [B, N, T] f32.  `masked`: softmax over T of the masked logits (the
    'masked' / 'unmasked' graph norms); else softmax then mask."""
    dt = x.dtype
    gt = matmul_f32(x, wg).to(dt) + bg.to(dt)
    if l2n:
        gf = gt.float()
        sq = torch.sum(gf * gf, dim=-1, keepdim=True)
        gt = (gf * torch.reciprocal(torch.sqrt(torch.clamp(sq, min=1e-12)))
              ).to(dt)
    # f32 logits: widened (`matmul_f32`)
    affi = matmul_f32(gt.float(), wt.to(dt).float().transpose(1, 2))
    affi = rel * (affi / scale)
    if masked:
        neg = torch.finfo(torch.float32).min
        w_aff = torch.softmax(mask * affi + (1.0 - mask) * neg, dim=2)
    else:
        w_aff = mask * torch.softmax(affi, dim=2)
    v_aff = mask * torch.softmax(affi, dim=1)
    return w_aff, v_aff


def spa_affinity_grouped_plain(x, wgs, bgs, wt, rel, mask, *, scale: float,
                               l2n: bool, masked: bool):
    """The level-packed affinity: wgs [G, C, A], bgs [G, A]; samples
    [g*B/G, (g+1)*B/G) use group g.  Otherwise `spa_affinity_plain`."""
    groups = wgs.shape[0]
    _check_groups(x.shape[0], groups, "spa_affinity_grouped")
    per = x.shape[0] // groups
    outs = [spa_affinity_plain(x[s], wgs[g], bgs[g], wt[s], rel[s], mask[s],
                               scale=scale, l2n=l2n, masked=masked)
            for g in range(groups)
            for s in [slice(g * per, (g + 1) * per)]]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _affinity_launch(x, wgs, bgs, wt, rel, mask, *, scale, l2n, masked):
    """One launch of the affinity kernel with G = wgs.shape[0] groups."""
    bsz, n, c = x.shape
    groups, a = wgs.shape[0], wgs.shape[2]
    t = wt.shape[1]
    _check_groups(bsz, groups, "spa_affinity")
    _expect("x", x, torch.bfloat16, (bsz, n, c))
    _expect("wg", wgs, torch.bfloat16, (groups, c, a))
    _expect("bg", bgs, torch.bfloat16, (groups, a))
    _expect("wt", wt, torch.bfloat16, (bsz, t, a))
    _expect("rel", rel, torch.float32, (bsz, 1, t))
    _expect("mask", mask, torch.float32, (bsz, 1, t))
    _multiple_of(8, C=c, A=a)
    _aligned16(x=x, wg=wgs, wt=wt)
    lib = build.library("spa_affinity")
    # past one cluster's 8 x 256 columns: the wide form (csrc/spa_affinity.cu)
    wide = a > AFFINITY_MAX_A
    blocks = (lib.cmpc_spa_affinity_wide_row_blocks(n) if wide else
              lib.cmpc_spa_affinity_row_blocks(n, a))
    w_out = torch.empty((bsz, n, t), dtype=torch.float32, device=x.device)
    affi = torch.empty((bsz, n, t), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, blocks, 2, t), dtype=torch.float32,
                        device=x.device)
    ptrs = (x.data_ptr(), wgs.data_ptr(), bgs.data_ptr(), wt.data_ptr(),
            rel.data_ptr(), mask.data_ptr(), w_out.data_ptr(),
            affi.data_ptr(), stats.data_ptr())
    rest = (bsz, n, c, a, t, groups, float(scale), int(l2n), int(masked),
            _stream())
    if wide:
        scratch = torch.empty(lib.cmpc_spa_affinity_wide_scratch(bsz, n, a),
                              dtype=torch.uint8, device=x.device)
        rc = lib.cmpc_spa_affinity_wide(*ptrs, scratch.data_ptr(), *rest)
    else:
        rc = lib.cmpc_spa_affinity(*ptrs, *rest)
    build.check(lib, rc, "spa_affinity")
    col_max = stats[:, :, 0].amax(dim=1, keepdim=True)       # [B, 1, T]
    col_sum = torch.sum(stats[:, :, 1] * torch.exp(stats[:, :, 0] - col_max),
                        dim=1, keepdim=True)
    v_aff = mask * (torch.exp(affi - col_max) / col_sum)
    return (w_out, v_aff), wide


def spa_affinity(x, wg, bg, wt, rel, mask, *, scale: float, l2n: bool,
                 masked: bool):
    """Wrapper of the affinity kernel; same contract as `spa_affinity_plain`.
    The column softmax over N is finalised here from the kernel's per-block
    (max, sum exp) partials, as the JAX package finalises it in XLA."""
    if _on_cpu(x, wg, bg, wt, rel, mask):
        return spa_affinity_plain(x, wg, bg, wt, rel, mask, scale=scale,
                                  l2n=l2n, masked=masked)
    out, wide = _affinity_launch(x, wg[None], bg[None], wt, rel, mask,
                                 scale=scale, l2n=l2n, masked=masked)
    spa_affinity.launches += 1
    spa_affinity.wide_launches += wide
    return out


spa_affinity.launches = 0
spa_affinity.wide_launches = 0


def spa_affinity_grouped(x, wgs, bgs, wt, rel, mask, *, scale: float,
                         l2n: bool, masked: bool):
    """Wrapper of the affinity kernel's grouped form (one launch for all G
    levels); same contract as `spa_affinity_grouped_plain`."""
    if _on_cpu(x, wgs, bgs, wt, rel, mask):
        return spa_affinity_grouped_plain(x, wgs, bgs, wt, rel, mask,
                                          scale=scale, l2n=l2n, masked=masked)
    out, wide = _affinity_launch(x, wgs, bgs, wt, rel, mask, scale=scale,
                                 l2n=l2n, masked=masked)
    spa_affinity_grouped.launches += 1
    spa_affinity_grouped.wide_launches += wide
    return out


spa_affinity_grouped.launches = 0
spa_affinity_grouped.wide_launches = 0


# ---------------------------------------------------------------------------
# graph convolution (csrc/graph_conv.cu)
# ---------------------------------------------------------------------------

def _sum_stats(v):
    """[B, 1, 2] (sum, sum of squares) of a [B, N, C] tensor, in f32."""
    vf = v.float()
    return torch.stack([vf.sum(dim=(1, 2)), (vf * vf).sum(dim=(1, 2))],
                       dim=-1)[:, None]


def _width(c: int, width) -> int:
    """The number of columns a statistic counts: `width` (the unpadded
    width of a zero-padded tensor of c columns), or all c when None."""
    if width is None:
        return c
    if not 1 <= width <= c:
        raise ValueError(f"width={width}: expected 1..{c}")
    return int(width)


def ln_from_stats(v, stats, gamma, beta, width=None):
    """Whole-sample layer norm of v [B, N, C] from summed statistics
    [B, P, 2] (var = E[v^2] - mean^2, clamped at 0); f32 result.  gamma,
    beta [C], or [G, C] per group: samples [g*B/G, (g+1)*B/G) use row g.
    `width`: the count of true columns when columns width..C-1 are zero
    padding (zero in v, gamma and beta; the padding stays zero)."""
    bsz, n, c = v.shape
    s = stats.sum(dim=1)
    count = float(n * _width(c, width))
    mean = s[:, 0] / count
    var = torch.clamp(s[:, 1] / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + _LN_EPS)
    y = (v.float() - mean[:, None, None]) * inv[:, None, None]
    if gamma.dim() == 1:
        return torch.addcmul(beta, y, gamma)
    groups = gamma.shape[0]
    return torch.addcmul(beta[:, None], y.view(groups, -1, c),
                         gamma[:, None]).view(bsz, n, c)


def graph_msg_plain(w_aff, pooled):
    """msg = w_aff @ pooled per sample, rounded to the input dtype, and the
    whole-sample (sum, sum of squares) of the rounded msg.

    w_aff [B, N, T], pooled [B, T, C] -> (msg [B, N, C], stats [B, P, 2] f32)."""
    msg = matmul_f32(w_aff, pooled).to(pooled.dtype)
    return msg, _sum_stats(msg)


def graph_msg(w_aff, pooled):
    """Wrapper of the message kernel; same contract as `graph_msg_plain`."""
    if _on_cpu(w_aff, pooled):
        return graph_msg_plain(w_aff, pooled)
    bsz, n, t = w_aff.shape
    c = pooled.shape[2]
    _expect("w_aff", w_aff, torch.bfloat16, (bsz, n, t))
    _expect("pooled", pooled, torch.bfloat16, (bsz, t, c))
    if min(bsz, n, t, c) < 1:
        raise ValueError(f"graph_msg: empty shape B={bsz}, N={n}, T={t}, "
                         f"C={c}")
    _multiple_of(8, C=c)
    _aligned16(w_aff=w_aff, pooled=pooled)
    lib = build.library("graph_conv")
    # rows of msg staged whole (C <= 4096, C * T bounded), or the wide form
    wide = not lib.cmpc_graph_msg_smem(c, t)
    parts = (lib.cmpc_graph_msg_wide_parts(n, c, t) if wide else
             lib.cmpc_graph_msg_parts(n))
    msg = torch.empty((bsz, n, c), dtype=torch.bfloat16, device=w_aff.device)
    stats = torch.empty((bsz, parts, 2), dtype=torch.float32,
                        device=w_aff.device)
    launch = lib.cmpc_graph_msg_wide if wide else lib.cmpc_graph_msg
    rc = launch(w_aff.data_ptr(), pooled.data_ptr(), msg.data_ptr(),
                stats.data_ptr(), bsz, n, c, t, _stream())
    build.check(lib, rc, "graph_msg")
    graph_msg.launches += 1
    graph_msg.wide_launches += wide
    return msg, stats


graph_msg.launches = 0
graph_msg.wide_launches = 0


def graph_update_plain(x, msg, stats1, w, b, g1, b1, *, width=None):
    """z = relu(x + LN1(msg)) @ w + b, rounded to x's dtype, and the
    whole-sample (sum, sum of squares) of z.

    x, msg [B, N, C]; stats1 [B, P, 2] f32 (msg's); w [C, C], b [C] (x
    dtype); g1, b1 [C] f32 -> (z [B, N, C], stats [B, P', 2] f32).
    `width`: LN1's count of true columns (`ln_from_stats`)."""
    dt = x.dtype
    y = torch.relu(x + ln_from_stats(msg, stats1, g1, b1, width).to(dt))
    z = matmul_f32(y, w).to(dt) + b
    return z, _sum_stats(z)


def graph_update_grouped_plain(x, msg, stats1, ws, bs, g1s, b1s, *,
                               width=None):
    """The level-packed update: ws [G, C, C], bs, g1s, b1s [G, C]; samples
    [g*B/G, (g+1)*B/G) use group g.  Otherwise `graph_update_plain`."""
    groups = ws.shape[0]
    _check_groups(x.shape[0], groups, "graph_update_grouped")
    per = x.shape[0] // groups
    outs = [graph_update_plain(x[s], msg[s], stats1[s], ws[g], bs[g], g1s[g],
                               b1s[g], width=width)
            for g in range(groups)
            for s in [slice(g * per, (g + 1) * per)]]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _update_launch(x, msg, stats1, ws, bs, g1s, b1s, width):
    """One launch of the update kernel with G = ws.shape[0] groups."""
    bsz, n, c = x.shape
    groups = ws.shape[0]
    parts1 = stats1.shape[1]
    _check_groups(bsz, groups, "graph_update")
    _expect("x", x, torch.bfloat16, (bsz, n, c))
    _expect("msg", msg, torch.bfloat16, (bsz, n, c))
    _expect("stats1", stats1, torch.float32, (bsz, parts1, 2))
    _expect("w", ws, torch.bfloat16, (groups, c, c))
    _expect("b", bs, torch.bfloat16, (groups, c))
    _expect("g1", g1s, torch.float32, (groups, c))
    _expect("b1", b1s, torch.float32, (groups, c))
    _multiple_of(8, C=c)
    _aligned16(x=x, msg=msg, w=ws)
    # LN1's affine of at most 4096 columns in shared memory, or the wide
    # form, which bulk-copies each K step's columns of it (both forms write
    # the statistics in one layout)
    wide = c > UPDATE_MAX_C
    if wide:
        _aligned16(g1=g1s, b1=b1s)
    lib = build.library("graph_conv")
    parts = lib.cmpc_graph_update_parts(n, c)
    z = torch.empty((bsz, n, c), dtype=torch.bfloat16, device=x.device)
    stats = torch.empty((bsz, parts, 2), dtype=torch.float32, device=x.device)
    launch = lib.cmpc_graph_update_wide if wide else lib.cmpc_graph_update
    rc = launch(x.data_ptr(), msg.data_ptr(), stats1.data_ptr(), parts1,
                ws.data_ptr(), bs.data_ptr(), g1s.data_ptr(), b1s.data_ptr(),
                z.data_ptr(), stats.data_ptr(), bsz, n, c, _width(c, width),
                groups, _stream())
    build.check(lib, rc, "graph_update")
    return (z, stats), wide


def graph_update(x, msg, stats1, w, b, g1, b1, *, width=None):
    """Wrapper of the update kernel; same contract as `graph_update_plain`."""
    if _on_cpu(x, msg, stats1, w, b, g1, b1):
        return graph_update_plain(x, msg, stats1, w, b, g1, b1, width=width)
    out, wide = _update_launch(x, msg, stats1, w[None], b[None], g1[None],
                               b1[None], width)
    graph_update.launches += 1
    graph_update.wide_launches += wide
    return out


graph_update.launches = 0
graph_update.wide_launches = 0


def graph_update_grouped(x, msg, stats1, ws, bs, g1s, b1s, *, width=None):
    """Wrapper of the update kernel's grouped form (one launch for all G
    levels); same contract as `graph_update_grouped_plain`."""
    if _on_cpu(x, msg, stats1, ws, bs, g1s, b1s):
        return graph_update_grouped_plain(x, msg, stats1, ws, bs, g1s, b1s,
                                          width=width)
    out, wide = _update_launch(x, msg, stats1, ws, bs, g1s, b1s, width)
    graph_update_grouped.launches += 1
    graph_update_grouped.wide_launches += wide
    return out


graph_update_grouped.launches = 0
graph_update_grouped.wide_launches = 0


# ---------------------------------------------------------------------------
# gated-exchange SE sum (csrc/se_sum.cu)
# ---------------------------------------------------------------------------

def se_sum_plain(feat, others, gates, ws, bs):
    """l2norm_row(feat + sum_i relu(others_i @ ws_i + bs_i) * gates_i),
    rounded to feat's dtype at each step as the TPU kernel rounds: the
    product (f32 accumulation), the bias add, the gating and each add; the
    row norm in f32.

    feat, others_i [B, N, C]; gates_i [B, C]; ws_i [C, C]; bs_i [C] (all
    feat's dtype) -> [B, N, C]."""
    dt = feat.dtype
    acc = feat
    for o, g, w, b in zip(others, gates, ws, bs):
        t = matmul_f32(o, w).to(dt) + b
        acc = acc + torch.relu(t) * g[:, None, :]
    af = acc.float()
    sq = torch.sum(af * af, dim=-1, keepdim=True)
    return (af * torch.rsqrt(torch.clamp(sq, min=1e-12))).to(dt)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def se_sum(feat, others, gates, ws, bs):
    """Wrapper of the SE-sum kernel; same contract as `se_sum_plain`."""
    if _on_cpu(feat, *others, *gates, *ws, *bs):
        return se_sum_plain(feat, others, gates, ws, bs)
    bsz, n, c = feat.shape
    k = len(others)
    if not 1 <= k <= 4 or not len(gates) == len(ws) == len(bs) == k:
        raise ValueError(f"se_sum: {k} others, {len(gates)} gates, {len(ws)} "
                         f"weights, {len(bs)} biases; the kernel takes 1-4 "
                         "of each, as many of each")
    _expect("feat", feat, torch.bfloat16, (bsz, n, c))
    for i in range(k):
        _expect(f"others[{i}]", others[i], torch.bfloat16, (bsz, n, c))
        _expect(f"gates[{i}]", gates[i], torch.bfloat16, (bsz, c))
        _expect(f"ws[{i}]", ws[i], torch.bfloat16, (c, c))
        _expect(f"bs[{i}]", bs[i], torch.bfloat16, (c,))
    _multiple_of(4, C=c)
    lib = build.library("se_sum")
    out = torch.empty((bsz, n, c), dtype=torch.bfloat16, device=feat.device)
    ptrs = (feat.data_ptr(), _pointers(others), _pointers(ws), _pointers(bs),
            _pointers(gates), k, out.data_ptr())
    # rows past one cluster's 8 x 128 columns: the wide form
    wide = c > SE_SUM_MAX_C
    if wide:
        scratch = torch.empty(lib.cmpc_se_sum_wide_scratch(bsz * n, c),
                              dtype=torch.uint8, device=feat.device)
        rc = lib.cmpc_se_sum_wide(*ptrs, scratch.data_ptr(), bsz * n, n, c,
                                  _stream())
    else:
        rc = lib.cmpc_se_sum(*ptrs, bsz * n, n, c, _stream())
    build.check(lib, rc, "se_sum")
    se_sum.launches += 1
    se_sum.wide_launches += wide
    return out


se_sum.launches = 0
se_sum.wide_launches = 0


# ---------------------------------------------------------------------------
# ConvLSTM step (csrc/convlstm.cu)
# ---------------------------------------------------------------------------

def convlstm_gates_plain(x, h, c, w, ci, cf):
    """The 4 gates (j, i, f, o) = bf16([x | h] @ w), the peepholes i +=
    ci * c and f += cf * c (in x's dtype), and the whole-sample (sum, sum
    of squares) of j, i and f.

    x, h, c [B, N, C]; w [2C, 4C]; ci, cf [N, C] (x dtype) ->
    (gates [4, B, N, C], stats [B, P, 3, 2] f32)."""
    dt = x.dtype
    y = matmul_f32(torch.cat([x, h], dim=-1), w).to(dt)
    j, i, f, o = torch.split(y, x.shape[-1], dim=-1)
    i = i + ci * c
    f = f + cf * c
    stats = torch.stack([_sum_stats(v) for v in (j, i, f)], dim=2)
    return torch.stack([j, i, f, o]), stats


def convlstm_gates(x, h, c, w, ci, cf):
    """Wrapper of the ConvLSTM gates kernel; same contract as
    `convlstm_gates_plain`."""
    if _on_cpu(x, h, c, w, ci, cf):
        return convlstm_gates_plain(x, h, c, w, ci, cf)
    bsz, n, cc = x.shape
    for name, t in (("x", x), ("h", h), ("c", c)):
        _expect(name, t, torch.bfloat16, (bsz, n, cc))
    _expect("w", w, torch.bfloat16, (2 * cc, 4 * cc))
    _expect("ci", ci, torch.bfloat16, (n, cc))
    _expect("cf", cf, torch.bfloat16, (n, cc))
    _multiple_of(4, C=cc)
    _aligned16(w=w)
    lib = build.library("convlstm")
    parts = lib.cmpc_convlstm_gates_parts(n, cc)
    gates = torch.empty((4, bsz, n, cc), dtype=torch.bfloat16,
                        device=x.device)
    stats = torch.empty((bsz, parts, 3, 2), dtype=torch.float32,
                        device=x.device)
    rc = lib.cmpc_convlstm_gates(x.data_ptr(), h.data_ptr(), c.data_ptr(),
                                 w.data_ptr(), ci.data_ptr(), cf.data_ptr(),
                                 gates.data_ptr(), stats.data_ptr(), bsz, n,
                                 cc, _stream())
    build.check(lib, rc, "convlstm_gates")
    convlstm_gates.launches += 1
    return gates, stats


convlstm_gates.launches = 0


def convlstm_raw_plain(gates, c, co, stats, gamma, beta, *, width=None):
    """j, i, f layer-normed from their (sum, sum of squares); then
    new_c_raw = c * sigmoid(f + 1) + sigmoid(i) * tanh(j) (the cell's fixed
    forget bias 1.0) and
    o_raw = o + co * new_c_raw, each factor and result in c's dtype, and
    the whole-sample (sum, sum of squares) of new_c_raw and o_raw.

    gates [4, B, N, C]; c [B, N, C]; co [N, C] (c dtype); stats
    [B, P, 3, 2]; gamma, beta [5, C] f32 (j, i, f, o, c) ->
    (new_c_raw, o_raw [B, N, C], stats [B, P', 2, 2] f32).  `width`: the
    layer norms' count of true columns where columns width..C-1 are zero
    padding (zero gates, peepholes, gamma and beta; the padding stays
    zero)."""
    dt = c.dtype

    def ln(k):
        return ln_from_stats(gates[k], stats[:, :, k], gamma[k], beta[k],
                             width)

    jn = torch.tanh(ln(0)).to(dt)
    i_s = torch.sigmoid(ln(1)).to(dt)
    f_s = torch.sigmoid(ln(2) + 1.0).to(dt)
    new_c_raw = c * f_s + i_s * jn
    o_raw = gates[3] + co * new_c_raw
    stats2 = torch.stack([_sum_stats(new_c_raw), _sum_stats(o_raw)], dim=2)
    return new_c_raw, o_raw, stats2


def convlstm_raw(gates, c, co, stats, gamma, beta, *, width=None):
    """Wrapper of the ConvLSTM raw kernel; same contract as
    `convlstm_raw_plain`."""
    if _on_cpu(gates, c, co, stats, gamma, beta):
        return convlstm_raw_plain(gates, c, co, stats, gamma, beta,
                                  width=width)
    bsz, n, cc = c.shape
    parts1 = stats.shape[1]
    _expect("gates", gates, torch.bfloat16, (4, bsz, n, cc))
    _expect("c", c, torch.bfloat16, (bsz, n, cc))
    _expect("co", co, torch.bfloat16, (n, cc))
    _expect("stats", stats, torch.float32, (bsz, parts1, 3, 2))
    _expect("gamma", gamma, torch.float32, (5, cc))
    _expect("beta", beta, torch.float32, (5, cc))
    _multiple_of(4, C=cc)
    lib = build.library("convlstm")
    parts = lib.cmpc_convlstm_raw_parts(bsz, n, cc)
    if parts < 1:
        raise RuntimeError("convlstm_raw: the CUDA device could not be "
                           "queried for the kernel's grid")
    new_c_raw = torch.empty((bsz, n, cc), dtype=torch.bfloat16,
                            device=c.device)
    o_raw = torch.empty_like(new_c_raw)
    stats2 = torch.empty((bsz, parts, 2, 2), dtype=torch.float32,
                         device=c.device)
    rc = lib.cmpc_convlstm_raw(gates.data_ptr(), c.data_ptr(), co.data_ptr(),
                               stats.data_ptr(), parts1, gamma.data_ptr(),
                               beta.data_ptr(), new_c_raw.data_ptr(),
                               o_raw.data_ptr(), stats2.data_ptr(), bsz, n,
                               cc, _width(cc, width), _stream())
    build.check(lib, rc, "convlstm_raw")
    convlstm_raw.launches += 1
    return new_c_raw, o_raw, stats2


convlstm_raw.launches = 0

KERNELS = (mutan_fused, mutan_fwd_residual, mutan_bwd_dz, mutan_dw,
           spa_affinity, spa_affinity_grouped, graph_msg, graph_update,
           graph_update_grouped, se_sum, convlstm_gates, convlstm_raw)
PLAIN = {mutan_fused: mutan_plain,
         mutan_fwd_residual: mutan_fwd_residual_plain,
         mutan_bwd_dz: mutan_bwd_dz_plain, mutan_dw: mutan_dw_plain,
         spa_affinity: spa_affinity_plain,
         spa_affinity_grouped: spa_affinity_grouped_plain,
         graph_msg: graph_msg_plain, graph_update: graph_update_plain,
         graph_update_grouped: graph_update_grouped_plain,
         se_sum: se_sum_plain, convlstm_gates: convlstm_gates_plain,
         convlstm_raw: convlstm_raw_plain}


WIDE = (mutan_bwd_dz, spa_affinity, spa_affinity_grouped, graph_msg,
        graph_update, graph_update_grouped, se_sum)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def wide_launch_counts() -> dict:
    """The launches of each wrapper that went to its wide form."""
    return {k.__name__: k.wide_launches for k in WIDE}


def product_route_counts() -> dict:
    """The `matmul_f32` calls by route: 'tensor_core' (bf16 on cuBLAS) and
    'widened' (operands widened to f32)."""
    return dict(_ROUTES)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in WIDE:
        k.wide_launches = 0
    for route in _ROUTES:
        _ROUTES[route] = 0
