"""The port's hand-written Hopper kernels: wrappers, plain versions, counts.

Counterpart of the JAX package's ops/pallas_kernels.py.  Each kernel is CUDA
C++ for sm_90a under ``csrc/`` (built by ``ops/build.py``) and has here:

- a wrapper that checks its tensors and launches the kernel on PyTorch's
  current stream, outputs allocated with ``torch.empty``;
- a plain PyTorch version of the same function, which the wrapper runs
  only when its tensors lie on the CPU (for a CUDA tensor it launches the
  kernel or raises);
- a launch count (``wrapper.launches``), raised by one per kernel launch.

Which TPU kernel each replaces, what bounds it on the card and what its
design does about that is noted at the top of its source file.
"""

from __future__ import annotations

import torch

from cmpc_refseg_torch.ops import build

_LN_EPS = 1e-12


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


def _multiple_of_8(**dims) -> None:
    for name, v in dims.items():
        if v % 8:
            raise ValueError(f"{name}={v}: the CUDA kernels need a multiple "
                             "of 8 (16-byte vector loads)")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# mutan (csrc/mutan.cu)
# ---------------------------------------------------------------------------

def mutan_plain(x, w, b, lang, *, heads: int, rows_per_sample: int):
    """l2norm_row(tanh(sum_h tanh(x @ W_h + b_h) * lang_h)).

    x [M, K]; w [K, heads*C] (x dtype); b [heads*C] f32; lang [M/N, heads*C]
    f32, row r of x using lang row r // rows_per_sample -> [M, C] x dtype.
    The product accumulates in f32; the tanh chain and norm run in f32."""
    m = x.shape[0]
    c = w.shape[1] // heads
    bsz = m // rows_per_sample
    v = torch.tanh(x.float() @ w.float() + b.float())
    prod = v.view(bsz, rows_per_sample, heads, c) \
        * lang.float().view(bsz, 1, heads, c)
    y = torch.tanh(prod.sum(dim=2)).view(m, c)
    sq = torch.sum(y * y, dim=-1, keepdim=True)
    return (y * torch.rsqrt(torch.clamp(sq, min=1e-12))).to(x.dtype)


def mutan_fused(x, w, b, lang, *, heads: int, rows_per_sample: int):
    """Wrapper of the mutan kernel; same contract as `mutan_plain`."""
    if _on_cpu(x, w, b, lang):
        return mutan_plain(x, w, b, lang, heads=heads,
                           rows_per_sample=rows_per_sample)
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
    _multiple_of_8(K=k, C=c)
    lib = build.library("mutan")
    tiles = lib.cmpc_mutan_col_tiles(c)
    y = torch.empty((m, c), dtype=torch.float32, device=x.device)
    rowsq = torch.empty((m, tiles), dtype=torch.float32, device=x.device)
    out = torch.empty((m, c), dtype=torch.bfloat16, device=x.device)
    rc = lib.cmpc_mutan_fused(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                              lang.data_ptr(), y.data_ptr(), rowsq.data_ptr(),
                              out.data_ptr(), m, k, c, rows_per_sample, heads,
                              _stream())
    build.check(lib, rc, "mutan_fused")
    mutan_fused.launches += 1
    return out


mutan_fused.launches = 0


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
    gt = (x.float() @ wg.float()).to(dt) + bg.to(dt)
    if l2n:
        gf = gt.float()
        sq = torch.sum(gf * gf, dim=-1, keepdim=True)
        gt = (gf * torch.reciprocal(torch.sqrt(torch.clamp(sq, min=1e-12)))
              ).to(dt)
    affi = gt.float() @ wt.to(dt).float().transpose(1, 2)     # [B, N, T]
    affi = rel * (affi / scale)
    if masked:
        neg = torch.finfo(torch.float32).min
        w_aff = torch.softmax(mask * affi + (1.0 - mask) * neg, dim=2)
    else:
        w_aff = mask * torch.softmax(affi, dim=2)
    v_aff = mask * torch.softmax(affi, dim=1)
    return w_aff, v_aff


def spa_affinity(x, wg, bg, wt, rel, mask, *, scale: float, l2n: bool,
                 masked: bool):
    """Wrapper of the affinity kernel; same contract as `spa_affinity_plain`.
    The column softmax over N is finalised here from the kernel's per-block
    (max, sum exp) partials, as the JAX package finalises it in XLA."""
    if _on_cpu(x, wg, bg, wt, rel, mask):
        return spa_affinity_plain(x, wg, bg, wt, rel, mask, scale=scale,
                                  l2n=l2n, masked=masked)
    bsz, n, c = x.shape
    t, a = wt.shape[1], wt.shape[2]
    _expect("x", x, torch.bfloat16, (bsz, n, c))
    _expect("wg", wg, torch.bfloat16, (c, a))
    _expect("bg", bg, torch.bfloat16, (a,))
    _expect("wt", wt, torch.bfloat16, (bsz, t, a))
    _expect("rel", rel, torch.float32, (bsz, 1, t))
    _expect("mask", mask, torch.float32, (bsz, 1, t))
    _multiple_of_8(C=c, A=a)
    if t > 32:
        raise ValueError(f"T={t}: the affinity kernel takes at most 32 words")
    lib = build.library("spa_affinity")
    blocks = lib.cmpc_spa_affinity_row_blocks(n)
    w_out = torch.empty((bsz, n, t), dtype=torch.float32, device=x.device)
    affi = torch.empty((bsz, n, t), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, blocks, 2, t), dtype=torch.float32,
                        device=x.device)
    rc = lib.cmpc_spa_affinity(x.data_ptr(), wg.data_ptr(), bg.data_ptr(),
                               wt.data_ptr(), rel.data_ptr(), mask.data_ptr(),
                               w_out.data_ptr(), affi.data_ptr(),
                               stats.data_ptr(), bsz, n, c, a, t, float(scale),
                               int(l2n), int(masked), _stream())
    build.check(lib, rc, "spa_affinity")
    spa_affinity.launches += 1
    col_max = stats[:, :, 0].amax(dim=1, keepdim=True)       # [B, 1, T]
    col_sum = torch.sum(stats[:, :, 1] * torch.exp(stats[:, :, 0] - col_max),
                        dim=1, keepdim=True)
    v_aff = mask * (torch.exp(affi - col_max) / col_sum)
    return w_out, v_aff


spa_affinity.launches = 0


# ---------------------------------------------------------------------------
# graph convolution (csrc/graph_conv.cu)
# ---------------------------------------------------------------------------

def _sum_stats(v):
    """[B, 1, 2] (sum, sum of squares) of a [B, N, C] tensor, in f32."""
    vf = v.float()
    return torch.stack([vf.sum(dim=(1, 2)), (vf * vf).sum(dim=(1, 2))],
                       dim=-1)[:, None]


def ln_from_stats(v, stats, gamma, beta):
    """Whole-sample layer norm of v [B, N, C] from summed statistics
    [B, P, 2] (var = E[v^2] - mean^2, clamped at 0); f32 result."""
    cnt = float(v.shape[1] * v.shape[2])
    s = stats.sum(dim=1)
    mean = s[:, 0] / cnt
    var = torch.clamp(s[:, 1] / cnt - mean * mean, min=0.0)
    inv = torch.rsqrt(var + _LN_EPS)
    return (v.float() - mean[:, None, None]) * inv[:, None, None] * gamma \
        + beta


def graph_msg_plain(w_aff, pooled):
    """msg = w_aff @ pooled per sample, rounded to the input dtype, and the
    whole-sample (sum, sum of squares) of the rounded msg.

    w_aff [B, N, T], pooled [B, T, C] -> (msg [B, N, C], stats [B, P, 2] f32)."""
    msg = (w_aff.float() @ pooled.float()).to(pooled.dtype)
    return msg, _sum_stats(msg)


def graph_msg(w_aff, pooled):
    """Wrapper of the message kernel; same contract as `graph_msg_plain`."""
    if _on_cpu(w_aff, pooled):
        return graph_msg_plain(w_aff, pooled)
    bsz, n, t = w_aff.shape
    c = pooled.shape[2]
    _expect("w_aff", w_aff, torch.bfloat16, (bsz, n, t))
    _expect("pooled", pooled, torch.bfloat16, (bsz, t, c))
    _multiple_of_8(C=c)
    if t > 32:
        raise ValueError(f"T={t}: the message kernel takes at most 32 words")
    lib = build.library("graph_conv")
    parts = lib.cmpc_graph_msg_parts(n)
    msg = torch.empty((bsz, n, c), dtype=torch.bfloat16, device=w_aff.device)
    stats = torch.empty((bsz, parts, 2), dtype=torch.float32,
                        device=w_aff.device)
    rc = lib.cmpc_graph_msg(w_aff.data_ptr(), pooled.data_ptr(),
                            msg.data_ptr(), stats.data_ptr(), bsz, n, c, t,
                            _stream())
    build.check(lib, rc, "graph_msg")
    graph_msg.launches += 1
    return msg, stats


graph_msg.launches = 0


def graph_update_plain(x, msg, stats1, w, b, g1, b1):
    """z = relu(x + LN1(msg)) @ w + b, rounded to x's dtype, and the
    whole-sample (sum, sum of squares) of z.

    x, msg [B, N, C]; stats1 [B, P, 2] f32 (msg's); w [C, C], b [C] (x
    dtype); g1, b1 [C] f32 -> (z [B, N, C], stats [B, P', 2] f32)."""
    dt = x.dtype
    y = torch.relu(x + ln_from_stats(msg, stats1, g1, b1).to(dt))
    z = (y.float() @ w.float()).to(dt) + b
    return z, _sum_stats(z)


def graph_update(x, msg, stats1, w, b, g1, b1):
    """Wrapper of the update kernel; same contract as `graph_update_plain`."""
    if _on_cpu(x, msg, stats1, w, b, g1, b1):
        return graph_update_plain(x, msg, stats1, w, b, g1, b1)
    bsz, n, c = x.shape
    parts1 = stats1.shape[1]
    _expect("x", x, torch.bfloat16, (bsz, n, c))
    _expect("msg", msg, torch.bfloat16, (bsz, n, c))
    _expect("stats1", stats1, torch.float32, (bsz, parts1, 2))
    _expect("w", w, torch.bfloat16, (c, c))
    _expect("b", b, torch.bfloat16, (c,))
    _expect("g1", g1, torch.float32, (c,))
    _expect("b1", b1, torch.float32, (c,))
    _multiple_of_8(C=c)
    lib = build.library("graph_conv")
    parts = lib.cmpc_graph_update_parts(n, c)
    z = torch.empty((bsz, n, c), dtype=torch.bfloat16, device=x.device)
    stats = torch.empty((bsz, parts, 2), dtype=torch.float32, device=x.device)
    rc = lib.cmpc_graph_update(x.data_ptr(), msg.data_ptr(), stats1.data_ptr(),
                               parts1, w.data_ptr(), b.data_ptr(),
                               g1.data_ptr(), b1.data_ptr(), z.data_ptr(),
                               stats.data_ptr(), bsz, n, c, _stream())
    build.check(lib, rc, "graph_update")
    graph_update.launches += 1
    return z, stats


graph_update.launches = 0

KERNELS = (mutan_fused, spa_affinity, graph_msg, graph_update)
PLAIN = {mutan_fused: mutan_plain, spa_affinity: spa_affinity_plain,
         graph_msg: graph_msg_plain, graph_update: graph_update_plain}


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
