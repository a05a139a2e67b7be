"""CMPC head: language parser, mutan fusion, relation-aware spatial graph,
gated multi-level exchange and ConvLSTM fusion (CMPC_model.py:144-410).

The port of the JAX package's models/cmpc.py: the flagship's head, the
graph norms 'masked', 'unmasked', 'softmax_mask' and 'double_softmax', and
the self-gated exchange of CMPCv6.  Mutan, the spatial-graph affinity, the
graph convolution, the exchange's SE sum and the ConvLSTM step run through
the hand-written kernels of ``ops/kernels.py`` (their plain versions when
the tensors lie on the CPU, or everywhere with ``use_kernels=False``).
The JAX package leaves the double-softmax affinity and the self-gated
exchange to XLA; they are plain PyTorch here (the graph convolution after
the double softmax still runs through its kernels).  The spatial graph
runs level by level, or level-packed (one set of launches for all levels,
grouped weights) at small batch: `pack_levels` holds the rule.

Where autograd records (``torch.is_grad_enabled()``, as in the train
step), the kernels run through the autograd functions of
``ops/autograd.py``, from the f32 trainable weights cast on every call;
the weights `model.prepare_params` builds once serve inference only, which
runs under ``torch.inference_mode``.

The JAX package's plain references `_mutan_reference`,
`_spa_affinity_xla` and `_se_sum_xla` are ``kernels.mutan_plain``,
``kernels.spa_affinity_plain`` and ``kernels.se_sum_plain`` here, beside
their kernels; `_graph_conv` stays below as the graph kernels' plain
route.

Any width: the kernels take column counts that are multiples of 8 (16-byte
bf16 rows; 4 for the SE sum and the ConvLSTM's), the JAX package any.
Each kernel call here pads its operands with zero columns (its weights
with zero rows and columns: per mutan head, per ConvLSTM gate block and
input half) up to the kernel's multiple and slices its output back.  Zero
biases, gammas and betas in the padding keep the padded columns exactly
zero through every stage, and the layer norms count the true width (the
kernels' `width`).  Widths already at those multiples (every registry
config's) pad nothing.

The [HW, HW] adjacency is never materialized: ``adj @ X = W @ (V^T @ X)``.
Init functions return numpy trees in the JAX package's layout (HWIO
kernels); ``convert.params_from_jax`` turns them into tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cmpc_refseg_torch.ops import autograd, kernels
from cmpc_refseg_torch.ops.kernels import matmul_f32
from cmpc_refseg_torch.ops.layers import (conv2d, glorot_uniform, init_conv,
                                          init_layer_norm, split_stream)
from cmpc_refseg_torch.ops.normalization import l2_normalize, tf1_layer_norm


# the kernels' column multiples: 16-byte bf16 rows for the TMA kernels
# (mutan, the affinity, the graph convolution), 8-byte rows for the SE sum
# and the ConvLSTM's
COLUMN_MULTIPLE = 8
FUSION_COLUMN_MULTIPLE = 4


def padded(c: int, multiple: int = COLUMN_MULTIPLE) -> int:
    """`c` rounded up to a kernel's column multiple."""
    return c + (-c % multiple)


def pad_cols(t, cp: int):
    """`t` with zero columns appended on its last axis up to `cp`
    (differentiable; `t` itself when it is that wide already)."""
    pad = cp - t.shape[-1]
    return F.pad(t, (0, pad)) if pad else t


def pad_blocks(t, blocks: int, cp: int):
    """`t`'s last axis, `blocks` equal blocks of C columns, with each block
    padded by zero columns to `cp` (differentiable)."""
    c = t.shape[-1] // blocks
    if c == cp:
        return t
    lead = t.shape[:-1]
    return pad_cols(t.reshape(*lead, blocks, c), cp).reshape(*lead,
                                                             blocks * cp)


def pad_square(w, cp: int):
    """A [..., C, C] weight with zero rows and columns up to [..., Cp, Cp]."""
    pad = cp - w.shape[-1]
    return F.pad(w, (0, pad, 0, pad)) if pad else w


def _differentiable(use_kernels: bool) -> bool:
    """Whether a head op takes the kernels' autograd route
    (``ops/autograd.py``): with the kernels, where autograd records."""
    return use_kernels and torch.is_grad_enabled()


# ---------------------------------------------------------------------------
# Language parser
# ---------------------------------------------------------------------------

def init_lang_parser(key, cfg):
    """2x 1x1 conv -> softmax over word types (CMPC_model.py:347-357)."""
    k1, k2 = split_stream(key, 2)
    return {
        "words_parse_1": init_conv(k1, 1, cfg.lang_dim, 500),
        "words_parse_2": init_conv(k2, 1, 500, cfg.parse_classes),
    }


def apply_lang_parser(params, words_feat, seq_mask):
    """words_feat [B,1,T,C] -> words_parse [B,1,T,K], masked softmax weights
    over {Entity, Attribute, Relation, Unnecessary}."""
    x = torch.relu(conv2d(params["words_parse_1"], words_feat))
    x = conv2d(params["words_parse_2"], x)
    return torch.softmax(x, dim=-1) * seq_mask


def valid_lang_feat(words_parse, words_feat, class_idx):
    """(sum of the given parse classes)-weighted word sum, l2-normalized
    (valid_lang CMPC_model.py:166-178; nec_lang :180-192)."""
    w = sum(words_parse[:, 0, :, c] for c in class_idx)      # [B,T]
    pooled = torch.einsum("bt,btc->bc", w, words_feat[:, 0])
    return l2_normalize(pooled, -1)[:, None, None, :]        # [B,1,1,C]


# ---------------------------------------------------------------------------
# Mutan fusion
# ---------------------------------------------------------------------------

def init_mutan(key, cfg, num_heads: int = 5):
    """Fused-head mutan params (the 5 reference per-head convs stacked along
    the output axis, CMPC_model.py:295-319)."""
    k1, k2 = split_stream(key, 2)
    vin = cfg.v_emb_dim + cfg.spatial_dim
    return {
        "vis_trans": init_conv(k1, 1, vin, num_heads * cfg.v_emb_dim),
        "lang_trans": init_conv(k2, 1, cfg.lang_dim, num_heads * cfg.v_emb_dim),
    }


def pad_mutan_weight(w, heads: int = 5):
    """The visual weight [K, heads*C] as the kernel takes it: zero rows
    appended up to the next multiple of 8 rows, the K that `apply_mutan`
    pads its input to, and each head's C columns padded with zero columns
    to `padded(C)` (the kernel's TMA boxes need 16-byte rows).
    Differentiable: the gradient of the padding is sliced off."""
    pad = -w.shape[0] % 8
    w = F.pad(w, (0, 0, 0, pad)) if pad else w
    return pad_blocks(w, heads, padded(w.shape[1] // heads))


def apply_mutan(params, lang_feat, spatial_feat, visual_feat,
                num_heads: int = 5, *, use_kernels: bool = True):
    """sum_h tanh(conv_h([vis, spatial])) * tanh(conv_h(lang)), tanh, l2norm
    (CMPC_model.py:311-328), as one mutan kernel launch (where autograd
    records, the training form through `autograd.mutan`).  K = v_emb_dim +
    spatial_dim is padded with zero columns of the input and zero rows of
    the weight to a multiple of 8 on every route (the JAX package pads it
    at parameter prep, pallas_kernels.py:41-76), and each head's C output
    columns to `padded(C)`: zero weight columns, biases and language
    columns make the padded output columns exactly 0, and they are sliced
    off.  The padded visual weight in the compute dtype is
    `params['w_wide']` when model.prepare_params built it, else padded and
    cast here."""
    b, h, w, c = visual_feat.shape
    dt = visual_feat.dtype
    parts = [visual_feat, spatial_feat.to(dt)]
    pad = -(c + spatial_feat.shape[-1]) % 8
    if pad:
        parts.append(visual_feat.new_zeros(b, h, w, pad))
    vis_in = torch.cat(parts, dim=-1)
    lang = torch.tanh(conv2d(params["lang_trans"], lang_feat))  # [B,1,1,5C]
    x = vis_in.reshape(b * h * w, vis_in.shape[-1])
    cp = padded(c)
    rest = (pad_blocks(params["vis_trans"]["biases"].float(), num_heads, cp),
            pad_blocks(lang.reshape(b, -1).float(), num_heads, cp))
    kw = dict(heads=num_heads, rows_per_sample=h * w)
    if _differentiable(use_kernels):
        w_pad = pad_mutan_weight(params["vis_trans"]["DW"][0, 0], num_heads)
        out = autograd.mutan(x, w_pad, *rest, **kw)
    else:
        w_wide = params.get("w_wide")
        if w_wide is None:
            w_wide = pad_mutan_weight(params["vis_trans"]["DW"][0, 0],
                                      num_heads).to(dt)
        fn = kernels.mutan_fused if use_kernels else kernels.mutan_plain
        out = fn(x, w_wide, *rest, **kw)
    return out[:, :c].reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# Relation-aware spatial graph
# ---------------------------------------------------------------------------

def init_spa_graph(key, cfg):
    ks = split_stream(key, 2 + cfg.num_graph_conv)
    affin_dim = cfg.vw_emb_dim or cfg.v_emb_dim
    p = {
        "words_trans": init_conv(ks[0], 1, cfg.lang_dim, affin_dim),
        "spa_graph_trans2": init_conv(ks[1], 1, cfg.v_emb_dim, affin_dim),
        "gconv": [],
    }
    for i in range(cfg.num_graph_conv):
        p["gconv"].append({
            "update": init_conv(ks[2 + i], 1, cfg.v_emb_dim, cfg.v_emb_dim),
            "feat_ln": init_layer_norm(cfg.v_emb_dim),
            "update_ln": init_layer_norm(cfg.v_emb_dim),
        })
    return p


def _graph_conv(gp, x_nodes, w_aff, v_aff):
    """Plain graph convolution (CMPC_model.py:359-374) with the factored
    adjacency: message = w_aff @ (v_aff^T @ x), two-pass layer norms.

    x_nodes [B,N,C]; w_aff, v_aff [B,N,T] f32; products in the node dtype
    with f32 accumulation."""
    dt = x_nodes.dtype
    w_aff = w_aff.to(dt)
    v_aff = v_aff.to(dt)
    pooled = matmul_f32(v_aff.transpose(1, 2), x_nodes).to(dt)   # [B,T,C]
    msg = matmul_f32(w_aff, pooled).to(dt)
    msg = tf1_layer_norm(msg[:, None], gp["feat_ln"]["gamma"],
                         gp["feat_ln"]["beta"])[:, 0]
    y = torch.relu(x_nodes + msg)
    y = conv2d(gp["update"], y[:, None])[:, 0]
    y = tf1_layer_norm(y[:, None], gp["update_ln"]["gamma"],
                       gp["update_ln"]["beta"])[:, 0]
    return torch.relu(y)


def _graph_conv_grouped(gps, x_nodes, w_aff, v_aff):
    """Plain graph convolution of the level-packed batch: samples
    [g*B/G, (g+1)*B/G) use gps[g]."""
    b = x_nodes.shape[0] // len(gps)
    return torch.cat([
        _graph_conv(gp, x_nodes[g * b:(g + 1) * b], w_aff[g * b:(g + 1) * b],
                    v_aff[g * b:(g + 1) * b])
        for g, gp in enumerate(gps)])


def _stack(leaves, dtype):
    return torch.stack(list(leaves)).to(dtype).contiguous()


def stack_gconv(gps, dtype):
    """One graph-conv round of G levels as `graph_conv` takes it, stacked
    along a leading group axis and padded with zeros to Cp = `padded(C)`:
    the update's `w` [G, Cp, Cp] and `b` [G, Cp] in `dtype`, its two layer
    norms' `g1`, `b1`, `g2`, `b2` [G, Cp] in f32."""
    cp = padded(gps[0]["update"]["DW"].shape[-1])

    def stack(leaves, dt):
        return pad_cols(_stack(leaves, dt), cp).contiguous()

    def ln(name, key):
        return stack((gp[name][key] for gp in gps), torch.float32)
    w = _stack((gp["update"]["DW"][0, 0] for gp in gps), dtype)
    return {"w": pad_square(w, cp).contiguous(),
            "b": stack((gp["update"]["biases"] for gp in gps), dtype),
            "g1": ln("feat_ln", "gamma"), "b1": ln("feat_ln", "beta"),
            "g2": ln("update_ln", "gamma"), "b2": ln("update_ln", "beta")}


def pad_projection(wgs, bgs):
    """The affinity's projection [G, C, A] and bias [G, A] with zero rows
    and columns up to [G, padded(C), padded(A)] (themselves when no width
    pads)."""
    c, a = wgs.shape[1:]
    cp, ap = padded(c), padded(a)
    if (cp, ap) != (c, a):
        wgs = F.pad(wgs, (0, ap - a, 0, cp - c))
    return wgs.contiguous(), pad_cols(bgs, ap).contiguous()


def stack_graph_params(params_list, dtype):
    """The spatial-graph weights of G levels as the kernels take them: the
    projection `wg` [G, Cp, Ap] and `bg` [G, Ap] in `dtype`
    (`pad_projection`), and each round's `stack_gconv`.
    model.prepare_params builds it once; `level_of` takes one level's
    slice."""
    projs = [p["spa_graph_trans2"] for p in params_list]
    wg, bg = pad_projection(_stack((q["DW"][0, 0] for q in projs), dtype),
                            _stack((q["biases"] for q in projs), dtype))
    return {"wg": wg, "bg": bg,
            "gconv": [stack_gconv([p["gconv"][r] for p in params_list], dtype)
                      for r in range(len(params_list[0]["gconv"]))]}


def level_of(stack, g: int):
    """Level g of a `stack_graph_params` stack, as a stack of one (views)."""
    return {"wg": stack["wg"][g:g + 1], "bg": stack["bg"][g:g + 1],
            "gconv": [{k: v[g:g + 1] for k, v in r.items()}
                      for r in stack["gconv"]]}


def graph_conv(gs, x_nodes, w_aff, v_aff):
    """The graph convolution through the graph_msg and graph_update
    kernels: pooled = v_aff^T @ x and the final relu(LN2(z)) are plain
    PyTorch, as the JAX package leaves them to XLA.

    `gs` is one round's `stack_gconv` of G groups; samples
    [g*B/G, (g+1)*B/G) use group g.  G = 1 launches the update kernel's
    ungrouped form, G > 1 its grouped form.  x_nodes [B, N, C] is padded
    to the stack's width and the output sliced back to C; the layer norms
    count C columns."""
    dt = x_nodes.dtype
    c = x_nodes.shape[-1]
    x_nodes = pad_cols(x_nodes, gs["w"].shape[-1])
    pooled = torch.matmul(v_aff.to(dt).transpose(1, 2), x_nodes)  # [B,T,Cp]
    msg, stats1 = kernels.graph_msg(w_aff.to(dt).contiguous(), pooled)
    weights = (gs["w"], gs["b"], gs["g1"], gs["b1"])
    if gs["w"].shape[0] == 1:
        z, stats2 = kernels.graph_update(x_nodes, msg, stats1,
                                         *(v[0] for v in weights), width=c)
    else:
        z, stats2 = kernels.graph_update_grouped(x_nodes, msg, stats1,
                                                 *weights, width=c)
    return torch.relu(kernels.ln_from_stats(z, stats2, gs["g2"], gs["b2"],
                                            c)[..., :c]).to(dt)


def affinity(x, wgs, bgs, wt, rel, mask, *, scale: float, l2n: bool,
             masked: bool, use_kernels: bool = True):
    """The spatial-graph affinity of G levels: wgs [G, Cp, Ap] and bgs
    [G, Ap] as `pad_projection` gives them, in x's dtype; x [B, N, C] and
    the word projections wt [B, T, A] are padded with zero columns to Cp
    and Ap.  The kernels (G = 1: the ungrouped form), or the plain
    version."""
    x = pad_cols(x, wgs.shape[1])
    wt = pad_cols(wt, wgs.shape[2]).contiguous()
    kw = dict(scale=scale, l2n=l2n, masked=masked)
    if not use_kernels:
        return kernels.spa_affinity_grouped_plain(x, wgs, bgs, wt, rel, mask,
                                                  **kw)
    if wgs.shape[0] == 1:
        return kernels.spa_affinity(x, wgs[0], bgs[0], wt, rel, mask, **kw)
    return kernels.spa_affinity_grouped(x, wgs, bgs, wt, rel, mask, **kw)


GRAPH_NORMS = ("masked", "unmasked", "softmax_mask", "double_softmax")


def _double_softmax_affinity(p, cfg, x, words_trans, words_parse):
    """The 'double_softmax' affinity (CMPCv4_BiLSTM_T2_model.py; cmpc.py:
    440-455 of the JAX package): node projections x @ Wg + bg in the node
    dtype, their product with the word projections in f32 over sqrt(C),
    a softmax over the nodes (axis 1, not the words), scaled by each
    word's relation probability.  Returns the [B,N,T] f32 affinity, which
    is both w_aff and v_aff."""
    graph_trans = conv2d(p["spa_graph_trans2"], x)              # [B,N,A]
    if cfg.l2norm_affinity:
        graph_trans = l2_normalize(graph_trans, -1)
    # f32 logits: widened (`matmul_f32`)
    affi = matmul_f32(graph_trans.float(),
                      words_trans.to(x.dtype).float().transpose(1, 2)) \
        / math.sqrt(cfg.v_emb_dim)
    return words_parse[:, :, :, 2].float() * torch.softmax(affi, dim=1)


def apply_spa_graph_grouped(params_list, cfg, spa_graphs, words_feat,
                            words_parse, seq_mask, *, stack=None,
                            use_kernels: bool = True):
    """Spatial graph reasoning (CMPC_model.py:376-410) of G levels in one
    set of launches: the levels' nodes are concatenated along the batch
    axis (level packing, cmpc.py:368-425 of the JAX package) and the
    affinity and graph update take the levels' weights as groups.  G = 1
    is one level alone, through the kernels' ungrouped forms.  The
    'double_softmax' norm always runs level by level, as in the JAX
    package: its affinity is plain PyTorch, its graph convolution one
    level's kernel launches.

    spa_graphs: G of [B,H,W,C]; words_feat [B,1,T,Cl]; seq_mask [B,1,T,1];
    `stack`: `stack_graph_params(params_list, ...)`, built here when None
    (the autograd route takes the weights from `params_list` instead,
    through the autograd functions).
    Returns (list of [B,H,W,C] outputs, list of (w_aff, v_aff))."""
    if cfg.graph_norm not in GRAPH_NORMS:
        raise ValueError(f"unknown graph_norm {cfg.graph_norm!r}")
    g_n = len(params_list)
    if cfg.graph_norm == "double_softmax" and g_n > 1:
        outs = [apply_spa_graph(p, cfg, sg, words_feat, words_parse,
                                seq_mask, stack=None if stack is None
                                else level_of(stack, i),
                                use_kernels=use_kernels)
                for i, (p, sg) in enumerate(zip(params_list, spa_graphs))]
        return [o[0] for o in outs], [o[1] for o in outs]
    b, h, w, c = spa_graphs[0].shape
    dt = spa_graphs[0].dtype
    grad_route = _differentiable(use_kernels)
    if stack is None and not grad_route:
        stack = stack_graph_params(params_list, dt)
    wts = []
    for p in params_list:
        wt = conv2d(p["words_trans"], words_feat)[:, 0]           # [B,T,A]
        if cfg.l2norm_affinity:
            wt = l2_normalize(wt, -1)
        wts.append(wt)
    x = spa_graphs[0].reshape(b, h * w, c) if g_n == 1 else \
        torch.cat([sg.reshape(b, h * w, c) for sg in spa_graphs])
    args = (torch.cat(wts).to(dt).contiguous(),
            words_parse[:, :, :, 2].float().repeat(g_n, 1, 1),
            seq_mask[:, :, :, 0].float().repeat(g_n, 1, 1))
    kw = dict(scale=math.sqrt(cfg.v_emb_dim), l2n=bool(cfg.l2norm_affinity),
              masked=cfg.graph_norm in ("masked", "unmasked"))
    if cfg.graph_norm == "double_softmax":
        w_aff = v_aff = _double_softmax_affinity(params_list[0], cfg, x,
                                                 wts[0], words_parse)
    elif grad_route:
        projs = [p["spa_graph_trans2"] for p in params_list]
        w_aff, v_aff = autograd.spa_affinity_grouped(
            x, [q["DW"][0, 0] for q in projs], [q["biases"] for q in projs],
            *args, **kw)
    else:
        w_aff, v_aff = affinity(x, stack["wg"], stack["bg"], *args, **kw,
                                use_kernels=use_kernels)

    for r in range(len(params_list[0]["gconv"])):
        gps = [p["gconv"][r] for p in params_list]
        if grad_route:
            x = autograd.graph_conv(gps, x, w_aff, v_aff)
        elif use_kernels:
            x = graph_conv(stack["gconv"][r], x, w_aff, v_aff)
        else:
            x = _graph_conv_grouped(gps, x, w_aff, v_aff)
    outs, gws = [], []
    for g in range(g_n):
        s = slice(g * b, (g + 1) * b)
        outs.append(l2_normalize(x[s].reshape(b, h, w, c), -1))
        gws.append((w_aff[s], v_aff[s]))
    return outs, gws


def apply_spa_graph(params, cfg, spa_graph, words_feat, words_parse, seq_mask,
                    *, stack=None, use_kernels: bool = True):
    """One level's spatial graph: `apply_spa_graph_grouped` with G = 1.
    Returns (out [B,H,W,C], (w_aff, v_aff))."""
    outs, gws = apply_spa_graph_grouped([params], cfg, [spa_graph],
                                        words_feat, words_parse, seq_mask,
                                        stack=stack, use_kernels=use_kernels)
    return outs[0], gws[0]


# ---------------------------------------------------------------------------
# lang2vis assembly
# ---------------------------------------------------------------------------

def init_lang2vis(key, cfg):
    k1, k2, k3, k4 = split_stream(key, 4)
    p = {"mutan": init_mutan(k1, cfg), "graph": init_spa_graph(k2, cfg)}
    if cfg.sent_fusion:
        # v6+ (CMPCv6_plus_model.py:417-433): a second mutan replaces the
        # concat, its conv C -> mlp
        p["sent_mutan"] = init_mutan(k3, cfg)
        p["fusion"] = init_conv(k4, 1, cfg.v_emb_dim, cfg.mlp_dim)
    else:
        fin = cfg.v_emb_dim * 2 + cfg.lang_dim + cfg.spatial_dim
        p["fusion"] = init_conv(k4, 1, fin, cfg.mlp_dim)
    return p


# The packed graph takes one launch of each kernel and its glue instead of
# one per level (the graph is bound by the host at small batch); it pays
# with the concatenated nodes and all levels' intermediates held at once.
# The 3-level graph at flagship widths on an NVIDIA H100 80GB HBM3,
# 700.00 W (chip_smoke.py, serving phase): host-clock ms per call and peak
# device memory per call, per-level vs packed:
#   b=1    3.798 vs  1.514 ms   0.027 vs 0.068 GB
#   b=8    4.527 vs  4.020 ms   0.213 vs 0.549 GB
#   b=32  14.956 vs 14.402 ms   0.850 vs 2.191 GB
#   b=64  28.288 vs 27.901 ms   1.699 vs 4.383 GB
#   b=128 55.026 vs 55.092 ms   3.398 vs 8.763 GB
# Packing won by >= 2.8% at every batch up to 32 in five runs (PERF.md).
# Above 32 it gains at most 1.4% (64) or loses (128), while its peak is
# 2.6x the per-level one (2.7 GB more at 64, 5.4 GB at 128): there memory
# decides, and the graph runs level by level.
LEVEL_PACK_MAX_BATCH = 32


def pack_levels(batch: int, num_levels: int,
                graph_norm: str = "masked") -> bool:
    """Whether the spatial graph runs level-packed at this batch (never
    under the 'double_softmax' norm, which runs level by level)."""
    return num_levels > 1 and batch <= LEVEL_PACK_MAX_BATCH \
        and graph_norm != "double_softmax"


def apply_spa_graph_levels(graphs, cfg, spa_graphs, words_feat, words_parse,
                           seq_mask, *, graph_stack=None,
                           use_kernels: bool = True):
    """The spatial graph of every level: level-packed when `pack_levels`
    says so at this batch, else level by level.  `graph_stack`: the
    levels' `stack_graph_params`, built here when None (not on the
    autograd route, which takes the f32 weights).  Returns (list of
    outputs, list of gw)."""
    if graph_stack is None and not _differentiable(use_kernels):
        graph_stack = stack_graph_params(graphs, spa_graphs[0].dtype)
    lang = (words_feat, words_parse, seq_mask)
    route = dict(use_kernels=use_kernels)
    if pack_levels(spa_graphs[0].shape[0], len(spa_graphs), cfg.graph_norm):
        return apply_spa_graph_grouped(graphs, cfg, spa_graphs, *lang,
                                       stack=graph_stack, **route)
    outs = [apply_spa_graph(g, cfg, v, *lang,
                            stack=None if graph_stack is None
                            else level_of(graph_stack, i), **route)
            for i, (g, v) in enumerate(zip(graphs, spa_graphs))]
    return [o[0] for o in outs], [o[1] for o in outs]


def apply_lang2vis_multi(params_list, cfg, visuals, words_feat, words_parse,
                         seq_mask, spatial, *, graph_stack=None,
                         use_kernels: bool = True):
    """Per-level cross-modal comprehension (CMPC_model.py:330-345) for all
    levels, the spatial graph level-packed when `pack_levels` says so.
    `graph_stack`: the levels' `stack_graph_params`, built here when None
    (not on the autograd route, which takes the f32 weights).
    Returns (list of fusions, list of gw)."""
    route = dict(use_kernels=use_kernels)
    valid = valid_lang_feat(words_parse, words_feat, (0, 1))  # E+A
    vis_list = [apply_mutan(p["mutan"], valid, spatial, v, **route)
                for p, v in zip(params_list, visuals)]
    feats, gws = apply_spa_graph_levels(
        [p["graph"] for p in params_list], cfg, vis_list, words_feat,
        words_parse, seq_mask, graph_stack=graph_stack, **route)
    if cfg.sent_fusion:
        # all parse classes but U (the reference's nec_lang)
        nec = valid_lang_feat(words_parse, words_feat,
                              tuple(range(cfg.parse_classes - 1)))
        fusions = [_sent_fuse(p, f, nec, spatial, **route)
                   for p, f in zip(params_list, feats)]
    else:
        fusions = [fuse_parts(p["fusion"], [v, f, valid, spatial])
                   for p, v, f in zip(params_list, vis_list, feats)]
    return fusions, gws


def _sent_fuse(params, graph_feat, nec, spatial, *, use_kernels: bool):
    """The sentence fusion of v6+ (CMPCv6_plus_model.py:417-433): a second
    mutan of the graph output with the sentence vector, then
    relu(conv1x1)."""
    feat = apply_mutan(params["sent_mutan"], nec, spatial, graph_feat,
                       use_kernels=use_kernels)
    return torch.relu(conv2d(params["fusion"], feat))


def fuse_parts(params, parts):
    """relu(conv1x1(concat(parts))) as the split sum of each part's
    product with its rows of the kernel (vis@Wv + graph@Wg + lang@Wl +
    spatial@Ws + bias for lang2vis), each accumulated and summed in f32,
    one cast to the first part's dtype at the end; parts broadcast over
    h, w (the [B,1,1,C] language vector)."""
    dt = parts[0].dtype
    w = params["DW"][0, 0].to(dt)
    y, row = None, 0
    for part in parts:
        n = part.shape[-1]
        t = matmul_f32(part.to(dt), w[row:row + n])
        y = t if y is None else y + t
        row += n
    return torch.relu(y + params["biases"].float()).to(dt)


# ---------------------------------------------------------------------------
# Gated exchange (TGFE) + ConvLSTM fusion
# ---------------------------------------------------------------------------

def _init_gv(key, cfg):
    """global_vec params (CMPC_model.py:212-243)."""
    k1, k2, k3 = split_stream(key, 3)
    return {
        "spa_graph_key": init_conv(k1, 1, cfg.mlp_dim, cfg.mlp_dim),
        "lang_query": init_conv(k2, 1, cfg.lang_dim, cfg.mlp_dim),
        "gv_lang": init_conv(k3, 1, cfg.mlp_dim + cfg.lang_dim, cfg.mlp_dim),
    }


def _apply_gv(p, cfg, feat, lang_feat):
    """Language-guided attention pooling to a global vector, l2-normalized
    over all of (1, 2, 3) like TF<=1.13's default-axis l2_normalize
    (CMPC_model.py:241)."""
    b, h, w, c = feat.shape
    key = conv2d(p["spa_graph_key"], feat).reshape(b, h * w, cfg.mlp_dim)
    query = conv2d(p["lang_query"], lang_feat).reshape(b, 1, cfg.mlp_dim)
    # f32 logits and an f32 pooled vector: widened (`matmul_f32`)
    attn = matmul_f32(key.float(),
                      query.to(key.dtype).float().transpose(1, 2)) \
        / math.sqrt(cfg.mlp_dim)
    attn = torch.softmax(attn, dim=1)                         # [B,HW,1] f32
    pooled = matmul_f32(attn.to(feat.dtype).float().transpose(1, 2),
                        feat.float().reshape(b, h * w, c))    # [B,1,C] f32
    gv = torch.cat([pooled.reshape(b, 1, 1, c), lang_feat.float()], dim=-1)
    gv = conv2d(p["gv_lang"], gv)
    return l2_normalize(gv, dim=(1, 2, 3))


def _init_se(key, cfg):
    """lang_se params (CMPC_model.py:194-210)."""
    k1, k2 = split_stream(key, 2)
    return {
        "lang_feat": init_conv(k1, 1, cfg.mlp_dim, cfg.mlp_dim),
        "trans_feat": init_conv(k2, 1, cfg.mlp_dim, cfg.mlp_dim),
    }


def _apply_se(p, feat, gv_lang):
    gate = torch.sigmoid(conv2d(p["lang_feat"], gv_lang))    # [B,1,1,C]
    trans = torch.relu(conv2d(p["trans_feat"], feat))
    return trans * gate.to(trans.dtype)


def init_exchange(key, cfg, num_others: int):
    """One gated_exchange_module's params: one se per other level and one
    gv on the target feat (CMPC_model.py:245-259), or, self-gated (v6,
    CMPCv6_model.py:323-339), a gv per other level, a gv and an se on the
    target feat."""
    ks = split_stream(key, 2 + 2 * num_others)
    p = {"se": [_init_se(ks[i], cfg) for i in range(num_others)]}
    if cfg.exchange_self_gate:
        p["gv_each"] = [_init_gv(ks[num_others + i], cfg)
                        for i in range(num_others)]
        p["gv_self"] = _init_gv(ks[-2], cfg)
        p["se_self"] = _init_se(ks[-1], cfg)
    else:
        p["gv"] = _init_gv(ks[-1], cfg)
    return p


def se_tables(pex, dtype):
    """The SE sum's weights [Cp, Cp] and biases [Cp] of each other level,
    in `dtype` and padded with zeros to Cp, C rounded up to the kernel's
    multiple of 4, as the kernel takes them (built once by
    model.prepare_params)."""
    cp = padded(pex["se"][0]["trans_feat"]["DW"].shape[-1],
                FUSION_COLUMN_MULTIPLE)
    return {"w": [pad_square(se["trans_feat"]["DW"][0, 0].to(dtype),
                             cp).contiguous() for se in pex["se"]],
            "b": [pad_cols(se["trans_feat"]["biases"].to(dtype), cp)
                  for se in pex["se"]]}


def se_sum(feat, others, gates, ws, bs, *, use_kernels: bool = True):
    """The SE sum (`kernels.se_sum_plain`) at the kernel's width: feat,
    others [B, N, C] and gates [B, C] padded with zero columns to Cp, C
    rounded up to a multiple of 4, the weights and biases padded likewise
    where they come at C (`se_tables` builds them at Cp); the output
    sliced back to C."""
    c = feat.shape[-1]
    cp = padded(c, FUSION_COLUMN_MULTIPLE)
    fn = kernels.se_sum if use_kernels else kernels.se_sum_plain
    out = fn(pad_cols(feat, cp), [pad_cols(o, cp) for o in others],
             [pad_cols(g, cp) for g in gates],
             [pad_square(w, cp) for w in ws], [pad_cols(b, cp) for b in bs])
    return out[..., :c]


def exchange_step_normed(pex, cfg, feat, others, lang_feat, *,
                         use_kernels: bool = True):
    """One gated-exchange module + the l2norm epilogue (standard layout):
    the gv and gates are [B,1,1,C]-small plain PyTorch; the SE sum and
    the row l2norm are one se_sum kernel launch (where autograd records,
    through `autograd.se_sum`).  The SE weights are `pex['se_tables']` when
    model.prepare_params built them.  The self-gated exchange keeps the
    module loop (`apply_exchange`) and its l2norm in plain PyTorch, as the
    JAX package leaves that layout to XLA: no SE-sum launch."""
    if cfg.exchange_self_gate:
        return l2_normalize(apply_exchange(pex, cfg, feat, others,
                                           lang_feat), -1)
    b, h, w, c = feat.shape
    dt = feat.dtype
    gv = _apply_gv(pex["gv"], cfg, feat, lang_feat)
    gates = [torch.sigmoid(conv2d(se["lang_feat"], gv)).reshape(b, -1).to(dt)
             for se in pex["se"]]
    rows = (feat.reshape(b, h * w, c),
            [o.reshape(b, h * w, c) for o in others], gates)
    if _differentiable(use_kernels):
        trans = [se["trans_feat"] for se in pex["se"]]
        out = autograd.se_sum(*rows, [t["DW"] for t in trans],
                              [t["biases"] for t in trans])
        return out.reshape(b, h, w, c)
    tables = pex.get("se_tables") or se_tables(pex, dt)
    return se_sum(*rows, tables["w"], tables["b"],
                  use_kernels=use_kernels).reshape(b, h, w, c)


def apply_exchange(p, cfg, feat, others, lang_feat):
    """The reference-shaped exchange module (without the l2norm): feat plus
    each other level's gated SE; self-gated, the target's own gated SE
    (its gv from feat) plus each other level's SE gated by that level's gv
    (no feat term)."""
    if cfg.exchange_self_gate:
        out = _apply_se(p["se_self"], feat,
                        _apply_gv(p["gv_self"], cfg, feat, lang_feat))
        for se, gv_p, other in zip(p["se"], p["gv_each"], others):
            out = out + _apply_se(se, other,
                                  _apply_gv(gv_p, cfg, other, lang_feat))
        return out
    gv = _apply_gv(p["gv"], cfg, feat, lang_feat)
    out = feat
    for se, other in zip(p["se"], others):
        out = out + _apply_se(se, other, gv)
    return out


def init_convlstm(key, cfg):
    c = cfg.mlp_dim
    h, w = cfg.vf_h, cfg.vf_w
    k1, k2, k3, k4 = split_stream(key, 4)
    return {
        "kernel": glorot_uniform(k1, (1, 1, 2 * c, 4 * c)),
        "W_ci": glorot_uniform(k2, (h, w, c)),
        "W_cf": glorot_uniform(k3, (h, w, c)),
        "W_co": glorot_uniform(k4, (h, w, c)),
        # 5 layer norms in call order: j, i, f, o, c (util/cell.py:52-66)
        "ln": [init_layer_norm(c) for _ in range(5)],
    }


def convlstm_tables(p, dtype):
    """The ConvLSTM weights as its kernels take them (built once by
    model.prepare_params), padded with zeros to Cp, C rounded up to the
    kernels' multiple of 4: the 1x1 kernel `w` [2Cp, 4Cp] (each input half
    and each gate block padded) and the peepholes `ci`, `cf`, `co` [N, Cp]
    in `dtype`, and the 5 layer norms' `gamma` and `beta` [5, Cp] in f32,
    in the order j, i, f, o, c."""
    c = p["W_ci"].shape[-1]
    cp = padded(c, FUSION_COLUMN_MULTIPLE)
    peep = {k: pad_cols(p[f"W_{k}"].reshape(-1, c).to(dtype), cp)
            .contiguous() for k in ("ci", "cf", "co")}
    w = p["kernel"][0, 0].to(dtype)
    if cp != c:
        w = F.pad(w.reshape(2, c, 4, c), (0, cp - c, 0, 0, 0, cp - c)
                  ).reshape(2 * cp, 4 * cp)
    return {"w": w.contiguous(), **peep,
            **{k: pad_cols(_stack((ln[k] for ln in p["ln"]), torch.float32),
                           cp).contiguous()
               for k in ("gamma", "beta")}}


def convlstm_step_fused(p, x, c, h, *, use_kernels: bool = True):
    """One ConvLSTM step (util/cell.py:36-79): 1x1 kernel, gate order
    (j, i, f, o), peepholes on i/f from the old cell and on o from the new
    one, whole-sample layer norms of j/i/f/o/c, forget bias 1.0, no conv
    bias.  It runs as the convlstm_gates and convlstm_raw kernels and
    a plain-PyTorch finalize (new_c = LN_c(new_c_raw), new_h =
    sigmoid(LN_o(o_raw)) * tanh(new_c)), as the JAX package's
    convlstm_step_fused finalizes in XLA.  The layer norms take their
    statistics as (sum, sum of squares) from the kernels.  The weights are
    `p['tables']` when model.prepare_params built them.  x, c and h run
    padded to the tables' width, the layer norms counting C columns, and
    the new state comes back at C.  Where autograd records, the step runs
    through `autograd.convlstm_step`."""
    if _differentiable(use_kernels):
        return autograd.convlstm_step(p, x, c, h)
    b, hh, ww, cc = x.shape
    n = hh * ww
    t = p.get("tables") or convlstm_tables(p, x.dtype)
    gamma, beta = t["gamma"], t["beta"]
    if use_kernels:
        gates_fn, raw_fn = kernels.convlstm_gates, kernels.convlstm_raw
    else:
        gates_fn = kernels.convlstm_gates_plain
        raw_fn = kernels.convlstm_raw_plain
    x2, h2, c2 = (pad_cols(v.reshape(b, n, cc), gamma.shape[-1])
                  for v in (x, h, c))
    gates, stats = gates_fn(x2, h2, c2, t["w"], t["ci"], t["cf"])
    new_c_raw, o_raw, stats2 = raw_fn(gates, c2, t["co"], stats, gamma, beta,
                                      width=cc)
    new_c = kernels.ln_from_stats(new_c_raw, stats2[:, :, 0], gamma[4],
                                  beta[4], cc)[..., :cc].to(x.dtype)
    o = torch.sigmoid(kernels.ln_from_stats(o_raw, stats2[:, :, 1], gamma[3],
                                            beta[3], cc)[..., :cc]
                      ).to(x.dtype)
    new_h = o * torch.tanh(new_c)
    return new_c.reshape(b, hh, ww, cc), new_h.reshape(b, hh, ww, cc)


# --- ConvGRU cell (util/cell.py:82-143), an alternative recurrent fuser ----
# that no config calls; plain PyTorch, as the JAX package runs it in XLA

def init_convgru(key, cfg):
    """The ConvGRU's parameters, a numpy tree in the JAX package's layout:
    the 1x1 gates kernel [1, 1, 2C, 2C] (r then u), the candidate's
    [1, 1, 2C, C], and the layer norms of r, u and the candidate, C =
    mlp_dim."""
    c = cfg.mlp_dim
    k1, k2 = split_stream(key, 2)
    return {
        "gates_kernel": glorot_uniform(k1, (1, 1, 2 * c, 2 * c)),
        "cand_kernel": glorot_uniform(k2, (1, 1, 2 * c, c)),
        "ln": [init_layer_norm(c) for _ in range(3)],
    }


def convgru_step(p, x, h):
    """One ConvGRU step (util/cell.py:110-143, normalize=True): the gates
    conv of [x, h], split into r and u, each whole-sample layer-normed
    and through a sigmoid; the candidate conv of [x, r * h], layer-normed,
    through tanh; h' = u * h + (1 - u) * candidate.  x, h [B, H, W, C];
    the 1x1 convs are channel matmuls with f32 sums, their outputs in x's
    dtype."""
    dt = x.dtype
    z = torch.cat([x, h], dim=-1)
    y = matmul_f32(z, p["gates_kernel"][0, 0].to(dt)).to(dt)
    r, u = torch.chunk(y, 2, dim=-1)
    ln = p["ln"]
    r = torch.sigmoid(tf1_layer_norm(r, ln[0]["gamma"], ln[0]["beta"]))
    u = torch.sigmoid(tf1_layer_norm(u, ln[1]["gamma"], ln[1]["beta"]))
    z2 = torch.cat([x, r * h], dim=-1)
    cand = matmul_f32(z2, p["cand_kernel"][0, 0].to(dt)).to(dt)
    cand = torch.tanh(tf1_layer_norm(cand, ln[2]["gamma"], ln[2]["beta"]))
    return u * h + (1 - u) * cand


def init_fusion_stack(key, cfg):
    """Two rounds of gated exchange over the levels + ConvLSTM fusion
    (CMPC_model.py:261-293)."""
    levels = cfg.levels
    keys = split_stream(key, 2 * len(levels) + 1)
    p = {"exchange": {}}
    idx = 0
    for rnd in ("", "_2"):
        for lv in levels:
            p["exchange"][f"{lv}{rnd}"] = init_exchange(keys[idx], cfg,
                                                        len(levels) - 1)
            idx += 1
    p["convlstm"] = init_convlstm(keys[-1], cfg)
    return p


def apply_fusion_stack(p, cfg, feats: dict, lang_feat, *,
                       use_kernels: bool = True):
    """feats: {level: [B,H,W,mlp]} -> fused [B,H,W,mlp].  The ConvLSTM scans
    the levels low to high (CMPC_model.py:288-289) and returns the last
    hidden state."""
    levels = list(cfg.levels)
    cur = dict(feats)
    for rnd in ("", "_2"):
        cur = {lv: exchange_step_normed(p["exchange"][f"{lv}{rnd}"], cfg,
                                        cur[lv],
                                        [cur[o] for o in levels if o != lv],
                                        lang_feat, use_kernels=use_kernels)
               for lv in levels}
    c = torch.zeros_like(cur[levels[0]])
    h = torch.zeros_like(c)
    for lv in levels:
        c, h = convlstm_step_fused(p["convlstm"], cur[lv], c, h,
                                   use_kernels=use_kernels)
    return h
