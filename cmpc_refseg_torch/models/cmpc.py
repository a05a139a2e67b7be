"""CMPC head: language parser, mutan fusion, relation-aware spatial graph,
gated multi-level exchange and ConvLSTM fusion (CMPC_model.py:144-410).

The port of the JAX package's models/cmpc.py for the flagship configuration.
Mutan, the spatial-graph affinity and the graph convolution run through the
hand-written kernels of ``ops/kernels.py`` (their plain versions when the
tensors lie on the CPU, or everywhere with ``use_kernels=False``).  The
exchange (SE-sum) and ConvLSTM run as plain PyTorch.  The spatial graph
runs level by level at every batch; the level-packed form is not ported.

The JAX package's plain references `_mutan_reference` and
`_spa_affinity_xla` are ``kernels.mutan_plain`` and
``kernels.spa_affinity_plain`` here, beside their kernels; `_graph_conv`
stays below as the graph kernels' plain route.

The [HW, HW] adjacency is never materialized: ``adj @ X = W @ (V^T @ X)``.
Init functions return numpy trees in the JAX package's layout (HWIO
kernels); ``convert.params_from_jax`` turns them into tensors.
"""

from __future__ import annotations

import math

import torch

from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_torch.ops.layers import (conv2d, glorot_uniform, init_conv,
                                          init_layer_norm, split_stream)
from cmpc_refseg_torch.ops.normalization import l2_normalize, tf1_layer_norm


def _matmul_f32(a, b):
    """a @ b with f32 accumulation and an f32 result, whatever the inputs'
    dtype (the JAX package's ``preferred_element_type=float32``).  On CUDA
    a bf16 product with a 2-D right operand goes to cuBLAS as it is, with
    an f32 output; elsewhere the operands are widened first (the same exact
    products and f32 sums)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


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


def apply_mutan(params, lang_feat, spatial_feat, visual_feat,
                num_heads: int = 5, *, use_kernels: bool = True):
    """sum_h tanh(conv_h([vis, spatial])) * tanh(conv_h(lang)), tanh, l2norm
    (CMPC_model.py:311-328), as one mutan kernel launch.  The visual weight
    in the compute dtype is `params['w_wide']` when model.prepare_params
    built it, else cast here."""
    b, h, w, c = visual_feat.shape
    dt = visual_feat.dtype
    vis_in = torch.cat([visual_feat, spatial_feat.to(dt)], dim=-1)
    lang = torch.tanh(conv2d(params["lang_trans"], lang_feat))  # [B,1,1,5C]
    w_wide = params.get("w_wide")
    if w_wide is None:
        w_wide = params["vis_trans"]["DW"][0, 0].to(dt)
    fn = kernels.mutan_fused if use_kernels else kernels.mutan_plain
    out = fn(vis_in.reshape(b * h * w, vis_in.shape[-1]), w_wide,
             params["vis_trans"]["biases"].float(),
             lang.reshape(b, -1).float(), heads=num_heads,
             rows_per_sample=h * w)
    return out.reshape(b, h, w, c)


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
    pooled = _matmul_f32(v_aff.transpose(1, 2), x_nodes).to(dt)   # [B,T,C]
    msg = _matmul_f32(w_aff, pooled).to(dt)
    msg = tf1_layer_norm(msg[:, None], gp["feat_ln"]["gamma"],
                         gp["feat_ln"]["beta"])[:, 0]
    y = torch.relu(x_nodes + msg)
    y = conv2d(gp["update"], y[:, None])[:, 0]
    y = tf1_layer_norm(y[:, None], gp["update_ln"]["gamma"],
                       gp["update_ln"]["beta"])[:, 0]
    return torch.relu(y)


def graph_conv(gp, x_nodes, w_aff, v_aff):
    """The same graph convolution through the graph_msg and graph_update
    kernels: pooled = v_aff^T @ x and the final relu(LN2(z)) are plain
    PyTorch, as the JAX package leaves them to XLA."""
    dt = x_nodes.dtype
    pooled = torch.matmul(v_aff.to(dt).transpose(1, 2), x_nodes)  # [B,T,C]
    msg, stats1 = kernels.graph_msg(w_aff.to(dt).contiguous(), pooled)
    z, stats2 = kernels.graph_update(
        x_nodes, msg, stats1, gp["update"]["DW"][0, 0].to(dt).contiguous(),
        gp["update"]["biases"].to(dt), gp["feat_ln"]["gamma"].float(),
        gp["feat_ln"]["beta"].float())
    out = kernels.ln_from_stats(z, stats2, gp["update_ln"]["gamma"],
                                gp["update_ln"]["beta"])
    return torch.relu(out).to(dt)


def apply_spa_graph(params, cfg, spa_graph, words_feat, words_parse, seq_mask,
                    *, use_kernels: bool = True):
    """Spatial graph reasoning (CMPC_model.py:376-410) for the graph norms
    'masked', 'unmasked' and 'softmax_mask'.

    spa_graph [B,H,W,C]; words_feat [B,1,T,Cl]; seq_mask [B,1,T,1].
    Returns (out [B,H,W,C], (w_aff, v_aff))."""
    if cfg.graph_norm not in ("masked", "unmasked", "softmax_mask"):
        raise NotImplementedError(f"graph_norm {cfg.graph_norm!r} is not "
                                  "ported yet")
    b, h, w, c = spa_graph.shape
    dt = spa_graph.dtype
    words_trans = conv2d(params["words_trans"], words_feat)[:, 0]   # [B,T,A]
    if cfg.l2norm_affinity:
        words_trans = l2_normalize(words_trans, -1)
    nodes = spa_graph.reshape(b, h * w, c)
    proj = params["spa_graph_trans2"]
    fn = kernels.spa_affinity if use_kernels else kernels.spa_affinity_plain
    w_aff, v_aff = fn(
        nodes, proj["DW"][0, 0].to(dt).contiguous(), proj["biases"].to(dt),
        words_trans.to(dt).contiguous(),
        words_parse[:, :, :, 2].float().contiguous(),
        seq_mask[:, :, :, 0].float().contiguous(),
        scale=math.sqrt(cfg.v_emb_dim), l2n=bool(cfg.l2norm_affinity),
        masked=cfg.graph_norm in ("masked", "unmasked"))

    x = nodes
    for gp in params["gconv"]:
        x = graph_conv(gp, x, w_aff, v_aff) if use_kernels \
            else _graph_conv(gp, x, w_aff, v_aff)
    return l2_normalize(x.reshape(b, h, w, c), -1), (w_aff, v_aff)


# ---------------------------------------------------------------------------
# lang2vis assembly
# ---------------------------------------------------------------------------

def init_lang2vis(key, cfg):
    k1, k2, _, k4 = split_stream(key, 4)
    if cfg.sent_fusion:
        raise NotImplementedError("sent_fusion is not ported yet")
    fin = cfg.v_emb_dim * 2 + cfg.lang_dim + cfg.spatial_dim
    return {
        "mutan": init_mutan(k1, cfg),
        "graph": init_spa_graph(k2, cfg),
        "fusion": init_conv(k4, 1, fin, cfg.mlp_dim),
    }


def apply_lang2vis_multi(params_list, cfg, visuals, words_feat, words_parse,
                         seq_mask, spatial, *, use_kernels: bool = True):
    """Per-level cross-modal comprehension (CMPC_model.py:330-345) for all
    levels, level by level.  Returns (list of fusions, list of gw)."""
    valid = valid_lang_feat(words_parse, words_feat, (0, 1))  # E+A
    fusions, gws = [], []
    for p, v in zip(params_list, visuals):
        vis_la_sp = apply_mutan(p["mutan"], valid, spatial, v,
                                use_kernels=use_kernels)
        graph_feat, gw = apply_spa_graph(p["graph"], cfg, vis_la_sp,
                                         words_feat, words_parse, seq_mask,
                                         use_kernels=use_kernels)
        fusions.append(_lang2vis_fuse(p, vis_la_sp, graph_feat, valid,
                                      spatial))
        gws.append(gw)
    return fusions, gws


def _lang2vis_fuse(params, vis_la_sp, graph_feat, valid, spatial):
    """relu(conv1x1(concat([vis, graph, tiled lang, spatial]))) computed as
    the split sum vis@Wv + graph@Wg + lang@Wl + spatial@Ws + bias, each
    term accumulated and summed in f32, one cast at the end."""
    dt = vis_la_sp.dtype
    c = vis_la_sp.shape[-1]
    cl = valid.shape[-1]
    w = params["fusion"]["DW"][0, 0].to(dt)               # [2C+Cl+S, mlp]
    y = (_matmul_f32(vis_la_sp, w[:c]) + _matmul_f32(graph_feat, w[c:2 * c])
         + _matmul_f32(valid.to(dt), w[2 * c:2 * c + cl])
         + _matmul_f32(spatial.to(dt), w[2 * c + cl:])
         + params["fusion"]["biases"].float())
    return torch.relu(y).to(dt)


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
    attn = _matmul_f32(key, query.to(key.dtype).transpose(1, 2)) \
        / math.sqrt(cfg.mlp_dim)
    attn = torch.softmax(attn, dim=1)                         # [B,HW,1] f32
    pooled = _matmul_f32(attn.to(feat.dtype).transpose(1, 2),
                         feat.reshape(b, h * w, c))           # [B,1,C] f32
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
    """One gated_exchange_module's params: one gv on the target feat + one
    se per other level (CMPC_model.py:245-259)."""
    if cfg.exchange_self_gate:
        raise NotImplementedError("the self-gate exchange is not ported yet")
    ks = split_stream(key, 2 + 2 * num_others)
    return {"se": [_init_se(ks[i], cfg) for i in range(num_others)],
            "gv": _init_gv(ks[-1], cfg)}


def _se_sum_xla(feat, others, gates, ws, bs):
    """feat [B,N,C] + sum_i relu(others_i @ ws_i + bs_i) * gates_i, then a
    row l2norm (the exchange epilogue at CMPC_model.py:245-259)."""
    dt = feat.dtype
    out = feat
    for o, g, w, b in zip(others, gates, ws, bs):
        t = torch.relu(torch.matmul(o.to(dt), w.to(dt)) + b.to(dt))
        out = out + t * g.to(dt)[:, None, :]
    return l2_normalize(out, -1)


def exchange_step_normed(pex, cfg, feat, others, lang_feat):
    """One gated-exchange module + the l2norm epilogue (standard layout)."""
    b, h, w, c = feat.shape
    gv = _apply_gv(pex["gv"], cfg, feat, lang_feat)
    gates = [torch.sigmoid(conv2d(se["lang_feat"], gv)).reshape(b, -1)
             for se in pex["se"]]
    ws = [se["trans_feat"]["DW"][0, 0] for se in pex["se"]]
    bs = [se["trans_feat"]["biases"] for se in pex["se"]]
    out = _se_sum_xla(feat.reshape(b, h * w, c),
                      [o.reshape(b, h * w, c) for o in others], gates, ws, bs)
    return out.reshape(b, h, w, c)


def apply_exchange(p, cfg, feat, others, lang_feat):
    """The reference-shaped exchange module (without the l2norm)."""
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


def convlstm_step(p, x, c, h):
    """One ConvLSTM step (util/cell.py:36-79).  1x1 kernel => channel matmul
    over [x, h].  Gate split order (j, i, f, o); peepholes on i/f use the
    old cell and on o the new cell; j/i/f/o/c are whole-sample layer
    normalized; forget bias 1.0; no conv bias."""
    dt = x.dtype
    y = torch.matmul(torch.cat([x, h], dim=-1), p["kernel"][0, 0].to(dt))
    j, i, f, o = torch.split(y, y.shape[-1] // 4, dim=-1)
    i = i + p["W_ci"].to(dt) * c
    f = f + p["W_cf"].to(dt) * c
    ln = p["ln"]
    j = tf1_layer_norm(j, ln[0]["gamma"], ln[0]["beta"])
    i = tf1_layer_norm(i, ln[1]["gamma"], ln[1]["beta"])
    f = tf1_layer_norm(f, ln[2]["gamma"], ln[2]["beta"])
    f = torch.sigmoid(f + 1.0)
    i = torch.sigmoid(i)
    new_c = c * f + i * torch.tanh(j)
    o = o + p["W_co"].to(dt) * new_c
    o = tf1_layer_norm(o, ln[3]["gamma"], ln[3]["beta"])
    new_c = tf1_layer_norm(new_c, ln[4]["gamma"], ln[4]["beta"])
    o = torch.sigmoid(o)
    return new_c, o * torch.tanh(new_c)


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


def apply_fusion_stack(p, cfg, feats: dict, lang_feat):
    """feats: {level: [B,H,W,mlp]} -> fused [B,H,W,mlp].  The ConvLSTM scans
    the levels low to high (CMPC_model.py:288-289) and returns the last
    hidden state."""
    levels = list(cfg.levels)
    cur = dict(feats)
    for rnd in ("", "_2"):
        cur = {lv: exchange_step_normed(p["exchange"][f"{lv}{rnd}"], cfg,
                                        cur[lv],
                                        [cur[o] for o in levels if o != lv],
                                        lang_feat)
               for lv in levels}
    c = torch.zeros_like(cur[levels[0]])
    h = torch.zeros_like(c)
    for lv in levels:
        c, h = convlstm_step(p["convlstm"], cur[lv], c, h)
    return h
