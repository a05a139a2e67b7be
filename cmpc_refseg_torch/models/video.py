"""CMPC video model (A2D / referring video segmentation), the port of the
JAX package's models/video.py.

Reference: CMPC_video/CMPC_video_mm_tgraph_allvec.py —
- a 16-frame clip subsampled to 5 frames [0, 4, 8, 12, 15], folded into
  the batch for the shared backbone (:69-78);
- the 5-way word parse {Entity, Attribute, Static-Relation, Action,
  Unnecessary} (:404-412);
- per level: mutan fusion on ALL frames (:330-366), the temporal graph
  over frame vectors pooled by action-language attention (:458-503), the
  temporal context (the center frame's pixels attend over the frame
  vectors, :505-530), the spatial graph on the center frame (:431-456);
- the fusion concat [center_vis, spa_graph, temp_ctx, valid_lang,
  spatial] (:396-401), then the image model's 2x gated exchange +
  ConvLSTM stack and score heads.

The mutan, the spatial graph and the fusion stack run the port's kernels
(``models/cmpc.py``).  The mutan takes each clip as one sample of F·h·w
rows: the clip's frames are adjacent in the B·F order and share its
language vector, so that is the same function as B·F samples of h·w rows
with the language broadcast per frame, and moves fewer bytes.  The
spatial graph runs on the center frame, level-packed or level by level by
`cmpc.pack_levels`.  The temporal graph and context (einsums, softmaxes
and 1x1 convs that the JAX package leaves to XLA) are plain PyTorch: the
attention logits and softmaxes in float32 (docs/DESIGN.md §2), their
products accumulated in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cmpc_refseg_torch.config import ModelConfig
from cmpc_refseg_torch.models import cmpc
from cmpc_refseg_torch.models.backbone import apply_backbone, init_backbone
from cmpc_refseg_torch.models.language import encode_text, init_text_encoder
from cmpc_refseg_torch.models.model import LATERAL_IN_DIM, ModelOutputs
from cmpc_refseg_torch.ops.kernels import matmul_f32
from cmpc_refseg_torch.ops.layers import (conv2d, init_conv, init_layer_norm,
                                          split_stream)
from cmpc_refseg_torch.ops.normalization import l2_normalize, tf1_layer_norm
from cmpc_refseg_torch.ops.resize import resize_bilinear
from cmpc_refseg_torch.ops.spatial import spatial_coordinate_grid
from cmpc_refseg_torch.utils.profiling import span


def _init_gconv(key, dim):
    return {"update": init_conv(key, 1, dim, dim),
            "feat_ln": init_layer_norm(dim),
            "update_ln": init_layer_norm(dim)}


def init_video_level(key, cfg: ModelConfig) -> dict:
    """One level's numpy params, draw for draw the JAX package's."""
    ks = split_stream(key, 12)
    c = cfg.v_emb_dim
    return {
        "mutan": cmpc.init_mutan(ks[0], cfg),
        # temporal graph (tg_*)
        "tg_vtrans": init_conv(ks[1], 1, c, c),
        "tg_ltrans": init_conv(ks[2], 1, cfg.lang_dim, cfg.lang_dim),
        "tg_query": init_conv(ks[3], 1, c, c),
        "tg_key": init_conv(ks[4], 1, c, c),
        "tg_gconv": _init_gconv(ks[5], c),
        # temporal context
        "mm_trans": init_conv(ks[6], 1, c, c),
        "ctx_trans": init_conv(ks[7], 1, c, c),
        # spatial graph on the center frame
        "graph": cmpc.init_spa_graph(ks[8], cfg),
        # fusion conv: [vis, sgraph, ctx, lang, spatial]
        "fusion": init_conv(ks[9], 1, 3 * c + cfg.lang_dim + cfg.spatial_dim,
                            cfg.mlp_dim),
    }


def init_numpy(seed, cfg: ModelConfig, glove=None) -> dict:
    """The video parameter tree as numpy arrays in the JAX package's
    layout, draw for draw what its init_video_model makes from the same
    seed (`glove` [vocab_size, glove_dim] is the embedding's initial
    value)."""
    keys = split_stream(seed, 8)
    params = {
        "backbone": init_backbone(keys[0], cfg.res4_blocks),
        "text": init_text_encoder(keys[1], cfg, glove),
        "parser": cmpc.init_lang_parser(keys[2], cfg),
        "levels": {}, "laterals": {}, "scores": {},
        "fusion_stack": cmpc.init_fusion_stack(keys[3], cfg),
    }
    lkeys = keys[4].split(3 * len(cfg.levels))
    for i, lv in enumerate(cfg.levels):
        params["laterals"][lv] = init_conv(lkeys[3 * i], 1,
                                           LATERAL_IN_DIM[lv], cfg.v_emb_dim)
        params["levels"][lv] = init_video_level(lkeys[3 * i + 1], cfg)
        params["scores"][f"score_{lv}"] = init_conv(lkeys[3 * i + 2], 3,
                                                    cfg.mlp_dim, 1)
    params["scores"]["score"] = init_conv(keys[5], 3, cfg.mlp_dim, 1)
    return params


def _gconv_dense(gp, x_nodes, adj):
    """The graph convolution with an explicit (small) adjacency [B, N, N]
    (CMPC_video...py:418-429): x_nodes [B, N, C] in the compute dtype, adj
    f32; the message accumulated in f32, the layer norms' statistics f32."""
    dt = x_nodes.dtype
    msg = matmul_f32(adj, x_nodes).to(dt)
    msg = tf1_layer_norm(msg[:, None], gp["feat_ln"]["gamma"],
                         gp["feat_ln"]["beta"])[:, 0]
    y = torch.relu(x_nodes + msg)
    y = conv2d(gp["update"], y[:, None])[:, 0]
    y = tf1_layer_norm(y[:, None], gp["update_ln"]["gamma"],
                       gp["update_ln"]["beta"])[:, 0]
    return torch.relu(y)


def _temp_graph(p, mm_feat_bf, ac_lang, b: int, f: int):
    """The temporal graph (reference :458-503): action-language attention
    pools each frame to a vector, a frame-frame adjacency, the graph conv.
    mm_feat_bf [B*F, h, w, C]; ac_lang [B, 1, 1, Cl] -> [B, F, C] in the
    compute dtype."""
    dt = mm_feat_bf.dtype
    h, w, c = mm_feat_bf.shape[1:]
    vis_trans = conv2d(p["tg_vtrans"], mm_feat_bf).reshape(b, f * h * w, c)
    lang_trans = conv2d(p["tg_ltrans"], ac_lang).reshape(b, -1, 1)
    # one language vector per clip, the same for its F frames
    # the attention logits here and below are f32: widened (`matmul_f32`)
    attn = matmul_f32(vis_trans.float(), lang_trans.float()).reshape(
        b * f, 1, h * w)
    attn = torch.softmax(attn / math.sqrt(c), dim=2)          # [BF,1,HW] f32
    frame_vec = matmul_f32(attn, mm_feat_bf.reshape(b * f, h * w, c))
    frame_vec = frame_vec.to(dt).reshape(b, 1, f, c)
    q = conv2d(p["tg_query"], frame_vec).reshape(b, f, c)
    k = conv2d(p["tg_key"], frame_vec).reshape(b, f, c)
    adj = torch.softmax(matmul_f32(q.float(), k.float().transpose(1, 2))
                        / math.sqrt(c), dim=2)                 # [B,F,F] f32
    out = _gconv_dense(p["tg_gconv"], frame_vec.reshape(b, f, c), adj)
    return l2_normalize(out, -1)


def _temp_ctx(p, center_mm, frame_vecs):
    """The temporal context (reference :505-530): the center frame's
    pixels attend over the F frame vectors.  center_mm [B, h, w, C];
    frame_vecs [B, F, C] -> [B, h, w, C] in the compute dtype."""
    b, h, w, c = center_mm.shape
    mm_trans = conv2d(p["mm_trans"], center_mm).reshape(b, h * w, c)
    ctx_trans = conv2d(p["ctx_trans"], frame_vecs[:, None]).reshape(b, -1, c)
    # f32 logits: widened (`matmul_f32`)
    attn = torch.softmax(matmul_f32(mm_trans.float(),
                                    ctx_trans.float().transpose(1, 2))
                         / math.sqrt(c), dim=2)                # [B,HW,F] f32
    ctx = matmul_f32(attn, frame_vecs)
    return l2_normalize(ctx.reshape(b, h, w, c), -1).to(center_mm.dtype)


def sampled_frames(batch: dict, cfg: ModelConfig):
    """The clip's sampled frames [B, F, H, W, 3]: batch['frames'] as it is,
    or cfg.sampled_frames of batch['clip'] [B, num_frames, H, W, 3]."""
    if "frames" in batch:
        return batch["frames"]
    if "clip" not in batch:
        raise ValueError("a video batch holds 'clip' [B, num_frames, H, W, "
                         "3] or 'frames' [B, F, H, W, 3]")
    idx = torch.as_tensor(cfg.sampled_frames, device=batch["clip"].device)
    return batch["clip"].index_select(1, idx)


def apply_video_model(params, cfg: ModelConfig, batch: dict, *,
                      model_state: Optional[dict] = None, train: bool = False,
                      use_kernels: bool = True) -> ModelOutputs:
    """Forward of the video model.  batch: 'clip' [B, num_frames, H, W, 3]
    float32 BGR - mean (or 'frames', its cfg.sampled_frames already
    gathered, `sampled_frames`), 'words' [B, T] with 'seq_len' [B]
    (back-padded) or 'valid_idx' [B] (front-padded).  The ground truth is
    the center sampled frame's (reference :69-78, index F // 2).

    The model has no state: `model_state` and `train` change nothing
    (outputs.model_state is {}).  `use_kernels` as in
    ``models.model.apply_model``: False runs the kernels' plain versions;
    where autograd records, the head's kernels run through
    ``ops/autograd.py``."""
    if not cfg.video:
        raise ValueError(f"{cfg.variant or 'this config'} is not the video "
                         "model: use models.model.apply_model")
    route = dict(use_kernels=use_kernels)
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    with span("cmpc.backbone"):
        frames = sampled_frames(batch, cfg)
        b, f = frames.shape[:2]
        frames_bf = frames.reshape(b * f, cfg.H, cfg.W, 3)
        vis = apply_backbone(params["backbone"], frames_bf, compute_dtype=dt,
                             taps=tuple(cfg.levels),
                             res4_blocks=cfg.res4_blocks)
        if dt is not None:
            vis = {k: v.to(dt) for k, v in vis.items()}

    with span("cmpc.text"):
        text = encode_text(params["text"], cfg, batch.get("words"),
                           batch.get("seq_len"),
                           valid_idx=batch.get("valid_idx"))
        # the JAX package also computes a max-pooled sentence feature
        # (reference :143-145) that nothing reads; it is left out
        words_parse = cmpc.apply_lang_parser(params["parser"],
                                             text.parse_feat, text.seq_mask)
        ea = cmpc.valid_lang_feat(words_parse, text.words_feat, (0, 1))
        ac = cmpc.valid_lang_feat(words_parse, text.words_feat, (3,))
        valid = cmpc.valid_lang_feat(words_parse, text.words_feat,
                                     (0, 1, 2, 3))

    with span("cmpc.head"):
        h, w = cfg.vf_h, cfg.vf_w
        grid = spatial_coordinate_grid(h, w, device=frames.device)
        spatial = grid[None].expand(b, h, w, 8)
        # the clip as one mutan sample of F*h rows: the grid once per frame
        spatial_clip = grid.repeat(f, 1, 1)[None].expand(b, f * h, w, 8)
        center = f // 2
        centers, center_mms, ctxs = [], [], []
        for lv in cfg.levels:
            p = params["levels"][lv]
            lat = l2_normalize(conv2d(params["laterals"][lv], vis[lv]), -1)
            c = lat.shape[-1]
            mm = cmpc.apply_mutan(p["mutan"], ea, spatial_clip,
                                  lat.reshape(b, f * h, w, c), **route)
            mm_bf = mm.reshape(b * f, h, w, c)
            frame_vecs = _temp_graph(p, mm_bf, ac, b, f)
            center_mm = mm_bf.reshape(b, f, h, w, c)[:, center].contiguous()
            centers.append(lat.reshape(b, f, h, w, c)[:, center])
            center_mms.append(center_mm)
            ctxs.append(_temp_ctx(p, center_mm, frame_vecs))

        sgraphs, gw_list = cmpc.apply_spa_graph_levels(
            [params["levels"][lv]["graph"] for lv in cfg.levels], cfg,
            center_mms, text.words_feat, words_parse, text.seq_mask,
            graph_stack=params.get("graph_stack"), **route)

        fusions, up_levels, gw = {}, {}, {}
        for lv, center_vis, sgraph, ctx, gw_lv in zip(
                cfg.levels, centers, sgraphs, ctxs, gw_list):
            gw[lv] = gw_lv
            fusions[lv] = cmpc.fuse_parts(params["levels"][lv]["fusion"],
                                          [center_vis, sgraph, ctx, valid,
                                           spatial])
            score_lv = conv2d(params["scores"][f"score_{lv}"],
                              fusions[lv].float())
            up_levels[lv] = resize_bilinear(score_lv, cfg.H, cfg.W)

    with span("cmpc.fusion"):
        fused = cmpc.apply_fusion_stack(params["fusion_stack"], cfg, fusions,
                                        valid, **route)
    with span("cmpc.decode"):
        pred = conv2d(params["scores"]["score"], fused.float())
        up = resize_bilinear(pred, cfg.H, cfg.W)
        sigm = torch.sigmoid(up)
    return ModelOutputs(pred, up, sigm, up_levels, words_parse, gw, {})
