"""CMPC model assembly: the flagship's multiscore decoder and the ASPP +
DeepLabv3+ decoder of the v4-v6 configs.

Forward pipeline (CMPC_model.py:89-142 and the variants' deltas):
backbone taps -> text encoder -> laterals (+tanh, l2norm) -> spatial grid
(+HSV) ->
language parser -> per-level lang2vis (mutan + spatial graph) -> aux score
heads -> nec_lang -> 2x gated exchange + ConvLSTM fusion -> decoder
(multiscore 3x3 score conv, or ASPP + v3+ decoder on the c2 tap) -> TF1
resize -> sigmoid; with `bbox_head` (CMPCv5_plus_model), the detection
head on the fused feature (``models/detection.py``).

The ASPP and the decoder hold live BatchNorm: their moving statistics are
the model state (`init_model_state`), passed to `apply_model` and returned
on its outputs, updated in train mode (``models/aspp.py``).  The
multiscore configs' state is {}.

Precision (docs/DESIGN.md §2): with compute_dtype 'bfloat16' the backbone
and the head run their products in bf16; norm statistics (BN's too),
softmaxes, the score convs, logits and the sigmoid stay in float32.

Losses follow train_op (CMPC_model.py:426-492): `compute_loss`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cmpc_refseg_torch.config import ModelConfig
from cmpc_refseg_torch.convert import model_state_from_jax, params_from_jax
from cmpc_refseg_torch.data.anchors import DEFAULT_ANCHORS
from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR
from cmpc_refseg_torch.models import aspp, cmpc, detection
from cmpc_refseg_torch.models.backbone import (TRAINABLE_STAGES,
                                               apply_backbone, gemm_weight,
                                               init_backbone)
from cmpc_refseg_torch.models.backbone import \
    quantize_backbone as _quantize_backbone
from cmpc_refseg_torch.models.language import encode_text, init_text_encoder
from cmpc_refseg_torch.ops import losses
from cmpc_refseg_torch.ops.layers import conv2d, init_conv, split_stream
from cmpc_refseg_torch.ops.normalization import l2_normalize
from cmpc_refseg_torch.ops.resize import resize_bilinear
from cmpc_refseg_torch.ops.spatial import spatial_coordinate_grid
from cmpc_refseg_torch.utils.profiling import span

LATERAL_IN_DIM = {"c3": 512, "c4": 1024, "c5": 2048}


class ModelOutputs(NamedTuple):
    pred: torch.Tensor                # low-res logits [B,h,w,1]
    up: torch.Tensor                  # full-res logits [B,H,W,1]
    sigm: torch.Tensor                # sigmoid(up)
    up_levels: dict                   # {level: [B,H,W,1]} aux logits
    words_parse: torch.Tensor         # [B,1,T,K]
    gw: dict                          # {level: (w_aff, v_aff)} graph attn
    # BN moving statistics after the forward: the new ones in train mode,
    # the given ones in eval mode ({} for the multiscore decoder)
    model_state: dict
    # the detection head's (raw, decoded) [B,S,S,A,5] (bbox_head), or None
    bbox: Optional[tuple] = None


DECODERS = ("multiscore", "aspp_v3plus")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.decoder not in DECODERS:
        raise ValueError(f"unknown decoder {cfg.decoder!r}")


def rgb_to_hsv(rgb):
    """`tf.image.rgb_to_hsv` on any value range (H and S in [0, 1], V the
    largest channel as it is), the HSV variants' conversion
    (CMPCv5_HSV_model.py:118-126).  Ties take red, then green, then blue;
    a gray pixel has hue 0 and a black one saturation 0."""
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    rng = mx - torch.minimum(torch.minimum(r, g), b)
    safe_rng = torch.where(rng == 0, torch.ones_like(rng), rng)
    h_r = torch.remainder((g - b) / safe_rng, 6.0)
    h_g = (b - r) / safe_rng + 2.0
    h_b = (r - g) / safe_rng + 4.0
    h = torch.where(mx == r, h_r, torch.where(mx == g, h_g, h_b)) / 6.0
    h = torch.where(rng == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(rng),
                    rng / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_channels(im, h: int, w: int):
    """The HSV variants' 3 spatial channels [B, h, w, 3]: the image's mean
    added back, BGR flipped to RGB, converted and resized to the feature
    map with TF1 `resize_bilinear` (CMPCv5_HSV_model.py:118-126)."""
    mean = torch.as_tensor(IMAGE_MEAN_BGR, dtype=im.dtype, device=im.device)
    return resize_bilinear(rgb_to_hsv((im + mean).flip(-1)), h, w)


def init_numpy(seed, cfg: ModelConfig, glove=None) -> dict:
    """The parameter tree as numpy arrays in the JAX package's layout, draw
    for draw what the JAX package's init_model makes from the same seed;
    `glove` [vocab_size, glove_dim] is the embedding's initial value (the
    reference starts from GloVe, CMPC_model.py:79-81).  The video config's
    tree is `models.video.init_numpy`'s."""
    _check_supported(cfg)
    if cfg.video:
        from cmpc_refseg_torch.models import video
        return video.init_numpy(seed, cfg, glove)
    keys = split_stream(seed, 12)
    params = {
        "backbone": init_backbone(keys[0], cfg.res4_blocks),
        "text": init_text_encoder(keys[1], cfg, glove),
        "parser": cmpc.init_lang_parser(keys[2], cfg),
        "levels": {},
        "fusion_stack": cmpc.init_fusion_stack(keys[3], cfg),
        "laterals": {},
        "scores": {},
    }
    lkeys = keys[4].split(len(cfg.levels) * 3)
    for i, lv in enumerate(cfg.levels):
        params["laterals"][lv] = init_conv(
            lkeys[3 * i], 1, LATERAL_IN_DIM[lv], cfg.v_emb_dim)
        params["levels"][lv] = cmpc.init_lang2vis(lkeys[3 * i + 1], cfg)
        params["scores"][f"score_{lv}"] = init_conv(
            lkeys[3 * i + 2], 3, cfg.mlp_dim, 1)
    if cfg.bbox_head:
        params["bbox"] = detection.init_bbox_head(keys[8], cfg)
    if cfg.decoder == "multiscore":
        params["scores"]["score"] = init_conv(keys[5], 3, cfg.mlp_dim, 1)
    else:
        params["aspp"], _ = aspp.init_aspp(keys[6], cfg, cfg.mlp_dim)
        params["decoder"], _ = aspp.init_v3plus_decoder(keys[7], cfg)
    return params


def init_model(seed, cfg: ModelConfig, glove=None, *, device=None) -> dict:
    """Port parameters (float32 tensors on `device`, CUDA when None) from an
    int seed, the embedding from `glove` when given (`init_numpy`)."""
    return params_from_jax(init_numpy(seed, cfg, glove), cfg, device=device)


def init_model_state(cfg: ModelConfig, *, device=None) -> dict:
    """The initial BN moving statistics (mean 0, variance 1; the second
    value of the JAX package's init_model) as float32 tensors on `device`
    (CUDA when None): {'aspp': ..., 'decoder': ...}, or {} for the
    multiscore decoder and the video model."""
    _check_supported(cfg)
    tree = aspp.init_state() if cfg.decoder == "aspp_v3plus" else {}
    return model_state_from_jax(tree, device=device)


def prepare_backbone(backbone: dict, cfg: ModelConfig) -> dict:
    """The backbone's conv kernels in bf16 (channels_last) when the compute
    dtype is bf16, built once; unchanged in f32.  An int8 unit
    (`quantize_backbone`) keeps its int8 `w_q`, stored channels_last, and
    gains `w_gemm`, the int8 GEMM's weight operand (`gemm_weight`: a view
    of `w_q` but for conv1's padded K).  Training keeps this view of the
    frozen backbone (with conv5, the frozen tree's res3-5 units have no
    kernel: they train in f32)."""
    bf16 = cfg.compute_dtype == "bfloat16"

    def prep(node):
        if "w_q" in node:
            w_q = node["w_q"].contiguous(memory_format=torch.channels_last)
            return {**node, "w_q": w_q, "w_gemm": gemm_weight(w_q)}
        if "w" in node:
            return {**node, "w": node["w"].to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)} if bf16 else node
        return {k: prep(v) if isinstance(v, dict) else v
                for k, v in node.items()}
    return prep(backbone)


def prepare_params(params: dict, cfg: ModelConfig, *,
                   quantize_backbone: bool = False) -> dict:
    """Inference view of the parameters, built once: the weights the head's
    kernels take, in the compute dtype and padded to the kernels' widths
    (each level's mutan weights [K, 5C], `cmpc.pad_mutan_weight`,
    the spatial graph's weights stacked over the levels, the exchanges' SE
    weights where the SE sum runs and the ConvLSTM's tables), the ASPP's
    and decoder's conv kernels in the compute dtype (BN's gamma and beta
    and the decoder's float32 logits conv stay f32) and
    `prepare_backbone`.  The f32 originals stay.  `quantize_backbone=True`
    first makes the backbone's units int8 (`models.backbone.
    quantize_backbone`: the serving path; its f32 kernels are dropped)."""
    backbone = params["backbone"]
    if quantize_backbone:
        backbone = _quantize_backbone(backbone)
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    levels = {}
    for lv, level in params["levels"].items():
        levels[lv] = dict(level)
        for name in [k for k in ("mutan", "sent_mutan") if k in level]:
            w_wide = cmpc.pad_mutan_weight(
                level[name]["vis_trans"]["DW"][0, 0]).to(dt).contiguous()
            levels[lv][name] = {**level[name], "w_wide": w_wide}
    fs = params["fusion_stack"]
    exchange = fs["exchange"] if cfg.exchange_self_gate else {
        k: {**pex, "se_tables": cmpc.se_tables(pex, dt)}
        for k, pex in fs["exchange"].items()}
    fusion_stack = {
        **fs, "exchange": exchange,
        "convlstm": {**fs["convlstm"],
                     "tables": cmpc.convlstm_tables(fs["convlstm"], dt)}}
    graph_stack = cmpc.stack_graph_params(
        [params["levels"][lv]["graph"] for lv in cfg.levels], dt)
    out = {**params, "levels": levels, "fusion_stack": fusion_stack,
           "graph_stack": graph_stack,
           "backbone": prepare_backbone(backbone, cfg)}
    if cfg.decoder == "aspp_v3plus":
        out["aspp"] = {k: {**u, "DW": u["DW"].to(dt)}
                       for k, u in params["aspp"].items()}
        out["decoder"] = {k: u if k == "conv_1x1" else {**u, "DW":
                                                        u["DW"].to(dt)}
                          for k, u in params["decoder"].items()}
    return out


def apply_model(params, cfg: ModelConfig, batch: dict, *,
                model_state: Optional[dict] = None, train: bool = False,
                use_kernels: bool = True) -> ModelOutputs:
    """Forward.  batch: 'im' [B,H,W,3] float32 (BGR, mean-subtracted),
    'words' [B,T] token ids with 'seq_len' [B] (back-padded) or
    'valid_idx' [B] (front-padded: the number of pads); for the 'bert'
    encoder, 'words_feat' [B,T,768] float32 and 'sequence_mask' [B,T]
    instead of tokens; with `bbox_head`, optionally 'anchors' [A, 2] (in
    cells; DEFAULT_ANCHORS when absent).  A video config's forward is
    `models.video.apply_video_model` (its batch holds a 'clip' instead of
    'im').

    `model_state`: the BN moving statistics (`init_model_state`), required
    by the ASPP decoder (a missing state raises: it is never replaced by
    initial statistics).  `train=True` normalizes the decoder's BN with the
    batch statistics; the outputs' `model_state` holds the updated moving
    statistics (no gradient).

    `use_kernels=False` runs the plain PyTorch versions of the kernels on
    any device (the reference the kernels are held against).  Where
    autograd records, this is the differentiable forward of the train step:
    the head's kernels run through ``ops/autograd.py``, from the f32
    weights (not `prepare_params`' inference view of the head); the frozen
    backbone's weights need no gradient, so autograd records nothing
    there, except through the res3-5 kernels that train with conv5."""
    _check_supported(cfg)
    if cfg.video:
        from cmpc_refseg_torch.models import video
        return video.apply_video_model(params, cfg, batch,
                                       model_state=model_state, train=train,
                                       use_kernels=use_kernels)
    return _apply_image(params, cfg, batch, model_state=model_state,
                        train=train, use_kernels=use_kernels)


def _apply_image(params, cfg: ModelConfig, batch: dict, *,
                 model_state: Optional[dict], train: bool,
                 use_kernels: bool) -> ModelOutputs:
    """`apply_model`'s body for the image configs."""
    if cfg.video:
        raise ValueError(f"{cfg.variant}: the video model's forward is "
                         "models.video.apply_video_model")
    decoder = cfg.decoder == "aspp_v3plus"
    if decoder and model_state is None:
        raise ValueError(f"{cfg.variant or 'this config'}: the ASPP decoder "
                         "needs model_state (the BN moving statistics)")
    im = batch["im"]
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    route = dict(use_kernels=use_kernels)

    taps = tuple(cfg.levels) + (("c2",) if decoder else ())
    with span("cmpc.backbone"):
        vis = apply_backbone(params["backbone"], im, compute_dtype=dt,
                             taps=taps, res4_blocks=cfg.res4_blocks)
        if dt is not None:
            vis = {k: v.to(dt) for k, v in vis.items()}

    with span("cmpc.text"):
        text = encode_text(params["text"], cfg, batch.get("words"),
                           batch.get("seq_len"),
                           valid_idx=batch.get("valid_idx"),
                           words_feat=batch.get("words_feat"),
                           sequence_mask=batch.get("sequence_mask"))
        words_parse = cmpc.apply_lang_parser(params["parser"],
                                             text.parse_feat, text.seq_mask)

    with span("cmpc.head"):
        laterals = {}
        for lv in cfg.levels:
            x = conv2d(params["laterals"][lv], vis[lv])
            if cfg.tanh_lateral:   # CMPCv5_BiLSTM_model.py:121-125
                x = torch.tanh(x)
            laterals[lv] = l2_normalize(x, -1)

        b = im.shape[0]
        h, w = laterals[cfg.levels[0]].shape[1:3]
        spatial = spatial_coordinate_grid(h, w, device=im.device)[
            None].expand(b, h, w, 8)
        if cfg.hsv:
            spatial = torch.cat([spatial, hsv_channels(im, h, w)], dim=-1)

        fusion_list, gw_list = cmpc.apply_lang2vis_multi(
            [params["levels"][lv] for lv in cfg.levels], cfg,
            [laterals[lv] for lv in cfg.levels], text.words_feat,
            words_parse, text.seq_mask, spatial,
            graph_stack=params.get("graph_stack"), **route)
        fusions, gw, up_levels = {}, {}, {}
        for lv, fusion_lv, gw_lv in zip(cfg.levels, fusion_list, gw_list):
            fusions[lv] = fusion_lv
            gw[lv] = gw_lv
            score_lv = conv2d(params["scores"][f"score_{lv}"],
                              fusion_lv.float())
            up_levels[lv] = resize_bilinear(score_lv, cfg.H, cfg.W)

    with span("cmpc.fusion"):
        nec = cmpc.valid_lang_feat(words_parse, text.words_feat,
                                   tuple(range(cfg.parse_classes - 1)))
        fused = cmpc.apply_fusion_stack(params["fusion_stack"], cfg, fusions,
                                        nec, **route)

    with span("cmpc.decode"):
        if decoder:
            enc, st_aspp = aspp.apply_aspp(params["aspp"],
                                           model_state["aspp"], fused,
                                           train=train)
            pred, st_dec = aspp.apply_v3plus_decoder(
                params["decoder"], model_state["decoder"], enc, vis["c2"],
                train=train)
            if train:
                model_state = {"aspp": st_aspp, "decoder": st_dec}
        else:
            pred = conv2d(params["scores"]["score"], fused.float())
        up = resize_bilinear(pred, cfg.H, cfg.W)
        sigm = torch.sigmoid(up)
        bbox = None
        if cfg.bbox_head:
            anchors = batch.get("anchors")
            if anchors is None:
                anchors = DEFAULT_ANCHORS[:cfg.num_anchors]
            bbox = detection.apply_bbox_head(params["bbox"], fused, anchors,
                                             stride=cfg.H // cfg.vf_h)
    return ModelOutputs(pred, up, sigm, up_levels, words_parse, gw,
                        {} if model_state is None else model_state, bbox)


# ---------------------------------------------------------------------------
# loss (train_op, CMPC_model.py:426-447)
# ---------------------------------------------------------------------------

def _collect_reg_leaves(params, cfg: ModelConfig) -> list:
    """Regularized leaves: every 'DW' conv kernel of the head, the ASPP's
    and decoder's included (the reference filters trainable names for
    'DW', CMPC_model.py:433; BN's gamma and beta are not matched), and,
    with conv5=True, the res3-5 conv kernels 'w' (their folded BN
    constants are not trained)."""
    leaves = []

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == key:
                    leaves.append(v)
                else:
                    walk(v, key)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, key)

    for k, v in params.items():
        if k != "backbone":
            walk(v, "DW")
        elif cfg.conv5:
            walk({n: b for n, b in v.items()
                  if n.startswith(TRAINABLE_STAGES)}, "w")
    return leaves


def compute_loss(outputs: ModelOutputs, target, cfg: ModelConfig,
                 params=None, *, label_bbox=None, true_bbox=None):
    """The 4-term weighed logistic loss + L2 regularization
    (CMPC_model.py:439-447): main and per-level losses weighted by
    cfg.loss_weights (main, c5, c4, c3); with the detection head and
    `label_bbox` [B,S,S,A,5] / `true_bbox` [B,M,4] given, plus the
    detection loss at weight 1 (the v5+ train script,
    trainval_model_v5+.py).  Returns (total, metrics) with 'loss_main',
    'loss_<level>', 'loss_cls_all', 'loss_bbox' (with box labels),
    'loss_reg' (when `params` is given) and 'loss_total'."""
    metrics = {}
    main = losses.weighed_logistic_loss(outputs.up, target, 1, 1)
    metrics["loss_main"] = main
    total = cfg.loss_weights[0] * main
    level_order = [lv for lv in ("c5", "c4", "c3") if lv in cfg.levels]
    for wgt, lv in zip(cfg.loss_weights[1:], level_order):
        lv_loss = losses.weighed_logistic_loss(outputs.up_levels[lv], target,
                                               1, 1)
        metrics[f"loss_{lv}"] = lv_loss
        total = total + wgt * lv_loss
    metrics["loss_cls_all"] = total
    if cfg.bbox_head and outputs.bbox is not None and label_bbox is not None:
        raw, decoded = outputs.bbox
        det = detection.bbox_loss(raw, decoded, label_bbox, true_bbox,
                                  input_size=cfg.H)
        metrics["loss_bbox"] = det
        total = total + det
    if params is not None:
        reg = losses.l2_regularization_loss(_collect_reg_leaves(params, cfg),
                                            cfg.weight_decay)
        metrics["loss_reg"] = reg
        total = total + reg
    metrics["loss_total"] = total
    return total, metrics
