"""Model configuration and variant registry.

A copy of the JAX package's framework-free ``ModelConfig`` / ``VARIANTS`` /
``get_config`` (the port imports nothing of the JAX package).  Every variant
of the reference is a :class:`ModelConfig`; the parity mapping of each
reference model file to a config is recorded in ``VARIANTS``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration for the CMPC model family.

    Defaults follow the reference flagship model (CMPC_model.py:15-40).
    """

    # Registry name of this variant ("" for hand-built configs).
    variant: str = ""

    # --- geometry -----------------------------------------------------------
    batch_size: int = 1
    num_steps: int = 20           # T: max text tokens (CMPC_model.py:16)
    H: int = 320
    W: int = 320
    vf_dim: int = 2048            # c5 channel count

    # --- embedding / dims ---------------------------------------------------
    res4_blocks: int = 23         # 23 = ResNet-101 (reference backbone)
    vocab_size: int = 12112
    w_emb_dim: int = 1000
    v_emb_dim: int = 1000
    mlp_dim: int = 500
    rnn_size: int = 1000
    glove_dim: int = 300
    bert_dim: int = 768           # BERT feature dim (CMPCv4_BERT_model.py:80)
    vw_emb_dim: Optional[int] = None  # separate affinity proj (BERT: 512)

    # --- architecture selectors --------------------------------------------
    # pyramid levels fed through lang2vis; c3/c4/c5 from the ResNet backbone
    levels: Tuple[str, ...] = ("c3", "c4", "c5")
    # text encoder: 'lstm' (back-pad + seq_len, dynamic_rnn semantics),
    # 'lstm_frontpad' (origin-style front-padded unrolled LSTM),
    # 'bilstm', 'bert' (precomputed features)
    text_encoder: str = "lstm"
    # decoder: 'multiscore' = 3x3 score conv on fused feats (CMPC_model.py:138)
    #          'aspp_v3plus' = ASPP + DeepLabv3+ decoder w/ c2 lateral
    #                          (CMPCv4_model.py:150-156)
    decoder: str = "multiscore"
    # graph affinity normalization:
    #  'masked'          mask -> softmax over T; softmax over HW -> mask
    #                    (CMPC_model.py:389-399)
    #  'unmasked'        plain softmax over T and HW (CMPC_model_origin.py)
    #  'softmax_mask'    softmax over T then multiply mask (CMPCv5_model.py)
    #  'double_softmax'  extra softmax over axis -2 (CMPCv4_BiLSTM_T2_model.py)
    graph_norm: str = "masked"
    num_graph_conv: int = 1       # v6+: 2 stacked graph convs
    hsv: bool = False             # v5_HSV: HSV channels in spatial grid
    tanh_lateral: bool = False    # v5_BiLSTM: tanh on lateral visual feats
    exchange_self_gate: bool = False  # v6: per-feature global vec + self gate
    sent_fusion: bool = False     # v6+: second mutan fusion with nec_lang
    l2norm_affinity: bool = False  # v6+: l2-normalize affinity inputs
    bbox_head: bool = False       # v5+ train script: YOLO-style detection aux head
    num_anchors: int = 3
    # BiLSTM sub-variants:
    #  words source fed downstream: 'fw' (T/T2, CMPCv4_BiLSTM_T_model.py:185
    #  returns fw as words_feat) or 'merged' (v5_BiLSTM)
    bilstm_words_source: str = "merged"
    bilstm_tanh: bool = False       # v5_BiLSTM: tanh before l2norm on merge
    bilstm_mask_pre_merge: bool = False  # v5_BiLSTM: seq_mask from raw concat

    # --- video (CMPC_video/CMPC_video_mm_tgraph_allvec.py) ------------------
    video: bool = False
    num_frames: int = 16
    sampled_frames: Tuple[int, ...] = (0, 4, 8, 12, 15)
    # word-parse classes: 4 = {Entity, Attribute, Relation, Unnecessary}
    # (CMPC_model.py:356); video uses 5 (+Action)
    parse_classes: int = 4

    # --- optimization (CMPC_model.py:426-492) -------------------------------
    start_lr: float = 2.5e-4
    end_lr: float = 1e-5
    lr_decay_step: int = 800_000
    lr_power: float = 0.9
    weight_decay: float = 5e-4
    optimizer: str = "adam"
    grad_accum: int = 1           # micro-batches per Adam update
    conv5: bool = False           # also train res3/4/5 conv weights
    # loss weights: (main, c5, c4, c3) - (CMPC_model.py:444-445)
    loss_weights: Tuple[float, ...] = (0.7, 0.1, 0.1, 0.1)
    is_aug: bool = False          # v4+: random brightness 0.2 at train time

    # --- numerics ------------------------------------------------------------
    # compute dtype for conv/matmul heavy paths; params stay float32
    compute_dtype: str = "float32"

    @property
    def vf_h(self) -> int:
        return self.H // 8

    @property
    def vf_w(self) -> int:
        return self.W // 8

    @property
    def spatial_dim(self) -> int:
        # 8-dim coord grid; HSV variants concat 3 more channels
        return 11 if self.hsv else 8

    @property
    def lang_dim(self) -> int:
        """Output dim of the language encoder (per-word feature dim)."""
        return self.bert_dim if self.text_encoder == "bert" else self.rnn_size

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Variant registry: reference model file -> ModelConfig
# ---------------------------------------------------------------------------

_BASE = ModelConfig()

VARIANTS = {
    # CMPC_model.py — fork's flagship: 3 levels, dynamic_rnn LSTM (back-pad),
    # masked graph softmax, 4-term loss 0.7/0.1/0.1/0.1
    "CMPC_model": _BASE,
    # CMPC_model_origin.py — paper model: front-padded unrolled LSTM,
    # unmasked graph softmax
    "CMPC_model_origin": _BASE.replace(
        text_encoder="lstm_frontpad", graph_norm="unmasked"),
    # CMPCv2_model.py — drops c3; loss 0.7/0.15/0.15
    "CMPCv2_model": _BASE.replace(
        levels=("c4", "c5"), loss_weights=(0.7, 0.15, 0.15)),
    # CMPCv3_model.py — v2 topology + origin-style text encoder
    "CMPCv3_model": _BASE.replace(
        levels=("c4", "c5"), loss_weights=(0.7, 0.15, 0.15),
        text_encoder="lstm_frontpad"),
    # CMPCv4_model.py — v2 + ASPP + DeepLabv3+ decoder, brightness aug,
    # loss 0.8/0.1/0.1
    "CMPCv4_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True),
    # CMPCv4_BiLSTM_T_model.py — v4 + BiLSTM text encoder (fw outputs feed
    # downstream modules; parser runs on the merged features)
    "CMPCv4_BiLSTM_T_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True, text_encoder="bilstm",
        bilstm_words_source="fw"),
    # CMPCv4_BiLSTM_T2_model.py — T + double-softmax affinity normalization
    "CMPCv4_BiLSTM_T2_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True, text_encoder="bilstm",
        bilstm_words_source="fw", graph_norm="double_softmax"),
    # CMPCv4_BERT_model.py — precomputed BERT features, bigger dims
    "CMPCv4_BERT_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), text_encoder="bert",
        rnn_size=768, v_emb_dim=1024, mlp_dim=512, vw_emb_dim=512),
    # CMPCv5_model.py — v4 + softmax-then-mask graph normalization
    "CMPCv5_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True,
        graph_norm="softmax_mask"),
    # CMPCv5_HSV_model.py — v5 + HSV channels on the spatial grid
    "CMPCv5_HSV_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True,
        graph_norm="softmax_mask", hsv=True),
    # CMPCv5_BiLSTM_model.py — v5 + BiLSTM + tanh laterals
    "CMPCv5_BiLSTM_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True,
        graph_norm="softmax_mask", text_encoder="bilstm",
        tanh_lateral=True, bilstm_tanh=True, bilstm_mask_pre_merge=True),
    # CMPCv5_BiLSTM_HSV_model.py
    "CMPCv5_BiLSTM_HSV_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True,
        graph_norm="softmax_mask", text_encoder="bilstm",
        tanh_lateral=True, bilstm_tanh=True, bilstm_mask_pre_merge=True,
        hsv=True),
    # CMPCv6_model.py — per-exchanged-feature global vectors + self gate
    "CMPCv6_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True,
        exchange_self_gate=True),
    # CMPCv6_plus_model.py — 2 graph convs, sentence-conditioned 2nd fusion,
    # l2-normalized affinity inputs
    "CMPCv6_plus_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True,
        exchange_self_gate=True, num_graph_conv=2, sent_fusion=True,
        l2norm_affinity=True),
    # CMPC_video/CMPC_video_mm_tgraph_allvec.py — video model, 5-way parse
    "CMPC_video_mm_tgraph_allvec": _BASE.replace(
        video=True, parse_classes=5, text_encoder="lstm_frontpad"),
    # "v5+" — the reference's trainval_model_v5+.py script feeds YOLO bbox
    # labels (label_bbox/true_bbox + anchors) but the matching model file is
    # absent from the snapshot (SURVEY.md section 2.2); this config realizes
    # that surface: v5 + the detection aux head (models/detection.py)
    "CMPCv5_plus_model": _BASE.replace(
        levels=("c4", "c5"), decoder="aspp_v3plus",
        loss_weights=(0.8, 0.1, 0.1), is_aug=True,
        graph_norm="softmax_mask", text_encoder="lstm_frontpad",
        bbox_head=True),
}

# Stamp each registry entry with its own name.
VARIANTS = {name: cfg.replace(variant=name) for name, cfg in VARIANTS.items()}


def get_config(name: str, **overrides) -> ModelConfig:
    """Look up a variant config by reference model name (explicit registry;
    replaces the reference's ``eval()`` dispatch at get_model.py:15-17)."""
    if name not in VARIANTS:
        raise KeyError(
            f"Unknown model variant {name!r}. Available: {sorted(VARIANTS)}")
    cfg = VARIANTS[name]
    return cfg.replace(**overrides) if overrides else cfg
