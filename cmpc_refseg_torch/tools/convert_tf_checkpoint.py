"""The reference's TF-1.x checkpoint -> the port's parameters and BN moving
statistics (the counterpart of the JAX package's
tools/convert_tf_checkpoint.py, without JAX).

The reference's variable names map onto the parameter tree in the JAX
package's layout (numpy, HWIO kernels), which ``convert.params_from_jax``
and ``model_state_from_jax`` then turn into the port's tensors (backbone
kernels OIHW, head kernels HWIO):

- backbone (caffe names, kaffe/tensorflow/network.py): '<conv>/weights' +
  'bn<suffix>/{gamma,beta,moving_mean,moving_variance}' -> the kernel and
  the FOLDED scale / offset (``kaffe.convert_backbone``, slim BN eps 1e-3);
- head ('text_objseg/...'): '<scope>/DW' + '<scope>/biases'
  (CMPC_model.py:412-417), the LSTM 'rnn/lstm_cell/{kernel,bias}', the
  embedding 'Variable', the ConvLSTM 'rnn/conv_lstm_cell/{kernel,W_ci,
  W_cf,W_co}' + 'LayerNorm{,_1..4}/{gamma,beta}' in creation order (j, i,
  f, o, c; util/cell.py:52-66), the mutan's five heads stacked into one
  conv (`convert_head`);
- the ASPP + v3+ decoder's slim convs with their live BN, whose moving
  statistics become the model state (`convert_aspp_decoder`).

Leaves the checkpoint does not hold (the detection head, the mutan's and
the graph's other weights) keep the values the JAX package's converter
gives them: its skeleton is ``init_model(jax.random.PRNGKey(0), cfg)``,
whose numpy stream starts from ``SeedSequence([0, 0])`` (the key's data),
and `convert_numpy` starts the port's ``init_numpy`` from the same.

`convert_tensors` maps a name -> array function with no file I/O;
`convert` reads a checkpoint with TensorFlow, imported only there.
`reference_tensors` fabricates a reference-named checkpoint's tensors for
any image config, at any width.

Usage (on a host with TensorFlow):
  python -m cmpc_refseg_torch.tools.convert_tf_checkpoint \\
      --ckpt /path/model.ckpt-700000 --model CMPC_model --out params.npz \\
      [--ckpt_dir ckpt_unc]

writes the .npz of the JAX package's converter (one array per parameter
leaf, keyed as ``jax.tree_util.keystr`` prints its path; no BN moving
statistics) and, with --ckpt_dir, step 0 of a port TrainState checkpoint
that keeps them, which ``cmpc_refseg_torch.cli -m test -ckpt_dir`` restores.
"""

from __future__ import annotations

import argparse

import numpy as np

from cmpc_refseg_torch.tools.kaffe import BN_EPS, bn_name_for, convert_backbone

SCOPE = "text_objseg"
# the JAX converter's PRNGKey(0) as its InitStream seeds numpy
# (the JAX package's ops/layers.py:28-34): SeedSequence of the key's data
INIT_KEY_DATA = (0, 0)


def convert_head(get, params, cfg, scope=SCOPE, state=None):
    """Fill the head of the numpy tree `params` (JAX layout) in place from
    `get(name)`, and with `state` the ASPP decoder's BN moving statistics.

    Covers every image variant family:
    - base/v2/v3: LSTM encoder + multiscore decoder (CMPC_model.py);
    - v4/v5: ASPP + v3+ decoder slim variables with LIVE BN statistics
      (CMPCv4_model.py:181-242);
    - BiLSTM (T/T2/v5_BiLSTM): bidirectional_dynamic_rnn fw/bw scopes +
      the words_feat merge conv (CMPCv4_BiLSTM_T_model.py:161-187);
    - BERT: no embedding / LSTM variables (features are placeholders,
      CMPCv4_BERT_model.py:80-83);
    - v6: per-exchanged-feature global vectors + self gate
      (CMPCv6_model.py:323-339: `{key}gv_f` / `_f` for the feature
      itself, `{key}gv_f1` / `_f1` for the other level);
    - v6+: entity_fusion_ / sent_fusion_ mutan prefixes
      (CMPCv6_plus_model.py:419-427) and stacked gconvs spa_graph_0/1
      (:494-496).
    """
    def conv(name):
        return {"DW": get(f"{scope}/{name}/DW"),
                "biases": get(f"{scope}/{name}/biases")}

    def ln(name):
        return {"gamma": get(f"{scope}/{name}/gamma"),
                "beta": get(f"{scope}/{name}/beta")}

    def gv(name):
        """A global_vec scope set (CMPC_model.py:212-243)."""
        return {"spa_graph_key": conv(f"spa_graph_key_{name}"),
                "lang_query": conv(f"lang_query_{name}"),
                "gv_lang": conv(f"gv_lang_{name}")}

    def mutan(level_name):
        """The 5 per-head convs stacked along the output axis (mutan_head
        scopes `vis_trans_{level}_head{i}`, CMPC_model.py:295-328)."""
        def stacked(kind, leaf):
            return np.concatenate(
                [get(f"{scope}/{kind}_trans_{level_name}_head{i}/{leaf}")
                 for i in range(1, 6)], axis=-1)
        return {f"{kind}_trans": {"DW": stacked(kind, "DW"),
                                  "biases": stacked(kind, "biases")}
                for kind in ("vis", "lang")}

    text = params["text"]
    if cfg.text_encoder != "bert":     # BERT: no embedding / LSTM variables
        text["embedding"] = get(f"{scope}/Variable")
        if "lstm" in text:
            text["lstm"] = {"kernel": get(f"{scope}/rnn/lstm_cell/kernel"),
                            "bias": get(f"{scope}/rnn/lstm_cell/bias")}
        if "lstm_fw" in text:
            # bidirectional_dynamic_rnn's default scope
            # (CMPCv4_BiLSTM_T_model.py:166-171), then the fw/bw concat's
            # 1x1 merge conv (:178)
            base = f"{scope}/bidirectional_rnn"
            for d in ("fw", "bw"):
                text[f"lstm_{d}"] = {
                    "kernel": get(f"{base}/{d}/lstm_cell/kernel"),
                    "bias": get(f"{base}/{d}/lstm_cell/bias")}
            text["words_feat"] = conv("words_feat")
    params["parser"]["words_parse_1"] = conv("words_parse_1")
    params["parser"]["words_parse_2"] = conv("words_parse_2")

    for lv in cfg.levels:
        lp = params["levels"][lv]
        params["laterals"][lv] = conv(f"{lv}_lateral")
        # the checkpoint holds the projections; the mutan's other leaves
        # keep their initial values
        lp["mutan"] = {**lp["mutan"], **mutan(
            f"entity_fusion_{lv}" if cfg.sent_fusion else lv)}
        if "sent_mutan" in lp:
            lp["sent_mutan"] = {**lp["sent_mutan"],
                                **mutan(f"sent_fusion_{lv}")}
        lp["graph"]["words_trans"] = conv(f"words_trans_{lv}")
        lp["graph"]["spa_graph_trans2"] = conv(f"spa_graph_trans2_{lv}")
        for i, gp in enumerate(lp["graph"]["gconv"]):
            gname = ("spa_graph" if cfg.num_graph_conv == 1
                     else f"spa_graph_{i}")
            gp["update"] = conv(f"gconv_update_{gname}_{lv}")
            gp["feat_ln"] = ln(f"gconv_feat_ln_{gname}_{lv}")
            gp["update_ln"] = ln(f"gconv_update_ln_{gname}_{lv}")
        lp["fusion"] = conv(f"fusion_{lv}")
        params["scores"][f"score_{lv}"] = conv(f"score_{lv}")

    # the gated exchange rounds
    for key, p in params["fusion_stack"]["exchange"].items():
        if "gv" in p:
            p["gv"] = gv(f"{key}gv_f1")
        else:
            # v6 (CMPCv6_model.py:323-339): gv + SE on the target feature
            # itself (`gv_f` / `_f`), then one gv + SE per other level
            # (`gv_f1` / `_f1`, ...)
            p["gv_self"] = gv(f"{key}gv_f")
            p["se_self"] = {"lang_feat": conv(f"lang_feat_{key}_f"),
                            "trans_feat": conv(f"trans_feat_{key}_f")}
            p["gv_each"] = [gv(f"{key}gv_f{i}")
                            for i in range(1, len(p["gv_each"]) + 1)]
        for i, se in enumerate(p["se"], start=1):
            se["lang_feat"] = conv(f"lang_feat_{key}_f{i}")
            se["trans_feat"] = conv(f"trans_feat_{key}_f{i}")

    # the ConvLSTM (dynamic_rnn's scope 'rnn/conv_lstm_cell')
    cl = params["fusion_stack"]["convlstm"]
    base = f"{scope}/rnn/conv_lstm_cell"
    cl["kernel"] = get(f"{base}/kernel")
    for w in ("W_ci", "W_cf", "W_co"):
        cl[w] = get(f"{base}/{w}")
    for i in range(5):   # creation order j, i, f, o, c
        suffix = "" if i == 0 else f"_{i}"
        cl["ln"][i] = {"gamma": get(f"{base}/LayerNorm{suffix}/gamma"),
                       "beta": get(f"{base}/LayerNorm{suffix}/beta")}

    if "score" in params["scores"]:
        params["scores"]["score"] = conv("score")
    if cfg.decoder == "aspp_v3plus":
        convert_aspp_decoder(get, params, state, scope=scope)
    return params


# slim conv2d scope -> the aspp / decoder keys.  The model builds under
# variable_scope('text_objseg') (CMPCv4_model.py:95); the ASPP at :212-242,
# the decoder at :181-197.  resnet_arg_scope attaches BatchNorm
# (scale=True) to every conv but the decoder's final 1x1 logits conv
# (activation_fn=None, normalizer_fn=None: weights + biases).
ASPP_SCOPES = {
    "conv_1x1": "aspp/conv_1x1",
    "conv_3x3_1": "aspp/conv_3x3_1",
    "conv_3x3_2": "aspp/conv_3x3_2",
    "conv_3x3_3": "aspp/conv_3x3_3",
    "image_level": "aspp/image_level_features/conv_1x1",
    "conv_1x1_concat": "aspp/conv_1x1_concat",
}
DECODER_BN_SCOPES = {
    "low_level": "decoder/low_level_features/conv_1x1",
    "conv_3x3_1": "decoder/upsampling_logits/conv_3x3_1",
    "conv_3x3_2": "decoder/upsampling_logits/conv_3x3_2",
}
DECODER_LOGITS_SCOPE = "decoder/upsampling_logits/conv_1x1"


def convert_aspp_decoder(get, params, state, scope=SCOPE):
    """Fill the ASPP + v3+ decoder's params, and the live BN's moving
    statistics into `state` when given, from slim variable names
    (CMPCv4_model.py:181-242).  Unlike the frozen backbone BN (folded),
    these BN layers train in the reference (update_ops), so gamma / beta
    stay parameters and moving_mean / variance are the model state."""
    def bn_unit(tfscope):
        p = {"DW": get(f"{scope}/{tfscope}/weights"),
             "gamma": get(f"{scope}/{tfscope}/BatchNorm/gamma"),
             "beta": get(f"{scope}/{tfscope}/BatchNorm/beta")}
        s = {"mean": get(f"{scope}/{tfscope}/BatchNorm/moving_mean"),
             "var": get(f"{scope}/{tfscope}/BatchNorm/moving_variance")}
        return p, s

    for part, scopes in (("aspp", ASPP_SCOPES),
                         ("decoder", DECODER_BN_SCOPES)):
        for key, sc in scopes.items():
            params[part][key], st = bn_unit(sc)
            if state is not None:
                state[part][key] = st
    params["decoder"]["conv_1x1"] = {
        "DW": get(f"{scope}/{DECODER_LOGITS_SCOPE}/weights"),
        "biases": get(f"{scope}/{DECODER_LOGITS_SCOPE}/biases")}
    return params


def _check_image_config(cfg) -> None:
    if cfg.video:
        raise ValueError(
            f"{cfg.variant}: the reference's TF checkpoints hold the image "
            "models; the video model's tree has no reference variable "
            "layout to map")


def convert_numpy(get, cfg):
    """(params, model state) of config `cfg` as numpy trees in the JAX
    package's layout, filled from `get(name)` (a reference variable name
    -> its array); leaves the checkpoint does not hold keep the JAX
    converter's initial values.  A video config raises ValueError."""
    from cmpc_refseg_torch.models import aspp
    from cmpc_refseg_torch.models.model import init_numpy

    _check_image_config(cfg)
    params = init_numpy(np.random.SeedSequence(list(INIT_KEY_DATA)), cfg)
    state = aspp.init_state() if cfg.decoder == "aspp_v3plus" else {}
    convert_backbone(get, params["backbone"])
    convert_head(get, params, cfg, state=state)
    return params, state


def convert_tensors(get, model_name: str, overrides=None, *, device=None):
    """(cfg, params, model_state) of `model_name` (with `overrides`) from
    `get(name)`, a reference variable name -> its array; no file is read.
    The parameters and BN moving statistics are the port's tensors on
    `device` (CUDA when None; raises without it)."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.convert import (model_state_from_jax,
                                           params_from_jax)

    cfg = get_config(model_name, **(overrides or {}))
    params, state = convert_numpy(get, cfg)
    return (cfg, params_from_jax(params, cfg, device=device),
            model_state_from_jax(state, device=device))


def checkpoint_getter(ckpt_path: str):
    """`get(name)` over the TF checkpoint at `ckpt_path` (a prefix such as
    model.ckpt-700000); imports tensorflow, which the port needs nowhere
    else."""
    import tensorflow as tf

    reader = tf.train.load_checkpoint(ckpt_path)
    return lambda name: np.asarray(reader.get_tensor(name))


def convert(ckpt_path: str, model_name: str, overrides=None, *,
            device=None):
    """`convert_tensors` over the TF checkpoint at `ckpt_path` (read with
    tensorflow, imported here)."""
    return convert_tensors(checkpoint_getter(ckpt_path), model_name,
                           overrides, device=device)


def save_train_state(directory: str, cfg, params, model_state) -> None:
    """Step 0 of a port checkpoint under `directory`: a fresh TrainState
    (Adam's moments zero) of the converted weights and BN moving
    statistics, as ``cli -m test -ckpt_dir`` and ``restore_checkpoint``
    read it."""
    from cmpc_refseg_torch.train.checkpoint import save_checkpoint
    from cmpc_refseg_torch.train.trainer import train_state_from_params

    save_checkpoint(directory,
                    train_state_from_params(params, cfg, model_state), 0)


# --------------------------------------------------------------------------
# a fabricated reference checkpoint
# --------------------------------------------------------------------------

def backbone_units(res4_blocks: int):
    """(caffe conv name, HWIO kernel shape) of each backbone unit, in the
    order of the parameter tree (conv1, then each block's branch1 /
    branch2a / 2b / 2c)."""
    from cmpc_refseg_torch.models.backbone import resnet_stages

    units = [("conv1", (7, 7, 3, 64))]
    cin = 64
    for stage, blocks, mid, cout, _, _ in resnet_stages(res4_blocks):
        for bi, b in enumerate(blocks):
            name = f"{stage}{b}"
            if bi == 0:
                units.append((f"{name}_branch1", (1, 1, cin, cout)))
            units += [(f"{name}_branch2a",
                       (1, 1, cin if bi == 0 else cout, mid)),
                      (f"{name}_branch2b", (3, 3, mid, mid)),
                      (f"{name}_branch2c", (1, 1, mid, cout))]
        cin = cout
    return units


def reference_tensors(cfg, seed: int = 7) -> dict:
    """{reference variable name: float32 array} of a checkpoint of image
    config `cfg`, drawn from `seed`: the names and shapes of the
    reference's variables (those the converter reads), as
    tests/test_converter.py's fixture fabricates them, at any width.

    The scales are reckoned so that the converted model's activations stay
    bounded at full depth and width (320x320, 2048-channel c5): each
    kernel is N(0, 1) * gain / sqrt(fan_in) (fan_in = the product of all
    but its output axis; gain sqrt(2) in the ReLU backbone, 1 in the
    head); each BN's moving variance is |N(0, 1)| + 0.5 and its gamma
    sqrt(variance + eps) times the unit's folded scale: 1, and
    1 / sqrt(blocks) on each residual branch's last conv, so that 33
    residual sums grow the backbone's activations by a bounded factor.
    Biases, betas, means, the embedding and the ConvLSTM's peepholes are
    0.05 N(0, 1); layer-norm gammas 1 + 0.05 N(0, 1).  A video config
    raises ValueError."""
    from cmpc_refseg_torch.models.aspp import ASPP_DEPTH
    from cmpc_refseg_torch.models.backbone import resnet_stages
    from cmpc_refseg_torch.models.model import LATERAL_IN_DIM

    _check_image_config(cfg)
    rng = np.random.default_rng(seed)
    t = {}

    def put(name, value):
        t[name] = np.asarray(value, np.float32)

    def small(name, shape):
        put(name, 0.05 * rng.standard_normal(shape))

    def kernel(name, shape, gain=1.0):
        fan_in = int(np.prod(shape[:-1]))
        put(name, rng.standard_normal(shape) * (gain / np.sqrt(fan_in)))

    def variance(name, c):
        put(name, np.abs(rng.standard_normal((c,))) + 0.5)
        return t[name]

    # --- backbone: conv '<name>/weights' + BN 'bn<suffix>/{...}' ---
    blocks = sum(len(s[1]) for s in resnet_stages(cfg.res4_blocks))
    for conv_name, shape in backbone_units(cfg.res4_blocks):
        kernel(f"{conv_name}/weights", shape, gain=np.sqrt(2.0))
        bn, cout = bn_name_for(conv_name), shape[-1]
        folded = (1 / np.sqrt(blocks) if conv_name.endswith("branch2c")
                  else 1.0)
        var = np.abs(rng.standard_normal((cout,))) + 0.5
        put(f"{bn}/gamma", folded * np.sqrt(var + BN_EPS))
        small(f"{bn}/beta", (cout,))
        small(f"{bn}/moving_mean", (cout,))
        put(f"{bn}/moving_variance", var)

    # --- head (scope text_objseg) ---
    s = SCOPE
    lang, sp = cfg.lang_dim, cfg.spatial_dim
    affin = cfg.vw_emb_dim or cfg.v_emb_dim

    def conv(name, cin, cout, k=1):
        kernel(f"{s}/{name}/DW", (k, k, cin, cout))
        small(f"{s}/{name}/biases", (cout,))

    def ln(name, c):
        put(f"{s}/{name}/gamma", 1 + 0.05 * rng.standard_normal((c,)))
        small(f"{s}/{name}/beta", (c,))

    def gv(name):
        conv(f"spa_graph_key_{name}", cfg.mlp_dim, cfg.mlp_dim)
        conv(f"lang_query_{name}", lang, cfg.mlp_dim)
        conv(f"gv_lang_{name}", cfg.mlp_dim + lang, cfg.mlp_dim)

    def se(name):
        conv(f"lang_feat_{name}", cfg.mlp_dim, cfg.mlp_dim)
        conv(f"trans_feat_{name}", cfg.mlp_dim, cfg.mlp_dim)

    def mutan(level_name):
        for i in range(1, 6):
            conv(f"vis_trans_{level_name}_head{i}", cfg.v_emb_dim + sp,
                 cfg.v_emb_dim)
            conv(f"lang_trans_{level_name}_head{i}", lang, cfg.v_emb_dim)

    def lstm(base):
        kernel(f"{base}/lstm_cell/kernel",
               (cfg.glove_dim + cfg.rnn_size, 4 * cfg.rnn_size))
        small(f"{base}/lstm_cell/bias", (4 * cfg.rnn_size,))

    if cfg.text_encoder in ("lstm", "lstm_frontpad"):
        small(f"{s}/Variable", (cfg.vocab_size, cfg.glove_dim))
        lstm(f"{s}/rnn")
    elif cfg.text_encoder == "bilstm":
        small(f"{s}/Variable", (cfg.vocab_size, cfg.glove_dim))
        for d in ("fw", "bw"):
            lstm(f"{s}/bidirectional_rnn/{d}")
        conv("words_feat", 2 * cfg.rnn_size, cfg.rnn_size)
    # bert: no embedding / LSTM variables

    conv("words_parse_1", lang, 500)
    conv("words_parse_2", 500, cfg.parse_classes)
    for lv in cfg.levels:
        conv(f"{lv}_lateral", LATERAL_IN_DIM[lv], cfg.v_emb_dim)
        mutan(f"entity_fusion_{lv}" if cfg.sent_fusion else lv)
        if cfg.sent_fusion:
            mutan(f"sent_fusion_{lv}")
        conv(f"words_trans_{lv}", lang, affin)
        conv(f"spa_graph_trans2_{lv}", cfg.v_emb_dim, affin)
        for i in range(cfg.num_graph_conv):
            gname = ("spa_graph" if cfg.num_graph_conv == 1
                     else f"spa_graph_{i}")
            conv(f"gconv_update_{gname}_{lv}", cfg.v_emb_dim, cfg.v_emb_dim)
            ln(f"gconv_feat_ln_{gname}_{lv}", cfg.v_emb_dim)
            ln(f"gconv_update_ln_{gname}_{lv}", cfg.v_emb_dim)
        conv(f"fusion_{lv}", cfg.v_emb_dim if cfg.sent_fusion
             else 2 * cfg.v_emb_dim + lang + sp, cfg.mlp_dim)
        conv(f"score_{lv}", cfg.mlp_dim, 1, k=3)

    n_other = len(cfg.levels) - 1
    for rnd in ("", "_2"):
        for lv in cfg.levels:
            key = f"{lv}{rnd}"
            if cfg.exchange_self_gate:
                gv(f"{key}gv_f")
                se(f"{key}_f")
                for i in range(1, n_other + 1):
                    gv(f"{key}gv_f{i}")
                    se(f"{key}_f{i}")
            else:
                gv(f"{key}gv_f1")
                for i in range(1, n_other + 1):
                    se(f"{key}_f{i}")

    base = f"{s}/rnn/conv_lstm_cell"
    kernel(f"{base}/kernel", (1, 1, 2 * cfg.mlp_dim, 4 * cfg.mlp_dim))
    for w in ("W_ci", "W_cf", "W_co"):
        small(f"{base}/{w}", (cfg.vf_h, cfg.vf_w, cfg.mlp_dim))
    for i in range(5):
        ln(f"rnn/conv_lstm_cell/LayerNorm{'' if i == 0 else f'_{i}'}",
           cfg.mlp_dim)

    if cfg.decoder == "multiscore":
        conv("score", cfg.mlp_dim, 1, k=3)
    else:
        # slim ASPP + v3+ decoder: conv 'weights' + a BatchNorm sub-scope
        # with live statistics, the logits conv with 'biases'
        def slim(tfscope, k, cin, cout, bn=True):
            kernel(f"{s}/{tfscope}/weights", (k, k, cin, cout))
            if not bn:
                small(f"{s}/{tfscope}/biases", (cout,))
                return
            var = np.abs(rng.standard_normal((cout,))) + 0.5
            put(f"{s}/{tfscope}/BatchNorm/gamma", np.sqrt(var + BN_EPS))
            small(f"{s}/{tfscope}/BatchNorm/beta", (cout,))
            small(f"{s}/{tfscope}/BatchNorm/moving_mean", (cout,))
            put(f"{s}/{tfscope}/BatchNorm/moving_variance", var)

        d = ASPP_DEPTH
        slim(ASPP_SCOPES["conv_1x1"], 1, cfg.mlp_dim, d)
        for i in (1, 2, 3):
            slim(ASPP_SCOPES[f"conv_3x3_{i}"], 3, cfg.mlp_dim, d)
        slim(ASPP_SCOPES["image_level"], 1, cfg.mlp_dim, d)
        slim(ASPP_SCOPES["conv_1x1_concat"], 1, 5 * d, d)
        slim(DECODER_BN_SCOPES["low_level"], 1, 256, 48)
        slim(DECODER_BN_SCOPES["conv_3x3_1"], 3, d + 48, d)
        slim(DECODER_BN_SCOPES["conv_3x3_2"], 3, d, d)
        slim(DECODER_LOGITS_SCOPE, 1, d, 1, bn=False)
    return t


def main(argv=None):
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.convert import (model_state_from_jax, npz_arrays,
                                           params_from_jax)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--model", default="CMPC_model")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt_dir", default=None,
                    help="also write step 0 of a port TrainState checkpoint "
                         "here (with the BN moving statistics)")
    args = ap.parse_args(argv)
    cfg = get_config(args.model)
    params, state = convert_numpy(checkpoint_getter(args.ckpt), cfg)
    arrays = npz_arrays(params)
    np.savez(args.out, **arrays)
    print(f"wrote {args.out} ({len(arrays)} tensors)")
    if args.ckpt_dir:
        save_train_state(args.ckpt_dir, cfg,
                         params_from_jax(params, cfg, device="cpu"),
                         model_state_from_jax(state, device="cpu"))
        print(f"wrote step 0 of {args.model} under {args.ckpt_dir}")


if __name__ == "__main__":
    main()
