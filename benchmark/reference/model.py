"""Plain PyTorch reference of the benchmarked CMPC models, in float32.

A frozen copy of the arithmetic of cmpc_refseg_torch's plain route (its
``use_kernels=False`` forward and loss), written with nothing but torch:
the DeepLab ResNet-101 backbone with folded BatchNorm, the LSTM text
encoder (back-padded or front-padded tokens), the word parser, mutan
fusion, the relation-aware spatial graph ('masked' norm), the gated
exchange and the ConvLSTM fusion, the multiscore decoder, TF1 bilinear
resizes, and for the video model the temporal graph and context.  It
imports nothing of the program and takes the raw parameter tree of
`weights.make_params`: it folds, pads and stacks nothing that the program
prepared.

Every product (matmul, einsum, convolution) goes through an `Ops` object.
`Ops()` computes in float32 with TF32 off; `Ops("fp8")` rounds both
operands of every product to float8 e4m3 (a per-tensor scale to its
range), and in a backward pass the cotangents too, with float32
accumulation: the lower-precision control of the comparison that decides
`correct`; `Ops("bfloat16")` rounds them to bf16, the configurations'
precision, which scales that comparison.

Layouts follow the program's parameters: backbone kernels OIHW, head
kernels HWIO ({'DW', 'biases'}), activations NHWC.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)
FP8_MAX = 448.0
LN_EPS = 1e-12


def _fp8_round(x):
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(x.dtype)


def _bf16_round(x):
    return x.to(torch.bfloat16).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Rounds to fp8 forward, and the cotangent to fp8 backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


ROUND = {"fp8": _Fp8.apply, "bfloat16": _bf16_round}


class Ops:
    """The products of the reference in one precision: 'float32' (TF32
    off), 'bfloat16' (operands rounded to bf16: the reference's own error
    at the configurations' precision, the scale of `check`'s
    `sigm_err_scaled`) or 'fp8' (operands rounded to e4m3, f32
    accumulation)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", *ROUND):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def q(self, x):
        fn = ROUND.get(self.precision)
        return x if fn is None or x.device.type == "meta" else fn(x)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def conv(self, x, w, *, stride=1, dilation=1):
        """TF SAME conv of NCHW x with an OIHW kernel."""
        kh, kw = w.shape[2], w.shape[3]
        ph = same_pads(x.shape[2], kh, stride, dilation)
        pw = same_pads(x.shape[3], kw, stride, dilation)
        x = F.pad(self.q(x), (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.q(w), stride=stride, dilation=dilation)


class tf32_off:
    """Context: float32 products without TF32 (restored on exit)."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def same_pads(size, k, stride, dilation=1):
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def l2n(x, dim=-1):
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=1e-12))


def layer_norm(x, gamma, beta):
    """Whole-sample layer norm (every axis but the first), gamma and beta
    over the last axis."""
    dims = tuple(range(1, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * gamma + beta


def dense(ops, p, x):
    """1x1 conv of NHWC-like x [..., Cin] with HWIO DW [1, 1, Cin, Cout]."""
    return ops.mm(x, p["DW"][0, 0]) + p["biases"]


def conv3(ops, p, x):
    """SAME 3x3 conv of NHWC x with HWIO DW, plus bias."""
    y = ops.conv(x.permute(0, 3, 1, 2), p["DW"].permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1) + p["biases"]


def _interp(in_size, out_size, device):
    """TF1 legacy bilinear interpolation matrix [out, in]."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
    else:
        src = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
        t = (src - lo).astype(np.float32)
        m[np.arange(out_size), lo] += 1.0 - t
        m[np.arange(out_size), hi] += t
    return torch.as_tensor(m, device=device)


def resize(x, out_h, out_w):
    """TF1 `resize_bilinear` of NHWC x (a linear map: exact in f32)."""
    mh = _interp(x.shape[1], out_h, x.device)
    mw = _interp(x.shape[2], out_w, x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)


def spatial_grid(h, w, device):
    ws, hs = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    xmin, xmax = ws / w * 2 - 1, (ws + 1) / w * 2 - 1
    ymin, ymax = hs / h * 2 - 1, (hs + 1) / h * 2 - 1
    g = np.zeros((h, w, 8), np.float32)
    g[:, :, 0], g[:, :, 2], g[:, :, 4] = xmin, xmax, (xmin + xmax) / 2
    g[:, :, 1] = ymin[:, None]
    g[:, :, 3] = ymax[:, None]
    g[:, :, 5] = ((ymin + ymax) / 2)[:, None]
    g[:, :, 6], g[:, :, 7] = 1.0 / w, 1.0 / h
    return torch.as_tensor(g, device=device)


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------

def resnet_stages(res4_blocks):
    return (("res2", ("a", "b", "c"), 64, 256, 1, 1),
            ("res3", ("a", "b1", "b2", "b3"), 128, 512, 2, 1),
            ("res4", ("a",) + tuple(f"b{i}" for i in range(1, res4_blocks)),
             256, 1024, 1, 2),
            ("res5", ("a", "b", "c"), 512, 2048, 1, 4))


def backbone(ops, params, im, res4_blocks, levels):
    """Mean-subtracted BGR images [B, H, W, 3] -> {level: NHWC tap}."""
    def unit(u, x, stride=1, dilation=1, relu=True):
        y = ops.conv(x, u["w"], stride=stride, dilation=dilation)
        y = y * u["scale"].view(1, -1, 1, 1) + u["offset"].view(1, -1, 1, 1)
        return torch.relu(y) if relu else y

    x = unit(params["conv1"], im.permute(0, 3, 1, 2), stride=2)
    ph, pw = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                           value=float("-inf")), 3, 2)
    taps = {}
    for stage, blocks, _, _, stride, dilation in resnet_stages(res4_blocks):
        for bi, b in enumerate(blocks):
            bp = params[f"{stage}{b}"]
            s = stride if bi == 0 else 1
            short = unit(bp["branch1"], x, stride=s, relu=False) \
                if bi == 0 else x
            y = unit(bp["branch2a"], x, stride=s)
            y = unit(bp["branch2b"], y, dilation=dilation)
            y = unit(bp["branch2c"], y, relu=False)
            x = torch.relu(short + y)
        level = {"res3": "c3", "res4": "c4", "res5": "c5"}.get(stage)
        if level in levels:
            taps[level] = x.permute(0, 2, 3, 1)
    return taps


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def back_padded(words, seq_len=None, valid_idx=None):
    """(tokens back-padded, lengths): front-padded tokens with `valid_idx`
    pads are rolled to the back."""
    if seq_len is not None:
        return words, seq_len
    t = words.shape[1]
    valid_idx = valid_idx.reshape(-1).long()
    pos = torch.arange(t, device=words.device)[None]
    src = torch.clamp(pos + valid_idx[:, None], max=t - 1)
    return torch.gather(words, 1, src), t - valid_idx


def encode_text(ops, p, model, words, seq_len=None, valid_idx=None):
    """-> (words_feat [B,1,T,C], lang [B,1,1,C], seq_mask [B,1,T,1])."""
    words, seq_len = back_padded(words, seq_len, valid_idx)
    emb = p["embedding"][words.long()]
    b, t, d = emb.shape
    kernel, bias = p["lstm"]["kernel"], p["lstm"]["bias"]
    hid = kernel.shape[1] // 4
    gx = ops.mm(emb.reshape(b * t, d), kernel[:d]).reshape(b, t, -1) + bias
    c = emb.new_zeros((b, hid))
    h = emb.new_zeros((b, hid))
    outs = []
    for step in range(t):
        i, j, f, o = torch.split(ops.mm(h, kernel[d:]) + gx[:, step], hid, -1)
        new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        valid = (step < seq_len).to(new_h.dtype)[:, None]
        c = valid * new_c + (1 - valid) * c
        h = valid * new_h + (1 - valid) * h
        outs.append(valid * new_h)
    wf = l2n(torch.stack(outs, dim=1))[:, None]
    if model["text_encoder"] == "lstm":
        lang = wf.sum(dim=-2, keepdim=True)
    else:      # 'lstm_frontpad': the final hidden state
        lang = l2n(h)[:, None, None]
    mask = (wf.abs().sum(-1, keepdim=True) != 0).to(wf.dtype)
    return wf, lang, mask


def parse_words(ops, p, wf, mask):
    x = torch.relu(dense(ops, p["words_parse_1"], wf))
    return torch.softmax(dense(ops, p["words_parse_2"], x), dim=-1) * mask


def lang_vec(parse, wf, classes):
    """l2n of the word sum weighted by the given parse classes [B,1,1,C]."""
    w = sum(parse[:, 0, :, c] for c in classes)
    return l2n(torch.einsum("bt,btc->bc", w, wf[:, 0]))[:, None, None]


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------

def mutan(ops, p, lang, spatial, vis, heads=5):
    """l2n(tanh(sum_h tanh([vis, spatial] W_h + b_h) * tanh(lang W'_h +
    b'_h))); vis [B, R, W, C] with one language row per sample."""
    b, r, w, c = vis.shape
    x = torch.cat([vis, spatial], dim=-1)
    lt = torch.tanh(dense(ops, p["lang_trans"], lang)).reshape(b, 1, 1,
                                                               heads, c)
    v = torch.tanh(dense(ops, p["vis_trans"], x)).reshape(b, r, w, heads, c)
    return l2n(torch.tanh((v * lt).sum(dim=3)))


def graph_conv(ops, gp, x, w_aff, v_aff):
    pooled = ops.mm(v_aff.transpose(1, 2), x)
    msg = layer_norm(ops.mm(w_aff, pooled), gp["feat_ln"]["gamma"],
                     gp["feat_ln"]["beta"])
    y = dense(ops, gp["update"], torch.relu(x + msg))
    return torch.relu(layer_norm(y, gp["update_ln"]["gamma"],
                                 gp["update_ln"]["beta"]))


def spatial_graph(ops, p, model, x4, wf, parse, mask):
    """The 'masked' spatial graph of one level: x4 [B, h, w, C]."""
    b, h, w, c = x4.shape
    x = x4.reshape(b, h * w, c)
    wt = dense(ops, p["words_trans"], wf)[:, 0]                 # [B,T,A]
    gt = dense(ops, p["spa_graph_trans2"], x)                   # [B,N,A]
    affi = ops.mm(gt, wt.transpose(1, 2)) / math.sqrt(model["v_emb_dim"])
    rel = parse[:, :, :, 2]                                     # [B,1,T]
    m = mask[:, :, :, 0]
    affi = rel * affi
    w_aff = torch.softmax(m * affi + (1.0 - m) * torch.finfo(
        torch.float32).min, dim=2)
    v_aff = m * torch.softmax(affi, dim=1)
    for gp in p["gconv"]:
        x = graph_conv(ops, gp, x, w_aff, v_aff)
    return l2n(x.reshape(b, h, w, c))


def fuse(ops, p, parts):
    """relu(concat(parts) @ W + b), the [B,1,1,C] parts broadcast."""
    shape = parts[0].shape[:-1]
    x = torch.cat([q.expand(*shape, q.shape[-1]) for q in parts], dim=-1)
    return torch.relu(dense(ops, p, x))


def global_vec(ops, p, feat, lang, cm):
    b, h, w, c = feat.shape
    key = dense(ops, p["spa_graph_key"], feat).reshape(b, h * w, cm)
    query = dense(ops, p["lang_query"], lang).reshape(b, 1, cm)
    attn = torch.softmax(ops.mm(key, query.transpose(1, 2)) / math.sqrt(cm),
                         dim=1)
    pooled = ops.mm(attn.transpose(1, 2), feat.reshape(b, h * w, c))
    gv = dense(ops, p["gv_lang"], torch.cat([pooled.reshape(b, 1, 1, c),
                                             lang], dim=-1))
    return l2n(gv, dim=(1, 2, 3))


def exchange(ops, p, feat, others, lang, cm):
    gv = global_vec(ops, p["gv"], feat, lang, cm)
    out = feat
    for se, other in zip(p["se"], others):
        gate = torch.sigmoid(dense(ops, se["lang_feat"], gv))
        out = out + torch.relu(dense(ops, se["trans_feat"], other)) * gate
    return l2n(out)


def convlstm_step(ops, p, x, c, h):
    b, hh, ww, cc = x.shape
    y = ops.mm(torch.cat([x, h], dim=-1), p["kernel"][0, 0])
    j, i, f, o = torch.split(y, cc, dim=-1)
    i = i + p["W_ci"] * c
    f = f + p["W_cf"] * c
    ln = p["ln"]

    def norm(v, k):
        return layer_norm(v, ln[k]["gamma"], ln[k]["beta"])
    new_c = c * torch.sigmoid(norm(f, 2) + 1.0) \
        + torch.sigmoid(norm(i, 1)) * torch.tanh(norm(j, 0))
    o = o + p["W_co"] * new_c
    new_c = norm(new_c, 4)
    return new_c, torch.sigmoid(norm(o, 3)) * torch.tanh(new_c)


def fusion_stack(ops, p, model, feats, lang):
    levels = list(model["levels"])
    cm = model["mlp_dim"]
    cur = dict(feats)
    for rnd in ("", "_2"):
        cur = {lv: exchange(ops, p["exchange"][f"{lv}{rnd}"], cur[lv],
                            [cur[o] for o in levels if o != lv], lang, cm)
               for lv in levels}
    c = torch.zeros_like(cur[levels[0]])
    h = torch.zeros_like(c)
    for lv in levels:
        c, h = convlstm_step(ops, p["convlstm"], cur[lv], c, h)
    return h


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def forward(ops, params, model, batch):
    """The model's forward on a batch the harness made: image models take
    'im' [B,H,W,3] f32 BGR - mean; the video model 'frames' [B,F,H,W,3].
    Tokens: 'words' with 'seq_len' or 'valid_idx'.  Returns a dict with
    'up' (full-resolution logits [B,H,W,1]), 'up_levels' and 'sigm'."""
    return head(ops, params, model, batch,
                backbone_taps(ops, params, model, batch))


def backbone_images(model, batch):
    """The images the backbone sees: 'im', or the clips' frames folded
    into the batch."""
    if model["video"]:
        fr = batch["frames"]
        return fr.reshape(fr.shape[0] * fr.shape[1], *fr.shape[2:])
    return batch["im"]


def backbone_taps(ops, params, model, batch, block=None):
    """The backbone's taps of the batch, `block` images at a time."""
    ims = backbone_images(model, batch)
    block = block or ims.shape[0]
    parts = [backbone(ops, params["backbone"], ims[i:i + block],
                      model["res4_blocks"], tuple(model["levels"]))
             for i in range(0, ims.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def forward_frozen_backbone(ops, params, model, batch, block):
    """`forward` with the backbone outside autograd (it is frozen in
    training), `block` images at a time."""
    with torch.no_grad():
        vis = backbone_taps(ops, params, model, batch, block)
    return head(ops, params, model, batch, vis)


# the options of the configurations this reference follows; any other
# value is refused rather than computed as something else
SUPPORTED = {"graph_norm": ("masked",), "decoder": ("multiscore",),
             "text_encoder": ("lstm", "lstm_frontpad"), "hsv": (False,),
             "tanh_lateral": (False,), "exchange_self_gate": (False,),
             "sent_fusion": (False,), "l2norm_affinity": (False,),
             "bbox_head": (False,), "vw_emb_dim": (None,),
             "num_graph_conv": (1,), "conv5": (False,), "is_aug": (False,),
             "grad_accum": (1,), "optimizer": ("adam",)}


def check_supported(model):
    for key, values in SUPPORTED.items():
        if model[key] not in values:
            raise ValueError(f"the reference does not follow {key} = "
                             f"{model[key]!r}")


def head(ops, params, model, batch, vis):
    """Everything after the backbone, from its taps `vis`."""
    check_supported(model)
    if model["video"]:
        return _head_video(ops, params, model, batch, vis)
    im = batch["im"]
    b = im.shape[0]
    levels = tuple(model["levels"])
    wf, _, mask = encode_text(ops, params["text"], model, batch["words"],
                              batch.get("seq_len"), batch.get("valid_idx"))
    parse = parse_words(ops, params["parser"], wf, mask)
    h, w = im.shape[1] // 8, im.shape[2] // 8
    spatial = spatial_grid(h, w, im.device)[None].expand(b, h, w, 8)
    valid = lang_vec(parse, wf, (0, 1))
    fusions, up_levels = {}, {}
    for lv in levels:
        p = params["levels"][lv]
        lat = l2n(dense(ops, params["laterals"][lv], vis[lv]))
        mm = mutan(ops, p["mutan"], valid, spatial, lat)
        g = spatial_graph(ops, p["graph"], model, mm, wf, parse, mask)
        fusions[lv] = fuse(ops, p["fusion"], [mm, g, valid, spatial])
        up_levels[lv] = resize(conv3(ops, params["scores"][f"score_{lv}"],
                                     fusions[lv]), model["H"], model["W"])
    nec = lang_vec(parse, wf, tuple(range(model["parse_classes"] - 1)))
    fused = fusion_stack(ops, params["fusion_stack"], model, fusions, nec)
    up = resize(conv3(ops, params["scores"]["score"], fused), model["H"],
                model["W"])
    return {"up": up, "up_levels": up_levels, "sigm": torch.sigmoid(up)}


def _temp_graph(ops, p, mm_bf, ac, b, f):
    bf, h, w, c = mm_bf.shape
    vt = dense(ops, p["tg_vtrans"], mm_bf).reshape(b, f * h * w, c)
    lt = dense(ops, p["tg_ltrans"], ac).reshape(b, -1, 1)
    attn = torch.softmax(ops.mm(vt, lt).reshape(b * f, 1, h * w)
                         / math.sqrt(c), dim=2)
    fv = ops.mm(attn, mm_bf.reshape(b * f, h * w, c)).reshape(b, f, c)
    q = dense(ops, p["tg_query"], fv)
    k = dense(ops, p["tg_key"], fv)
    adj = torch.softmax(ops.mm(q, k.transpose(1, 2)) / math.sqrt(c), dim=2)
    gp = p["tg_gconv"]
    msg = layer_norm(ops.mm(adj, fv), gp["feat_ln"]["gamma"],
                     gp["feat_ln"]["beta"])
    y = dense(ops, gp["update"], torch.relu(fv + msg))
    y = torch.relu(layer_norm(y, gp["update_ln"]["gamma"],
                              gp["update_ln"]["beta"]))
    return l2n(y)


def _temp_ctx(ops, p, center_mm, fv):
    b, h, w, c = center_mm.shape
    mt = dense(ops, p["mm_trans"], center_mm).reshape(b, h * w, c)
    ct = dense(ops, p["ctx_trans"], fv)
    attn = torch.softmax(ops.mm(mt, ct.transpose(1, 2)) / math.sqrt(c),
                         dim=2)
    return l2n(ops.mm(attn, fv).reshape(b, h, w, c))


def _head_video(ops, params, model, batch, vis):
    frames = batch["frames"]
    b, f = frames.shape[:2]
    levels = tuple(model["levels"])
    wf, _, mask = encode_text(ops, params["text"], model, batch["words"],
                              batch.get("seq_len"), batch.get("valid_idx"))
    parse = parse_words(ops, params["parser"], wf, mask)
    ea = lang_vec(parse, wf, (0, 1))
    ac = lang_vec(parse, wf, (3,))
    valid = lang_vec(parse, wf, (0, 1, 2, 3))
    h, w = frames.shape[2] // 8, frames.shape[3] // 8
    grid = spatial_grid(h, w, frames.device)
    spatial = grid[None].expand(b, h, w, 8)
    center = f // 2
    fusions, up_levels = {}, {}
    for lv in levels:
        p = params["levels"][lv]
        lat = l2n(dense(ops, params["laterals"][lv], vis[lv]))
        c = lat.shape[-1]
        mm = mutan(ops, p["mutan"], ea,
                   grid.repeat(f, 1, 1)[None].expand(b, f * h, w, 8),
                   lat.reshape(b, f * h, w, c))
        mm_bf = mm.reshape(b * f, h, w, c)
        fv = _temp_graph(ops, p, mm_bf, ac, b, f)
        center_mm = mm_bf.reshape(b, f, h, w, c)[:, center]
        ctx = _temp_ctx(ops, p, center_mm, fv)
        g = spatial_graph(ops, p["graph"], model, center_mm, wf, parse, mask)
        fusions[lv] = fuse(ops, p["fusion"],
                           [lat.reshape(b, f, h, w, c)[:, center], g, ctx,
                            valid, spatial])
        up_levels[lv] = resize(conv3(ops, params["scores"][f"score_{lv}"],
                                     fusions[lv]), model["H"], model["W"])
    fused = fusion_stack(ops, params["fusion_stack"], model, fusions, valid)
    up = resize(conv3(ops, params["scores"]["score"], fused), model["H"],
                model["W"])
    return {"up": up, "up_levels": up_levels, "sigm": torch.sigmoid(up)}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def logistic_loss(scores, labels):
    per = (torch.clamp(scores, min=0.0) - scores * labels
           + torch.log1p(torch.exp(-scores.abs())))
    return per.sum(dim=(1, 2, 3)).mean()


def _leaves(tree, key, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == key:
                out.append(v)
            else:
                _leaves(v, key, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, key, out)
    return out


def loss(outputs, target, model, head):
    """The weighed logistic loss of the full-resolution and per-level
    logits (weights main, c5, c4, c3) plus wd * sum 0.5 ||DW||^2 over the
    head's kernels `head` (the trainable tree)."""
    w = model["loss_weights"]
    total = w[0] * logistic_loss(outputs["up"], target)
    order = [lv for lv in ("c5", "c4", "c3") if lv in model["levels"]]
    for wgt, lv in zip(w[1:], order):
        total = total + wgt * logistic_loss(outputs["up_levels"][lv], target)
    reg = sum(0.5 * torch.sum(d * d) for d in _leaves(head, "DW", []))
    return total + model["weight_decay"] * reg


def image_of_u8(x_u8):
    """uint8 RGB [..., 3] -> f32 BGR - mean."""
    mean = torch.tensor(IMAGE_MEAN_BGR, dtype=torch.float32,
                        device=x_u8.device)
    return x_u8.float().flip(-1) - mean


def poly_lr(model, step):
    frac = min(float(step), model["lr_decay_step"]) / model["lr_decay_step"]
    return ((model["start_lr"] - model["end_lr"])
            * (1.0 - frac) ** model["lr_power"] + model["end_lr"])
