"""The benchmark's seeded weights: the program's parameter tree (its
layout and names: backbone units {'w' OIHW, 'scale', 'offset'}, head
convs {'DW' HWIO, 'biases'}, layer norms, the LSTM, the ConvLSTM) drawn
from one seed on the device in one call.

Scales follow the model's init: Xavier / Glorot uniform kernels, the
embedding at std 0.01 (uniform of the same variance), biases and BN
offsets 0, BN scales and layer-norm gammas 1.  One uniform draw of every
drawn leaf's length together, `torch.Generator(device).manual_seed(seed)`,
is cut into the leaves, so the same seed on the same device gives the same
weights in every process.  Both the program and the reference get these
tensors; neither derives them from the other.
"""

from __future__ import annotations

import math

import torch

from reference.model import resnet_stages

LATERAL_IN = {"c3": 512, "c4": 1024, "c5": 2048}


def _conv(k, cin, cout):
    fan = k * k * (cin + cout)
    return {"DW": ("u", (k, k, cin, cout), math.sqrt(6.0 / fan)),
            "biases": ("zeros", (cout,))}


def _glorot(shape):
    fan_in = math.prod(shape[:-1])
    return ("u", shape, math.sqrt(6.0 / (fan_in + shape[-1])))


def _ln(c):
    return {"gamma": ("ones", (c,)), "beta": ("zeros", (c,))}


def _unit(k, cin, cout):
    bound = math.sqrt(6.0 / (k * k * (cin + cout)))
    return {"w": ("u", (cout, cin, k, k), bound),
            "scale": ("ones", (cout,)), "offset": ("zeros", (cout,))}


def _backbone(res4_blocks):
    tree = {"conv1": _unit(7, 3, 64)}
    cin = 64
    for stage, blocks, mid, cout, _, _ in resnet_stages(res4_blocks):
        for bi, b in enumerate(blocks):
            bp = {}
            if bi == 0:
                bp["branch1"] = _unit(1, cin, cout)
            bp["branch2a"] = _unit(1, cin if bi == 0 else cout, mid)
            bp["branch2b"] = _unit(3, mid, mid)
            bp["branch2c"] = _unit(1, mid, cout)
            tree[f"{stage}{b}"] = bp
        cin = cout
    return tree


def _mutan(m):
    c = m["v_emb_dim"]
    return {"vis_trans": _conv(1, c + 8, 5 * c),
            "lang_trans": _conv(1, m["rnn_size"], 5 * c)}


def _gconv(c):
    return {"update": _conv(1, c, c), "feat_ln": _ln(c), "update_ln": _ln(c)}


def _graph(m):
    c, cl = m["v_emb_dim"], m["rnn_size"]
    return {"words_trans": _conv(1, cl, c), "spa_graph_trans2": _conv(1, c, c),
            "gconv": [_gconv(c)]}


def _exchange(m, others):
    cm, cl = m["mlp_dim"], m["rnn_size"]
    return {"se": [{"lang_feat": _conv(1, cm, cm), "trans_feat":
                    _conv(1, cm, cm)} for _ in range(others)],
            "gv": {"spa_graph_key": _conv(1, cm, cm),
                   "lang_query": _conv(1, cl, cm),
                   "gv_lang": _conv(1, cm + cl, cm)}}


def skeleton(m: dict) -> dict:
    """The parameter tree of model dims `m` (a configuration file's
    'model'), each leaf (kind, shape[, bound])."""
    c, cm, cl = m["v_emb_dim"], m["mlp_dim"], m["rnn_size"]
    h, w = m["H"] // 8, m["W"] // 8
    levels = list(m["levels"])
    tree = {
        "backbone": _backbone(m["res4_blocks"]),
        "text": {"embedding": ("u", (m["vocab_size"], m["glove_dim"]),
                               0.01 * math.sqrt(3.0)),
                 "lstm": {"kernel": _glorot((m["glove_dim"] + cl, 4 * cl)),
                          "bias": ("zeros", (4 * cl,))}},
        "parser": {"words_parse_1": _conv(1, cl, 500),
                   "words_parse_2": _conv(1, 500, m["parse_classes"])},
        "levels": {},
        "fusion_stack": {
            "exchange": {f"{lv}{r}": _exchange(m, len(levels) - 1)
                         for r in ("", "_2") for lv in levels},
            "convlstm": {"kernel": _glorot((1, 1, 2 * cm, 4 * cm)),
                         "W_ci": _glorot((h, w, cm)),
                         "W_cf": _glorot((h, w, cm)),
                         "W_co": _glorot((h, w, cm)),
                         "ln": [_ln(cm) for _ in range(5)]}},
        "laterals": {lv: _conv(1, LATERAL_IN[lv], c) for lv in levels},
        "scores": {f"score_{lv}": _conv(3, cm, 1) for lv in levels},
    }
    for lv in levels:
        if m["video"]:
            tree["levels"][lv] = {
                "mutan": _mutan(m), "tg_vtrans": _conv(1, c, c),
                "tg_ltrans": _conv(1, cl, cl), "tg_query": _conv(1, c, c),
                "tg_key": _conv(1, c, c), "tg_gconv": _gconv(c),
                "mm_trans": _conv(1, c, c), "ctx_trans": _conv(1, c, c),
                "graph": _graph(m),
                "fusion": _conv(1, 3 * c + cl + 8, cm)}
        else:
            tree["levels"][lv] = {"mutan": _mutan(m), "graph": _graph(m),
                                  "fusion": _conv(1, 2 * c + cl + 8, cm)}
    tree["scores"]["score"] = _conv(3, cm, 1)
    return tree


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn) for v in tree]
    return fn(tree)


def _specs(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _specs(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _specs(v, out)
    else:
        out.append(tree)
    return out


def make_params(m: dict, seed: int, device) -> dict:
    """The float32 parameter tree of model dims `m` from `seed` on
    `device`: one uniform draw in [-1, 1) for all drawn leaves, cut in
    tree order and scaled by each leaf's bound."""
    tree = skeleton(m)
    drawn = [s for s in _specs(tree, []) if s[0] == "u"]
    total = sum(math.prod(s[1]) for s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    pos = [0]

    def leaf(spec):
        kind, shape = spec[0], spec[1]
        if kind == "ones":
            return torch.ones(shape, device=device)
        if kind == "zeros":
            return torch.zeros(shape, device=device)
        n = math.prod(shape)
        t = flat[pos[0]:pos[0] + n].view(shape) * spec[2]
        pos[0] += n
        return t
    return _walk(tree, leaf)


def meta_params(m: dict) -> dict:
    """The same tree as meta tensors (shapes only), for counting FLOPs."""
    return _walk(skeleton(m),
                 lambda s: torch.empty(s[1], device="meta"))
