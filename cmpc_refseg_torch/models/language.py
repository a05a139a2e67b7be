"""Language encoders: GloVe embedding + LSTM / BiLSTM, or BERT features.

The fork's 'lstm' encoder (CMPC_model.py:144-164): a trainable embedding,
an LSTM over back-padded tokens with the true `seq_len`, outputs zeroed and
state frozen past it, l2-normalized word features, the sentence feature as
the sum of word features and the sequence mask from the zero rows.

The origin-style 'lstm_frontpad' encoder (CMPC_model_origin.py:130-141)
takes front-padded tokens with `valid_idx`, the number of pads: they are
rolled to the back-padded form and run through the same LSTM; its sentence
feature is the l2-normalized final hidden state.

The 'bilstm' encoder (CMPCv4_BiLSTM_T_model.py:158-185,
CMPCv5_BiLSTM_model.py:160-190): `bidirectional_dynamic_rnn` (the backward
LSTM runs over each sample's valid prefix reversed) and a 1x1 conv merge of
the fw/bw concat, with the sub-variants' flags `bilstm_words_source`,
`bilstm_tanh` and `bilstm_mask_pre_merge`.

The 'bert' encoder (CMPCv4_BERT_model.py:80-106) has no parameters: the
batch carries precomputed features [B, T, 768] and their mask.

TF's LSTMCell gate order is (i, j, f, o) with forget_bias=1.0 added to f
before the sigmoid; ``nn.LSTM`` orders (i, f, g, o) with no forget bias, so
the cell is written out as a Python loop over T.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_refseg_torch.ops.layers import (conv2d, glorot_uniform, init_conv,
                                          normal_init, split_stream)
from cmpc_refseg_torch.ops.normalization import l2_normalize


class TextFeatures(NamedTuple):
    words_feat: torch.Tensor   # [B, 1, T, C] word features fed downstream
    lang_feat: torch.Tensor    # [B, 1, 1, C] sentence feature
    seq_mask: torch.Tensor     # [B, 1, T, 1] 1.0 at valid words
    parse_feat: torch.Tensor   # [B, 1, T, C] features the parser runs on


def init_lstm_cell(key, input_dim: int, hidden: int) -> dict:
    """TF LSTMCell params: kernel [input+hidden, 4*hidden] (i|j|f|o), bias 0."""
    return {
        "kernel": glorot_uniform(key, (input_dim + hidden, 4 * hidden)),
        "bias": np.zeros((4 * hidden,), np.float32),
    }


ENCODERS = ("lstm", "lstm_frontpad", "bilstm", "bert")


def _check_encoder(cfg) -> None:
    if cfg.text_encoder not in ENCODERS:
        raise ValueError(f"unknown text encoder {cfg.text_encoder!r}")


def init_text_encoder(key, cfg, glove=None) -> dict:
    """Numpy params of the configured text encoder, draw for draw the JAX
    package's (the stream is split 4 ways there too).  `glove` [vocab_size,
    glove_dim] initializes the trainable embedding (CMPC_model.py:79-81);
    without it the embedding is drawn from k1.  'bert' has no parameters."""
    _check_encoder(cfg)
    k1, k2, k3, k4 = split_stream(key, 4)
    if cfg.text_encoder == "bert":
        return {}
    if glove is None:
        glove = normal_init(k1, (cfg.vocab_size, cfg.glove_dim))
    params = {"embedding": np.asarray(glove, np.float32)}
    if cfg.text_encoder == "bilstm":
        params["lstm_fw"] = init_lstm_cell(k2, cfg.glove_dim, cfg.rnn_size)
        params["lstm_bw"] = init_lstm_cell(k3, cfg.glove_dim, cfg.rnn_size)
        params["words_feat"] = init_conv(k4, 1, 2 * cfg.rnn_size,
                                         cfg.rnn_size)
    else:
        params["lstm"] = init_lstm_cell(k2, cfg.glove_dim, cfg.rnn_size)
    return params


def _reverse_index(seq_len, t: int, device):
    """`tf.reverse_sequence` of each sample's valid prefix as gather
    indices [B, T]: index j reads seq_len-1-j for j < seq_len, j past it.
    The map is its own inverse."""
    pos = torch.arange(t, device=device)[None]
    n = seq_len.long()[:, None]
    return torch.where(pos < n, n - 1 - pos, pos)


def lstm_scan(cell_params: dict, inputs, seq_len, *, reverse: bool = False):
    """LSTM over [B, T, D] inputs, `dynamic_rnn` semantics (forget bias 1.0).
    The input projection is one [B*T, D] x [D, 4H] product hoisted out of
    the loop.  With `reverse`, the backward pass of
    `bidirectional_dynamic_rnn`: the valid prefix of each sample is
    reversed (`_reverse_index`), scanned, and the outputs reversed back."""
    b, t, d = inputs.shape
    if reverse:
        idx = _reverse_index(seq_len, t, inputs.device)
        inputs = torch.gather(inputs, 1, idx[:, :, None].expand(b, t, d))
    kernel = cell_params["kernel"]
    hidden = kernel.shape[1] // 4
    k_x, k_h = kernel[:d], kernel[d:]
    gx = (inputs.reshape(b * t, d) @ k_x).reshape(b, t, -1) \
        + cell_params["bias"]
    c = inputs.new_zeros((b, hidden))
    h = inputs.new_zeros((b, hidden))
    outs = []
    for step in range(t):
        gates = h @ k_h + gx[:, step]
        i, j, f, o = torch.split(gates, hidden, dim=-1)
        new_c = (torch.sigmoid(f + 1.0) * c
                 + torch.sigmoid(i) * torch.tanh(j))
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        valid = (step < seq_len).to(new_h.dtype)[:, None]
        c = valid * new_c + (1 - valid) * c
        h = valid * new_h + (1 - valid) * h
        outs.append(valid * new_h)
    outs = torch.stack(outs, dim=1)
    if reverse:
        outs = torch.gather(outs, 1, idx[:, :, None].expand(b, t, hidden))
    return outs, h


def normalize_tokens(words, seq_len=None, valid_idx=None):
    """(back-padded tokens [B, T], lengths [B]).  Back-padded input with
    `seq_len` passes as it is; front-padded input (pads first, `valid_idx`
    [B] or [B, 1] = the number of pads) is rolled to the back-padded form:
    position p reads token min(p + valid_idx, T - 1), length T - valid_idx."""
    if seq_len is not None:
        return words, seq_len
    if valid_idx is None:
        raise ValueError("need seq_len (back-pad) or valid_idx (front-pad)")
    t = words.shape[1]
    valid_idx = valid_idx.reshape(-1).long()
    pos = torch.arange(t, device=words.device)[None]
    src = torch.clamp(pos + valid_idx[:, None], max=t - 1)
    return torch.gather(words, 1, src), t - valid_idx


def encode_text(params: dict, cfg, words=None, seq_len=None, *,
                valid_idx=None, words_feat=None,
                sequence_mask=None) -> TextFeatures:
    """Encode tokens [B, T] into TextFeatures: back-padded with lengths
    `seq_len` [B], or front-padded with `valid_idx` (`normalize_tokens`);
    for 'bert', the features `words_feat` [B, T, C] and their
    `sequence_mask` [B, T] instead of tokens."""
    _check_encoder(cfg)
    if cfg.text_encoder == "bert":
        # CMPCv4_BERT_model.py:80-106: the features fed as they are, masked
        mask = sequence_mask.to(words_feat.dtype)
        wf = (l2_normalize(words_feat, -1) * mask[:, :, None])[:, None]
        lang = torch.sum(wf, dim=-2, keepdim=True)             # [B,1,1,C]
        return TextFeatures(wf, lang, mask[:, None, :, None].float(), wf)
    words, seq_len = normalize_tokens(words, seq_len, valid_idx)
    emb = params["embedding"][words.long()]                # [B,T,glove]
    if cfg.text_encoder == "bilstm":
        return _encode_bilstm(params, cfg, emb, seq_len)
    outs, final_h = lstm_scan(params["lstm"], emb, seq_len)
    wf = l2_normalize(outs, -1)[:, None]                   # [B,1,T,C]
    if cfg.text_encoder == "lstm":
        lang = torch.sum(wf, dim=-2, keepdim=True)         # CMPC_model.py:161
    else:   # the final hidden state (CMPC_model_origin.py:140-141)
        lang = l2_normalize(final_h, -1)[:, None, None]
    return TextFeatures(wf, lang, _nonzero_rows(wf), wf)


def _nonzero_rows(x):
    """1.0 at the rows [..., T, 1] of `x` with a nonzero entry
    (CMPC_model.py:163)."""
    return (torch.sum(torch.abs(x), -1, keepdim=True) != 0).float()


def _encode_bilstm(params, cfg, emb, seq_len) -> TextFeatures:
    """fw and bw LSTMs, the 1x1 merge conv of their concat (tanh before the
    l2-norm with `bilstm_tanh`); the mask from the raw concat
    (`bilstm_mask_pre_merge`) or from the merged features, whose pad rows
    are zero only while the merge bias is (T/T2,
    CMPCv4_BiLSTM_T_model.py:183, reproduced as it is).  Word features
    downstream: the l2-normalized fw outputs for T/T2, the merged ones for
    v5; the parser always reads the merged ones."""
    fw, _ = lstm_scan(params["lstm_fw"], emb, seq_len)
    bw, _ = lstm_scan(params["lstm_bw"], emb, seq_len, reverse=True)
    cat = torch.cat([fw, bw], dim=-1)[:, None]             # [B,1,T,2C]
    merged = conv2d(params["words_feat"], cat)
    if cfg.bilstm_tanh:
        merged = torch.tanh(merged)        # CMPCv5_BiLSTM_model.py:183
    merged = l2_normalize(merged, -1)
    mask = _nonzero_rows(cat if cfg.bilstm_mask_pre_merge else merged)
    wf = l2_normalize(fw, -1)[:, None] if cfg.bilstm_words_source == "fw" \
        else merged
    lang = torch.sum(wf, dim=-2, keepdim=True)
    return TextFeatures(wf, lang, mask, merged)
