"""Language encoder: GloVe embedding + LSTM with `dynamic_rnn` semantics.

The fork's 'lstm' encoder (CMPC_model.py:144-164): a trainable embedding,
an LSTM over back-padded tokens with the true `seq_len`, outputs zeroed and
state frozen past it, l2-normalized word features, the sentence feature as
the sum of word features and the sequence mask from the zero rows.

The origin-style 'lstm_frontpad' encoder (CMPC_model_origin.py:130-141)
takes front-padded tokens with `valid_idx`, the number of pads: they are
rolled to the back-padded form and run through the same LSTM; its sentence
feature is the l2-normalized final hidden state.

TF's LSTMCell gate order is (i, j, f, o) with forget_bias=1.0 added to f
before the sigmoid; ``nn.LSTM`` orders (i, f, g, o) with no forget bias, so
the cell is written out as a Python loop over T.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_refseg_torch.ops.layers import (glorot_uniform, normal_init,
                                          split_stream)
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


ENCODERS = ("lstm", "lstm_frontpad")


def _check_encoder(cfg) -> None:
    if cfg.text_encoder not in ENCODERS:
        raise NotImplementedError(
            f"text encoder {cfg.text_encoder!r} is not ported yet")


def init_text_encoder(key, cfg) -> dict:
    """Numpy params of the 'lstm' / 'lstm_frontpad' encoder with a random
    embedding, draw for draw the JAX package's (the stream is split 4 ways
    there too)."""
    _check_encoder(cfg)
    k1, k2, _, _ = split_stream(key, 4)
    return {"embedding": normal_init(k1, (cfg.vocab_size, cfg.glove_dim)),
            "lstm": init_lstm_cell(k2, cfg.glove_dim, cfg.rnn_size)}


def lstm_scan(cell_params: dict, inputs, seq_len):
    """LSTM over [B, T, D] inputs, `dynamic_rnn` semantics (forget bias 1.0).
    The input projection is one [B*T, D] x [D, 4H] product hoisted out of
    the loop."""
    b, t, d = inputs.shape
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
    return torch.stack(outs, dim=1), h


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


def encode_text(params: dict, cfg, words, seq_len=None, *,
                valid_idx=None) -> TextFeatures:
    """Encode tokens [B, T] into TextFeatures: back-padded with lengths
    `seq_len` [B], or front-padded with `valid_idx` (`normalize_tokens`)."""
    _check_encoder(cfg)
    words, seq_len = normalize_tokens(words, seq_len, valid_idx)
    emb = params["embedding"][words.long()]                # [B,T,glove]
    outs, final_h = lstm_scan(params["lstm"], emb, seq_len)
    wf = l2_normalize(outs, -1)[:, None]                   # [B,1,T,C]
    if cfg.text_encoder == "lstm":
        lang = torch.sum(wf, dim=-2, keepdim=True)         # CMPC_model.py:161
    else:   # the final hidden state (CMPC_model_origin.py:140-141)
        lang = l2_normalize(final_h, -1)[:, None, None]
    mask = (torch.sum(torch.abs(wf), -1, keepdim=True) != 0).float()
    return TextFeatures(wf, lang, mask, wf)
