"""The text-encoder and lateral options against the JAX package, in float32
on the CPU: the reverse LSTM, the 'bilstm' and 'bert' encoders, the HSV
conversion, the mutan K padding the HSV configs need, and the GloVe start.

At the TINY geometry of tests/test_torch_variants.py (with bert_dim=16).
Tolerances: the encoders atol 1e-5 (a few float32 products and norms in
other orders); `rgb_to_hsv` atol 1e-6 (a handful of float32 operations on
values up to 255); the padded mutan equal to the unpadded one bit for bit
(zero columns and rows add exact zeros); the GloVe params bit-equal to
JAX's and one train step from them within tests/test_torch_train.py's
bounds (PERF.md §2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import params_from_jax
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.models import language as tlang
from cmpc_refseg_torch.models import model as tmodel
from cmpc_refseg_torch.ops import autograd, kernels
from cmpc_refseg_torch.ops.layers import conv2d
from cmpc_refseg_torch.train import optimizer as topt
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import language as jlang
from cmpc_refseg_tpu.models import model as jmodel
from cmpc_refseg_tpu.train import trainer as jtrain
from test_torch_train import TINY as TRAIN_TINY
from test_torch_train import _batch as train_batch
from test_torch_train import _check_grads, _leaves, _snapshot

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=3,
            res4_blocks=2, bert_dim=16)
LENS = np.array([1, 4, 6], np.int32)       # 1 and T = 6 included
# the BiLSTM sub-variants' flags: T/T2, v5_BiLSTM, and the config default
BILSTM = {
    "T": ("CMPCv4_BiLSTM_T_model", {}),
    "v5": ("CMPCv5_BiLSTM_model", {}),
    "merged": ("CMPCv4_BiLSTM_T_model", {"bilstm_words_source": "merged"}),
}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return _t(tree)


def _tokens(rng, steps=6):
    words = np.zeros((len(LENS), steps), np.int32)
    for i, n in enumerate(LENS):
        words[i, :n] = rng.integers(3, 30, n)
    return words


def _close_features(got, want, atol=1e-5):
    for name, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the reverse LSTM and the encoders
# ---------------------------------------------------------------------------

def test_reverse_lstm_scan_matches_jax(rng):
    """`lstm_scan(reverse=True)` with ragged lengths: outputs and final
    state against JAX's; an output row j < seq_len is the reversed scan's
    row seq_len-1-j, and rows past seq_len are zero."""
    cell = jlang.init_lstm_cell(3, 8, 16)
    cell["bias"] = (0.1 * rng.standard_normal(64)).astype(np.float32)
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    want, want_h = jlang.lstm_scan(cell, jnp.asarray(x), jnp.asarray(LENS),
                                   reverse=True)
    got, got_h = tlang.lstm_scan(_to_torch(cell), _t(x),
                                 torch.from_numpy(LENS), reverse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=1e-5)
    for i, n in enumerate(LENS):
        assert not got[i, n:].any()
        rev = x[i:i + 1, :n][:, ::-1].copy()
        flipped, _ = tlang.lstm_scan(_to_torch(cell), _t(rev),
                                     torch.tensor([n]))
        np.testing.assert_allclose(got[i, :n].numpy(),
                                   flipped[0].flip(0).numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("flags", sorted(BILSTM))
def test_encode_text_bilstm_matches_jax(rng, flags):
    """encode_text of each BiLSTM flag set: every field of TextFeatures
    against JAX's, with a nonzero merge bias only where the mask comes from
    the raw concat (the post-merge mask needs a zero bias to see pads)."""
    name, overrides = BILSTM[flags]
    jcfg, tcfg = jget(name, **TINY, **overrides), tget(name, **TINY,
                                                       **overrides)
    params = jlang.init_text_encoder(7, jcfg)
    assert set(params) == {"embedding", "lstm_fw", "lstm_bw", "words_feat"}
    if tcfg.bilstm_mask_pre_merge:
        params["words_feat"]["biases"] = (0.1 * rng.standard_normal(16)
                                          ).astype(np.float32)
    words = _tokens(rng)
    want = jlang.encode_text(params, jcfg, words=jnp.asarray(words),
                             seq_len=jnp.asarray(LENS))
    got = tlang.encode_text(_to_torch(params), tcfg, torch.from_numpy(words),
                            torch.from_numpy(LENS))
    _close_features(got, want)
    assert got.seq_mask[:, 0, :, 0].sum(-1).tolist() == LENS.tolist()
    # downstream: the merged features for v5, fw for T/T2; the parser reads
    # the merged ones in both
    assert torch.equal(got.words_feat, got.parse_feat) == (
        tcfg.bilstm_words_source == "merged")


def test_post_merge_mask_follows_a_nonzero_merge_bias(rng):
    """T/T2 take the mask from the merged features: with a nonzero merge
    bias the pad rows are nonzero, so every word counts as valid, in both
    packages alike (CMPCv4_BiLSTM_T_model.py:183, reproduced as it is)."""
    jcfg = jget("CMPCv4_BiLSTM_T_model", **TINY)
    tcfg = tget("CMPCv4_BiLSTM_T_model", **TINY)
    params = jlang.init_text_encoder(8, jcfg)
    params["words_feat"]["biases"] = (0.1 * rng.standard_normal(16)
                                      ).astype(np.float32)
    words = _tokens(rng)
    want = jlang.encode_text(params, jcfg, words=jnp.asarray(words),
                             seq_len=jnp.asarray(LENS))
    got = tlang.encode_text(_to_torch(params), tcfg, torch.from_numpy(words),
                            torch.from_numpy(LENS))
    _close_features(got, want)
    assert got.seq_mask.sum().item() == 3 * 6
    # the pre-merge mask of v5 sees the pads whatever the bias
    v5 = tget("CMPCv5_BiLSTM_model", **TINY)
    pre = tlang.encode_text(_to_torch(params), v5, torch.from_numpy(words),
                            torch.from_numpy(LENS))
    assert pre.seq_mask[:, 0, :, 0].sum(-1).tolist() == LENS.tolist()


def test_encode_text_bert_matches_jax(rng):
    """The 'bert' encoder: no parameters (init ignores a GloVe table), the
    features l2-normalized and masked; every field against JAX's."""
    jcfg, tcfg = jget("CMPCv4_BERT_model", **TINY), tget("CMPCv4_BERT_model",
                                                         **TINY)
    glove = rng.standard_normal((30, 8)).astype(np.float32)
    assert tlang.init_text_encoder(7, tcfg, glove) == {} == \
        jlang.init_text_encoder(7, jcfg, glove)
    feats = rng.standard_normal((3, 6, 16)).astype(np.float32)
    mask = (np.arange(6)[None] < LENS[:, None]).astype(np.float32)
    want = jlang.encode_text({}, jcfg, words_feat=jnp.asarray(feats),
                             sequence_mask=jnp.asarray(mask))
    got = tlang.encode_text({}, tcfg, words_feat=_t(feats),
                            sequence_mask=_t(mask))
    _close_features(got, want)
    assert got.words_feat.shape == (3, 1, 6, 16)


def test_text_encoder_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown text encoder"):
        tlang.init_text_encoder(0, tget("CMPC_model", text_encoder="gru"))


# ---------------------------------------------------------------------------
# HSV and the mutan K padding
# ---------------------------------------------------------------------------

def test_rgb_to_hsv_matches_jax(rng):
    """Gray pixels (hue 0), black pixels (saturation 0), the hue wrap (red
    largest with blue above green: a negative sextant taken mod 6), ties
    (red, then green, then blue) and random values on the image range,
    against JAX's copy of tf.image.rgb_to_hsv."""
    special = np.array([[0, 0, 0], [80, 80, 80], [255, 255, 255],
                        [200, 10, 40], [255, 0, 1], [90, 90, 10],
                        [10, 90, 90], [90, 10, 90], [0, 0, 255],
                        [-20.5, 3, 7]], np.float32)
    pixels = np.concatenate([special, rng.uniform(
        -130, 255, (500, 3)).astype(np.float32)])
    want = np.asarray(jmodel.rgb_to_hsv(jnp.asarray(pixels)))
    got = tmodel.rgb_to_hsv(_t(pixels)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0].tolist() == [0, 0, 0] and got[1].tolist() == [0, 0, 80]
    np.testing.assert_allclose(got[3, 0], 1 - 30 / 190 / 6, atol=1e-6)


def test_hsv_channels_match_jax(rng):
    """The HSV spatial channels of a mean-subtracted BGR batch: the mean
    added back, flipped to RGB, converted and resized to 4x4 (TF1)."""
    from cmpc_refseg_tpu.data.image import IMAGE_MEAN_BGR
    from cmpc_refseg_tpu.ops.resize import resize_bilinear
    im = (rng.uniform(0, 255, (2, 32, 32, 3)) - IMAGE_MEAN_BGR).astype(
        np.float32)
    rgb = (jnp.asarray(im) + jnp.asarray(IMAGE_MEAN_BGR))[..., ::-1]
    want = resize_bilinear(jmodel.rgb_to_hsv(rgb), 4, 4)
    got = tmodel.hsv_channels(_t(im), 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _mutan_inputs(rng):
    """An HSV level's mutan params and inputs at TINY: 2 samples of 4x4
    nodes, C = 16 and 11 spatial channels, so K = 27."""
    p = tcmpc.init_mutan(4, tget("CMPCv5_HSV_model", **TINY))
    p = {k: {n: _t(v) for n, v in u.items()} for k, u in p.items()}
    p["vis_trans"]["biases"] = _t(0.1 * rng.standard_normal(80))
    vis = _t(rng.standard_normal((2, 4, 4, 16)))
    spatial = _t(rng.standard_normal((2, 4, 4, 11)))
    lang = _t(rng.standard_normal((2, 1, 1, 16)))
    return p, lang, spatial, vis


def _unpadded(p, lang, spatial, vis):
    """The mutan's input at the unpadded K, its bias and text term, and
    its keywords."""
    b, h, w, c = vis.shape
    x = torch.cat([vis, spatial], -1).reshape(b * h * w, -1)
    lng = torch.tanh(conv2d(p["lang_trans"], lang)).reshape(b, -1)
    return x, (p["vis_trans"]["biases"], lng), dict(heads=5,
                                                    rows_per_sample=h * w)


def test_mutan_k_padding_is_exact(rng):
    """HSV gives K = v_emb_dim + 11 (27 here, 1011 at full width), which
    apply_mutan pads to a multiple of 8 on every route: the padded plain
    route, from the weight padded on the fly or prepared once
    (`prepare_params`' w_wide, 32 rows), equals the unpadded function bit
    for bit."""
    p, lang, spatial, vis = _mutan_inputs(rng)
    x, (bias, lng), kw = _unpadded(p, lang, spatial, vis)
    assert x.shape[1] == 27
    want = kernels.mutan_plain(x, p["vis_trans"]["DW"][0, 0], bias, lng,
                               **kw).reshape(2, 4, 4, 16)
    with torch.inference_mode():
        got = tcmpc.apply_mutan(p, lang, spatial, vis)
        wide = tcmpc.pad_mutan_weight(p["vis_trans"]["DW"][0, 0])
        prepared = tcmpc.apply_mutan({**p, "w_wide": wide}, lang, spatial,
                                     vis, use_kernels=False)
    assert wide.shape == (32, 80) and not wide[27:].any()
    assert torch.equal(got, want) and torch.equal(prepared, want)


def test_mutan_k_padding_training_form_is_exact(rng):
    """The training form at K = 27: the output and every gradient equal the
    unpadded MutanFunction's bit for bit, and the weight's gradient has
    the trainable leaf's JAX shape [K, 5C] (the padded rows' gradient is
    sliced off by autograd)."""
    p, lang, spatial, vis = _mutan_inputs(rng)
    g = _t(rng.standard_normal((2, 4, 4, 16)))
    w = p["vis_trans"]["DW"].requires_grad_()
    vis.requires_grad_()
    out = tcmpc.apply_mutan(p, lang, spatial, vis)
    out.backward(g)
    w2 = p["vis_trans"]["DW"].detach().clone().requires_grad_()
    x = torch.cat([vis.detach(), spatial], -1).reshape(32, 27)
    x.requires_grad_()
    _, (bias, lng), kw = _unpadded(p, lang, spatial, vis.detach())
    want = autograd.mutan(x, w2[0, 0], bias, lng.detach(), **kw)
    want.backward(g.reshape(32, 16))
    assert torch.equal(out.detach().reshape(32, 16), want.detach())
    assert w.grad.shape == (1, 1, 27, 80)
    assert torch.equal(w.grad, w2.grad)
    assert torch.equal(vis.grad.reshape(32, 16), x.grad[:, :16])


def test_prepared_hsv_params_pad_k_once():
    """prepare_params builds each level's w_wide with K padded (1011 ->
    1016 at the published width; 27 -> 32 here); configs whose K is a
    multiple of 8 keep it."""
    for name, k in (("CMPCv5_HSV_model", 32), ("CMPCv5_model", 24)):
        cfg = tget(name, **TINY)
        prepared = tmodel.prepare_params(tmodel.init_model(0, cfg,
                                                           device="cpu"), cfg)
        assert prepared["levels"]["c4"]["mutan"]["w_wide"].shape == (k, 80)
    assert tget("CMPCv5_HSV_model").v_emb_dim + \
        tget("CMPCv5_HSV_model").spatial_dim == 1011


# ---------------------------------------------------------------------------
# the GloVe start
# ---------------------------------------------------------------------------

def _glove(cfg):
    return np.random.default_rng(9).standard_normal(
        (cfg.vocab_size, cfg.glove_dim)).astype(np.float32)


@pytest.mark.parametrize("name", ["CMPC_model", "CMPCv5_BiLSTM_HSV_model"])
def test_glove_params_match_jax(name):
    """init_model(seed, cfg, glove): every leaf bit-equal to JAX's
    init_model(key, cfg, glove), the embedding equal to the table, and the
    other draws unchanged by it (k1 is not drawn from)."""
    tcfg, jcfg = tget(name, **TINY), jget(name, **TINY)
    glove = _glove(tcfg)
    jp, _ = jmodel.init_model(0, jcfg, glove)
    mine = dict(topt.named_leaves(tmodel.init_model(0, tcfg, glove,
                                                    device="cpu")))
    theirs = dict(topt.named_leaves(params_from_jax(jp, tcfg, device="cpu")))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    assert torch.equal(mine[("text", "embedding")], torch.from_numpy(glove))
    drawn = dict(topt.named_leaves(tmodel.init_model(0, tcfg, device="cpu")))
    assert all(torch.equal(drawn[k], v) for k, v in mine.items()
               if k != ("text", "embedding"))


def test_glove_train_step_matches_jax():
    """One train step from the GloVe start (create_train_state(seed, cfg,
    glove)) against JAX's create_train_state(key, cfg, glove) and
    make_train_step(grad_mode="tree"): losses rtol 1e-5, gradients and the
    updated weights within tests/test_torch_train.py's bounds; the
    embedding's gradient is among them."""
    tcfg, jcfg = tget("CMPC_model", **TRAIN_TINY), jget("CMPC_model",
                                                         **TRAIN_TINY)
    glove = _glove(tcfg)
    batch = train_batch(tcfg, np.random.default_rng(4))
    jstate = jtrain.create_train_state(0, jcfg, glove)
    before = _snapshot(jstate)
    np.testing.assert_array_equal(before["trainable"]["text"]["embedding"],
                                  glove)
    jstate, jm = jtrain.make_train_step(jcfg, grad_mode="tree")(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    after = _snapshot(jstate)
    state = ttrain.create_train_state(0, tcfg, glove, device="cpu")
    tm = ttrain.make_train_step(tcfg)(state, batch)
    for k in ("loss_total", "loss_cls_all", "loss_reg", "train_mIoU"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    mu = _leaves(after["mu"])
    got = {path: state.optimizer.state[leaf]["exp_avg"].numpy() / 0.1
           for path, leaf in topt.named_leaves(state.trainable)}
    assert np.abs(got[("text", "embedding")]).max() > 0
    want = {p: m / 0.1 for p, m in mu.items()}
    # the gated exchanges' key biases have the exact gradient 0 (a shift of
    # every key cancels in the softmax over the nodes): each side's noise
    # is held small, as tests/test_torch_variants_train.py holds it
    largest = max(np.abs(w).max() for w in want.values())
    for p in [p for p in want if p[-2:] == ("spa_graph_key", "biases")]:
        for g in (got.pop(p), want.pop(p)):
            assert np.abs(g).max() <= 1e-10 * largest, p
    _check_grads(got, want)
    lr = float(jm["learning_rate"])
    want = _leaves(after["trainable"])
    for path, leaf in topt.named_leaves(state.trainable):
        err = np.abs(leaf.detach().numpy() - want[path])
        resolved = np.abs(mu[path]) / 0.1 >= 1e-6
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path
