"""The port's configs beyond the flagship against the JAX package, in
float32 on the CPU.

CMPC_model_origin and CMPCv3_model (the front-padded 'lstm_frontpad'
encoder), CMPCv2_model (two levels), CMPCv4_model and CMPCv5_model (the
ASPP + DeepLabv3+ decoder with its BN moving statistics) and CMPCv6_model
(the self-gated exchange), plus CMPCv4_model with the 'double_softmax'
graph norm; and the six text-encoder and lateral options' configs
(`NEW`: the BiLSTM encoder of CMPCv4_BiLSTM_T/T2 and CMPCv5_BiLSTM, the
HSV spatial channels and tanh laterals of CMPCv5_HSV / CMPCv5_BiLSTM /
CMPCv5_BiLSTM_HSV, and CMPCv4_BERT_model's BERT features, with
bert_dim=16 and vw_emb_dim=8), at the TINY geometry of
tests/test_torch_model.py.  The modules of the new options are held in
tests/test_torch_text.py.

Tolerances: the text encoder atol 1e-5; the ASPP and the decoder, run on
their own at a feature map where the rate-6/12/18 taps reach data, atol
1e-4 for the outputs and 1e-6 for the moving statistics (float32 sums in
other orders over up to 12800 entries); the modules atol 2e-6 (a few
layers); the whole forward's `sigm` and the service's `prob` atol 1e-4,
the acceptance bound.  JAX's Pallas kernels run as the XLA route or in
interpret mode, as tests/test_torch_model.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import model_state_from_jax, params_from_jax
from cmpc_refseg_torch.models import aspp as taspp
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.models import language as tlang
from cmpc_refseg_torch.models.model import apply_model as tapply
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.models.model import init_model_state, prepare_params
from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_torch.ops import normalization as tnorm
from cmpc_refseg_torch.serving import server as tserver
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import aspp as jaspp
from cmpc_refseg_tpu.models import cmpc as jcmpc
from cmpc_refseg_tpu.models import language as jlang
from cmpc_refseg_tpu.models.model import apply_model as japply
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.serving import server as jserver

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=3,
            res4_blocks=2, bert_dim=16)
VARIANTS = ("CMPC_model_origin", "CMPCv2_model", "CMPCv3_model",
            "CMPCv4_model", "CMPCv5_model", "CMPCv6_model")
NEW = ("CMPCv4_BiLSTM_T_model", "CMPCv4_BiLSTM_T2_model", "CMPCv5_HSV_model",
       "CMPCv5_BiLSTM_model", "CMPCv5_BiLSTM_HSV_model", "CMPCv4_BERT_model")
# (config, overrides): the configs, CMPCv4_model's double softmax, and the
# BERT config with a small affinity width
CASES = [(name, {}) for name in VARIANTS] + [
    ("CMPCv4_model", {"graph_norm": "double_softmax"})] + [
    (name, {"vw_emb_dim": 8} if name == "CMPCv4_BERT_model" else {})
    for name in NEW]
VOCAB = {"<pad>": 0, "<go>": 1, "<eos>": 2, "the": 3, "dog": 4, "<unk>": 5,
         "man": 6, "left": 7, "on": 8, "red": 9}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return _t(tree)


def _close(got, want, atol, what=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _close(got[k], want[k], atol, f"{what}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# text encoder: lstm_frontpad
# ---------------------------------------------------------------------------

LENS = np.array([3, 1, 6], np.int32)


def _tokens(steps=6):
    """Back-padded and front-padded forms of three expressions (3, 1 and 6
    words) and their lengths and pad counts."""
    rng = np.random.default_rng(3)
    back = np.zeros((3, steps), np.int32)
    front = np.zeros((3, steps), np.int32)
    for i, n in enumerate(LENS):
        ids = rng.integers(3, 30, n)
        back[i, :n] = ids
        front[i, steps - n:] = ids
    return back, front, steps - LENS


@pytest.mark.parametrize("encoder", ["lstm_frontpad", "lstm"])
def test_encode_text_front_padded_matches_jax(encoder):
    """Front-padded tokens with `valid_idx` against JAX's encode_text, and
    against the back-padded form of the same expressions in the port."""
    jcfg = jget("CMPC_model", **TINY, text_encoder=encoder)
    tcfg = tget("CMPC_model", **TINY, text_encoder=encoder)
    params = jlang.init_text_encoder(7, jcfg)
    back, front, valid_idx = _tokens()
    want = jlang.encode_text(params, jcfg, words=jnp.asarray(front),
                             valid_idx=jnp.asarray(valid_idx))
    tp = _to_torch(params)
    got = tlang.encode_text(tp, tcfg, torch.from_numpy(front),
                            valid_idx=torch.from_numpy(valid_idx))
    again = tlang.encode_text(tp, tcfg, torch.from_numpy(back),
                              torch.from_numpy(LENS))
    for name, g, w, a in zip(got._fields, got, want, again):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert got.seq_mask[:, 0, :, 0].sum(-1).tolist() == LENS.tolist()


def test_encode_text_needs_lengths_or_pads():
    cfg = tget("CMPC_model_origin", **TINY)
    params = _to_torch(tlang.init_text_encoder(7, cfg))
    with pytest.raises(ValueError, match="valid_idx"):
        tlang.encode_text(params, cfg, torch.zeros(3, 6, dtype=torch.int64))


def test_normalize_tokens_rolls_front_pads():
    back, front, valid_idx = _tokens()
    words, lens = tlang.normalize_tokens(
        torch.from_numpy(front),
        valid_idx=torch.from_numpy(valid_idx)[:, None])
    want, want_len = jlang._normalize_tokens(jnp.asarray(front), None,
                                             jnp.asarray(valid_idx), 6)
    np.testing.assert_array_equal(words.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_len))
    for i, n in enumerate(LENS):
        np.testing.assert_array_equal(words[i, :n].numpy(), back[i, :n])


# ---------------------------------------------------------------------------
# ASPP and the v3+ decoder
# ---------------------------------------------------------------------------

def _random_state(tree, rng):
    """Moving statistics away from their initial values: mean ~ N(0, 0.1),
    var in [0.5, 1.5]."""
    return {unit: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)
                            ).astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, s["var"].shape
                                      ).astype(np.float32)}
            for unit, s in tree.items()}


def _random_bn(params, rng):
    """gamma and beta away from 1 and 0."""
    out = {}
    for k, u in params.items():
        out[k] = dict(u)
        if "gamma" in u:
            out[k]["gamma"] = rng.uniform(0.5, 1.5, u["gamma"].shape).astype(
                np.float32)
            out[k]["beta"] = (0.1 * rng.standard_normal(u["beta"].shape)
                              ).astype(np.float32)
    return out


@pytest.mark.parametrize("train,batch", [(False, 2), (True, 2), (True, 1)])
def test_aspp_matches_jax(train, batch):
    """apply_aspp on [B, 40, 40, 12] (the rate-18 taps reach data) in eval
    and train mode; at batch 1 in train mode the image-level BN sees one
    value per channel, so its batch variance is 0, in both packages."""
    rng = np.random.default_rng(11)
    cfg = jget("CMPCv4_model", **TINY)
    params, state = jaspp.init_aspp(8, cfg, 12)
    params, state = _random_bn(params, rng), _random_state(state, rng)
    x = rng.standard_normal((batch, 40, 40, 12)).astype(np.float32)
    want, want_state = jaspp.apply_aspp(params, state, jnp.asarray(x),
                                        train=train)
    got, got_state = taspp.apply_aspp(_to_torch(params), _to_torch(state),
                                      _t(x), train=train)
    assert tuple(got.shape) == (batch, 40, 40, 256)
    _close(got.numpy(), want, 1e-4, "aspp")
    _close({k: {s: v.numpy() for s, v in d.items()}
            for k, d in got_state.items()}, want_state, 1e-6, "state")
    if train:
        assert not np.allclose(np.asarray(want_state["conv_1x1"]["mean"]),
                               state["conv_1x1"]["mean"])


@pytest.mark.parametrize("train", [False, True])
def test_v3plus_decoder_matches_jax(train):
    """apply_v3plus_decoder: encoder output [2, 40, 40, 256] resized to
    c2's [2, 80, 80] (TF1 resize), the 48-channel lateral, two 3x3 convs
    and the float32 logits."""
    rng = np.random.default_rng(12)
    cfg = jget("CMPCv4_model", **TINY)
    params, state = jaspp.init_v3plus_decoder(9, cfg)
    params, state = _random_bn(params, rng), _random_state(state, rng)
    enc = rng.standard_normal((2, 40, 40, 256)).astype(np.float32)
    c2 = np.maximum(rng.standard_normal((2, 80, 80, 256)), 0).astype(
        np.float32)
    want, want_state = jaspp.apply_v3plus_decoder(
        params, state, jnp.asarray(enc), jnp.asarray(c2), train=train)
    got, got_state = taspp.apply_v3plus_decoder(
        _to_torch(params), _to_torch(state), _t(enc), _t(c2), train=train)
    assert tuple(got.shape) == (2, 80, 80, 1) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4, "decoder")
    _close({k: {s: v.numpy() for s, v in d.items()}
            for k, d in got_state.items()}, want_state, 1e-6, "state")


def test_bn_state_takes_no_gradient():
    """In train mode the outputs carry the batch statistics' gradient and
    the new moving statistics none."""
    cfg = tget("CMPCv4_model", **TINY)
    params, state = taspp.init_aspp(8, cfg, 12)
    params = {k: {n: _t(v).requires_grad_() for n, v in u.items()}
              for k, u in params.items()}
    x = torch.randn(2, 6, 6, 12, requires_grad=True)
    out, new_state = taspp.apply_aspp(params, _to_torch(state), x,
                                      train=True)
    out.square().sum().backward()
    assert x.grad is not None and params["conv_1x1"]["gamma"].grad is not None
    assert not any(v.requires_grad for _, v in _leaves(new_state))


# ---------------------------------------------------------------------------
# modules: self-gated exchange, double-softmax graph
# ---------------------------------------------------------------------------

def _refuse(monkeypatch, *names):
    """Make the kernel wrappers `names` fail if the code under test calls
    them (on the CPU they would run their plain versions)."""
    def refuse(*a, **k):
        raise AssertionError("a kernel the path must not launch was called")
    for name in names:
        monkeypatch.setattr(kernels, name, refuse)


@pytest.mark.parametrize("others", [1, 2])
def test_self_gated_exchange_matches_jax(monkeypatch, others):
    """apply_exchange and exchange_step_normed with exchange_self_gate=True
    (no feat term; a gv per other level) against JAX's; the SE-sum kernel
    is not called."""
    geo = dict(mlp_dim=12, rnn_size=16, exchange_self_gate=True)
    jcfg, tcfg = jget("CMPCv6_model", **geo), tget("CMPCv6_model", **geo)
    pex = jcmpc.init_exchange(5, jcfg, others)
    assert set(pex) == {"se", "gv_each", "gv_self", "se_self"}
    rng = np.random.default_rng(2)
    feat, *rest = (rng.standard_normal((2, 4, 4, 12)).astype(np.float32)
                   for _ in range(1 + others))
    lang = rng.standard_normal((2, 1, 1, 16)).astype(np.float32)
    jargs = (jnp.asarray(feat), [jnp.asarray(o) for o in rest],
             jnp.asarray(lang))
    targs = (_t(feat), [_t(o) for o in rest], _t(lang))
    tp = _to_torch(pex)
    assert _to_torch(tcmpc.init_exchange(5, tcfg, others)).keys() == tp.keys()
    _close(tcmpc.apply_exchange(tp, tcfg, *targs).numpy(),
           jcmpc.apply_exchange(pex, jcfg, *jargs), 2e-6, "module")
    _refuse(monkeypatch, "se_sum", "se_sum_plain")
    got = tcmpc.exchange_step_normed(tp, tcfg, *targs)
    _close(got.numpy(), jcmpc.exchange_step_normed(pex, jcfg, *jargs), 2e-6,
           "step")
    _close(got.numpy(), tnorm.l2_normalize(
        tcmpc.apply_exchange(tp, tcfg, *targs), -1).numpy(), 1e-7)


def _graph_inputs(b, levels=1):
    rng = np.random.default_rng(b)
    unit = rng.standard_normal((levels, b, 4, 4, 16)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    words = rng.standard_normal((b, 1, 6, 16)).astype(np.float32)
    parse = rng.random((b, 1, 6, 4)).astype(np.float32)
    parse /= parse.sum(-1, keepdims=True)
    mask = np.zeros((b, 1, 6, 1), np.float32)
    mask[:, :, :4] = 1
    return list(unit), words, parse * mask, mask


@pytest.mark.parametrize("b", [1, 3])
def test_double_softmax_graph_matches_jax(monkeypatch, b):
    """apply_spa_graph with graph_norm='double_softmax' (softmax over the
    nodes, scaled by the relation word probability, w_aff = v_aff) against
    JAX's; the two-level grouped call runs level by level (the ungrouped
    update, no affinity kernel) and gives the same."""
    geo = dict(v_emb_dim=16, rnn_size=16, graph_norm="double_softmax")
    jcfg, tcfg = jget("CMPCv4_model", **geo), tget("CMPCv4_model", **geo)
    gps = [jcmpc.init_spa_graph(k, jcfg) for k in (4, 5)]
    vis, words, parse, mask = _graph_inputs(b, levels=2)
    jl = (jnp.asarray(words), jnp.asarray(parse), jnp.asarray(mask))
    tl = (_t(words), _t(parse), _t(mask))
    tgps = [_to_torch(p) for p in gps]
    _refuse(monkeypatch, "spa_affinity", "spa_affinity_grouped",
            "graph_update_grouped")
    outs, gws = tcmpc.apply_spa_graph_grouped(tgps, tcfg,
                                              [_t(v) for v in vis], *tl)
    assert not tcmpc.pack_levels(b, 2, "double_softmax")
    for p, tp, v, out, gw in zip(gps, tgps, vis, outs, gws):
        want, (w_aff, v_aff) = jcmpc.apply_spa_graph(p, jcfg, jnp.asarray(v),
                                                     *jl)
        got, (tw, tv) = tcmpc.apply_spa_graph(tp, tcfg, _t(v), *tl)
        assert torch.equal(tw, tv)
        _close(got.numpy(), want, 2e-6, "out")
        _close(tw.numpy(), w_aff, 1e-7, "w_aff")
        _close(tv.numpy(), v_aff, 1e-7, "v_aff")
        assert torch.equal(out, got) and torch.equal(gw[0], tw)
        np.testing.assert_allclose(tw.sum(1).numpy(), parse[:, 0, :, 2],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _batch(cfg, size):
    """The test_torch_model batch; front-padded with `valid_idx` for the
    'lstm_frontpad' configs; seeded N(0, 1) features [3, T, bert_dim]
    with the expressions' masks for the 'bert' config."""
    rng = np.random.default_rng(1)
    back, front, valid_idx = _tokens(cfg.num_steps)
    batch = {"im": (20 * rng.standard_normal((3, cfg.H, cfg.W, 3))
                    ).astype(np.float32)}
    if cfg.text_encoder == "bert":
        batch.update(
            words_feat=rng.standard_normal(
                (3, cfg.num_steps, cfg.bert_dim)).astype(np.float32),
            sequence_mask=(np.arange(cfg.num_steps)[None] < LENS[:, None]
                           ).astype(np.float32))
    elif cfg.text_encoder == "lstm_frontpad":
        batch.update(words=front, valid_idx=valid_idx.astype(np.int32))
    else:
        batch.update(words=back, seq_len=LENS)
    return {k: v[-size:] for k, v in batch.items()}


@pytest.mark.parametrize("init_seed", [0, 3])
@pytest.mark.parametrize("name", VARIANTS + NEW)
def test_init_matches_jax(name, init_seed):
    """The port's numpy init gives JAX's init_model params draw for draw
    (no multiscore 'score' conv for the ASPP decoder; a gv per other level
    for the self-gated exchange), and init_model_state its state."""
    cfg = tget(name, **TINY)
    jp, js = jinit(init_seed, jget(name, **TINY))
    mine = dict(_leaves(tinit(init_seed, cfg, device="cpu")))
    theirs = dict(_leaves(params_from_jax(jp, cfg, device="cpu")))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    state = dict(_leaves(init_model_state(cfg, device="cpu")))
    want = dict(_leaves(model_state_from_jax(js, device="cpu")))
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert ("/scores/score/DW" in mine) == (cfg.decoder == "multiscore")
    assert bool(state) == (cfg.decoder == "aspp_v3plus")


@pytest.mark.parametrize("size", [1, 3])
@pytest.mark.parametrize("name,overrides", CASES,
                         ids=[n + "".join(f"-{v}" for v in o.values())
                              for n, o in CASES])
def test_forward_matches_jax(monkeypatch, name, overrides, size):
    """`sigm` of the port's forward against JAX apply_model(train=False)
    from the same params and state, and the eval-mode state unchanged.
    JAX's kernels run in interpret mode at batch 1 and as the XLA route at
    batch 3."""
    if size == 1:
        monkeypatch.setenv("CMPC_FUSED", "interpret")
    else:
        monkeypatch.delenv("CMPC_FUSED", raising=False)
    geo = {**TINY, "batch_size": size, **overrides}
    jcfg, tcfg = jget(name, **geo), tget(name, **geo)
    batch = _batch(tcfg, size)
    jp, js = jinit(0, jcfg)
    want, _ = jax.jit(lambda p, s, b: japply(p, s, jcfg, b))(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    state = init_model_state(tcfg, device="cpu")
    with torch.inference_mode():
        got = tapply(tinit(0, tcfg, device="cpu"), tcfg,
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     model_state=state)
    np.testing.assert_allclose(got.sigm.numpy(), np.asarray(want.sigm),
                               rtol=0, atol=1e-4)
    for lv in jcfg.levels:
        np.testing.assert_allclose(got.up_levels[lv].numpy(),
                                   np.asarray(want.up_levels[lv]),
                                   rtol=1e-4, atol=1e-4, err_msg=lv)
    assert got.model_state is state


def test_decoder_train_mode_forward_matches_jax():
    """CMPCv5_model at batch 3 in train mode: the logits from the batch
    statistics and the new moving statistics against JAX's."""
    jcfg, tcfg = jget("CMPCv5_model", **TINY), tget("CMPCv5_model", **TINY)
    batch = _batch(tcfg, 3)
    jp, js = jinit(0, jcfg)
    want, want_state = jax.jit(
        lambda p, s, b: japply(p, s, jcfg, b, train=True))(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tapply(tinit(0, tcfg, device="cpu"), tcfg,
                 {k: torch.from_numpy(v) for k, v in batch.items()},
                 model_state=init_model_state(tcfg, device="cpu"), train=True)
    np.testing.assert_allclose(got.up.detach().numpy(), np.asarray(want.up),
                               rtol=1e-4, atol=1e-4)
    mine = dict(_leaves(got.model_state))
    for k, w in _leaves(jax.tree.map(np.asarray, want_state)):
        np.testing.assert_allclose(mine[k].numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_decoder_without_model_state_raises():
    """A missing model state is never replaced by initial statistics."""
    cfg = tget("CMPCv4_model", **TINY)
    params = tinit(0, cfg, device="cpu")
    feed = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    with pytest.raises(ValueError, match="model_state"):
        tapply(params, cfg, feed)
    with pytest.raises(ValueError, match="model_state"):
        tserver.PredictService(cfg, params, VOCAB, device="cpu")


def test_prepared_decoder_params_give_the_same_forward():
    """prepare_params on a decoder config with the self-gated exchange: no
    SE tables (no SE sum runs), the ASPP/decoder kernels in the compute
    dtype with BN's gamma and beta and the logits conv in f32; the forward
    from them is the forward from the f32 params."""
    cfg = tget("CMPCv6_model", **TINY)
    params = tinit(0, cfg, device="cpu")
    prepared = prepare_params(params, cfg)
    assert all("se_tables" not in pex for pex in
               prepared["fusion_stack"]["exchange"].values())
    bf = prepare_params(params, cfg.replace(compute_dtype="bfloat16"))
    assert bf["aspp"]["conv_3x3_1"]["DW"].dtype == torch.bfloat16
    assert bf["aspp"]["conv_3x3_1"]["gamma"].dtype == torch.float32
    assert bf["decoder"]["conv_1x1"]["DW"].dtype == torch.float32
    state = init_model_state(cfg, device="cpu")
    feed = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    with torch.inference_mode():
        a = tapply(prepared, cfg, feed, model_state=state)
        b = tapply(params, cfg, feed, model_state=state)
    assert torch.equal(a.sigm, b.sigm)


# ---------------------------------------------------------------------------
# the predict service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CMPCv5_model", "CMPC_model_origin"])
def test_predict_service_matches_jax(name, rng):
    """PredictService at batch 1 (back-padded tokens, as JAX's service
    feeds every config) against JAX's PredictService."""
    geo = {**TINY, "batch_size": 1}
    jcfg, tcfg = jget(name, **geo), tget(name, **geo)
    jp, js = jinit(0, jcfg)
    jsvc = jserver.PredictService(jcfg, jp, js, VOCAB)
    tsvc = tserver.PredictService(tcfg, tinit(0, tcfg, device="cpu"), VOCAB,
                                  model_state=model_state_from_jax(
                                      js, device="cpu"), device="cpu")
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    for expression in ("the dog", "the red man on the left"):
        want_prob, _ = jsvc.predict(img, expression)
        prob, mask = tsvc.predict(img, expression)
        assert prob.shape == (40, 56) and mask.shape == (40, 56)
        np.testing.assert_allclose(prob, want_prob, rtol=0, atol=1e-4)


def test_import_guard_covers_the_aspp_module():
    """tests/test_torch_model.py's guard globs the package; the new module
    is among its files and imports no JAX."""
    import re
    from pathlib import Path
    path = Path(taspp.__file__)
    assert path.parent == Path(tcmpc.__file__).parent
    banned = re.compile(r"^\s*(import|from)\s+jax\b|cmpc_refseg_tpu", re.M)
    assert not banned.search(path.read_text())
