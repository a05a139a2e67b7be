"""CMPCv6_plus_model (the sentence fusion, two graph convolutions per level
with the l2-normalized affinity) and CMPCv5_plus_model (the detection
head) against the JAX package, in float32 on the CPU at the TINY geometry
of tests/test_torch_variants.py.

- The sentence fusion of a level (a second mutan of the graph output with
  the sentence vector of every parse class but U, then relu(conv1x1)),
  level-packed and level by level, at batch 1 and 3 (JAX packs at batch
  <= 2 and runs batch 3 level by level): fusions atol 2e-5, rtol 2e-4
  (the layer norms' statistics as sums on one side, two-pass on the
  other, tests/test_torch_kernels.py's LN_TOL).
- Two graph convolutions with the l2-normalized affinity: the outputs
  likewise, and the gradients of the kernel route's autograd functions
  against jax.grad (each leaf within 1e-4 of its largest entry plus 1e-9
  of the largest gradient).
- Both configs: the whole forward at batch 1 and 3 (`sigm` atol 1e-4, the
  detection head's decoded boxes rtol 1e-4), the PredictService (`prob`
  atol 1e-4; the boxes are ignored, as in JAX), `evaluate` (the protocol
  of tests/test_torch_eval.py) and a checkpoint round trip after a step
  (bit-equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import model_state_from_jax, params_from_jax
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.models.model import apply_model as tapply
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.models.model import init_model_state, prepare_params
from cmpc_refseg_torch.ops.spatial import spatial_coordinate_grid
from cmpc_refseg_torch.serving import server as tserver
from cmpc_refseg_torch.train import checkpoint as tck
from cmpc_refseg_torch.train import evaluator as tev
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import cmpc as jcmpc
from cmpc_refseg_tpu.models.model import apply_model as japply
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.serving import server as jserver
from cmpc_refseg_tpu.train import evaluator as jev
from test_torch_checkpoint import _assert_bit_equal, _batches
from test_torch_eval import _check_results, _ious, _samples
from test_torch_variants import TINY, VOCAB, _batch, _to_torch

torch.set_num_threads(2)

PLUS = ("CMPCv6_plus_model", "CMPCv5_plus_model")
GEO = dict(v_emb_dim=16, rnn_size=16, mlp_dim=12)
LN_TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _lang_inputs(b, levels=2, side=4):
    """Unit visual features of `levels` levels [b, side, side, 16], words
    [b, 1, 6, 16], a parse over 4 classes masked to 4 words, the mask, the
    spatial grid."""
    rng = np.random.default_rng(10 + b)
    vis = rng.standard_normal((levels, b, side, side, 16)).astype(np.float32)
    vis /= np.linalg.norm(vis, axis=-1, keepdims=True)
    words = rng.standard_normal((b, 1, 6, 16)).astype(np.float32)
    parse = rng.random((b, 1, 6, 4)).astype(np.float32)
    parse /= parse.sum(-1, keepdims=True)
    mask = np.zeros((b, 1, 6, 1), np.float32)
    mask[:, :, :4] = 1
    spatial = np.broadcast_to(spatial_coordinate_grid(side, side).numpy(),
                              (b, side, side, 8)).astype(np.float32)
    return list(vis), words, parse * mask, mask, spatial


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("route", ["packed", "per_level"])
def test_sentence_fusion_matches_jax(monkeypatch, route, b):
    """apply_lang2vis_multi of CMPCv6_plus_model's two levels against JAX's
    apply_lang2vis per level: the sent_mutan and the C -> mlp fusion conv,
    after two graph convolutions on the l2-normalized affinity."""
    jcfg, tcfg = (jget("CMPCv6_plus_model", **GEO),
                  tget("CMPCv6_plus_model", **GEO))
    assert tcfg.sent_fusion and tcfg.num_graph_conv == 2 \
        and tcfg.l2norm_affinity
    ps = [jcmpc.init_lang2vis(k, jcfg) for k in (4, 5)]
    assert ps[0]["fusion"]["DW"].shape == (1, 1, 16, 12)
    vis, words, parse, mask, spatial = _lang_inputs(b)
    jl = [jnp.asarray(a) for a in (words, parse, mask, spatial)]
    want = [jcmpc.apply_lang2vis(p, jcfg, jnp.asarray(v), *jl[:3], jl[3])[0]
            for p, v in zip(ps, vis)]
    if route == "per_level":
        monkeypatch.setattr(tcmpc, "LEVEL_PACK_MAX_BATCH", 0)
    assert tcmpc.pack_levels(b, 2) == (route == "packed")
    tps = [_to_torch(p) for p in ps]
    with torch.no_grad():
        got, _ = tcmpc.apply_lang2vis_multi(
            tps, tcfg, [_t(v) for v in vis], _t(words), _t(parse), _t(mask),
            _t(spatial))
    for g, w in zip(got, want):
        assert g.shape == (b, 4, 4, 12)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LN_TOL)


def test_init_lang2vis_matches_jax():
    """The sent_mutan from the third key and the C -> mlp fusion conv from
    the fourth, draw for draw."""
    jp = jcmpc.init_lang2vis(7, jget("CMPCv6_plus_model", **GEO))
    tp = tcmpc.init_lang2vis(7, tget("CMPCv6_plus_model", **GEO))
    assert set(tp) == set(jp) == {"mutan", "graph", "sent_mutan", "fusion"}
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], np.asarray(flat_j[k]))


def _graph_grads(b):
    """Outputs and gradients of sum_l coef_l * out_l over two levels of the
    grouped graph (num_graph_conv=2, l2n), in JAX and through the port's
    kernel route (its autograd functions)."""
    jcfg, tcfg = (jget("CMPCv6_plus_model", **GEO),
                  tget("CMPCv6_plus_model", **GEO))
    gps = [jcmpc.init_spa_graph(k, jcfg) for k in (6, 7)]
    assert len(gps[0]["gconv"]) == 2
    vis, words, parse, mask, _ = _lang_inputs(b)
    rng = np.random.default_rng(b)
    coef = rng.standard_normal((2, b, 4, 4, 16)).astype(np.float32)
    jl = [jnp.asarray(a) for a in (words, parse, mask)]

    def jloss(ps, xs):
        outs, _ = jcmpc.apply_spa_graph_grouped(ps, jcfg, xs, *jl)
        return sum(jnp.sum(c * o) for c, o in zip(coef, outs)), outs

    (_, jouts), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, gps), [jnp.asarray(v) for v in vis])
    tgps = [_to_torch(p) for p in gps]
    leaves = [leaf for p in tgps for _, leaf in
              jax.tree_util.tree_flatten_with_path(p)[0]]
    for leaf in leaves:
        leaf.requires_grad_()
    xs = [_t(v).requires_grad_() for v in vis]
    with torch.enable_grad():
        outs, _ = tcmpc.apply_spa_graph_grouped(tgps, tcfg, xs, _t(words),
                                                _t(parse), _t(mask))
        sum((_t(c) * o).sum() for c, o in zip(coef, outs)).backward()
    return (outs, jouts), (tgps, jgp), (xs, jgx)


@pytest.mark.parametrize("b", [1, 3])
def test_two_graph_convs_l2n_forward_and_gradient_match_jax(b):
    (outs, jouts), (tgps, jgp), (xs, jgx) = _graph_grads(b)
    for o, w in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   **LN_TOL)
    pairs = [(leaf.grad, w) for tp, jp in zip(tgps, jgp) for (_, leaf), (_, w)
             in zip(jax.tree_util.tree_flatten_with_path(tp)[0],
                    jax.tree_util.tree_flatten_with_path(jp)[0])]
    pairs += [(x.grad, w) for x, w in zip(xs, jgx)]
    assert len(pairs) == 2 * (2 + 2 + 2 * 6) + 2
    floor = 1e-9 * max(np.abs(np.asarray(w)).max() for _, w in pairs)
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + floor)


# ---------------------------------------------------------------------------
# the whole model, the service, evaluation and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init_seed", [0, 3])
@pytest.mark.parametrize("name", PLUS)
def test_init_matches_jax(name, init_seed):
    """The port's init gives JAX's init_model params draw for draw: the
    sent_mutan and the narrow fusion conv of v6+, the bbox head of v5+."""
    cfg = tget(name, **TINY)
    jp, js = jinit(init_seed, jget(name, **TINY))
    mine = dict(jax.tree_util.tree_flatten_with_path(
        tinit(init_seed, cfg, device="cpu"))[0])
    theirs = dict(jax.tree_util.tree_flatten_with_path(
        params_from_jax(jp, cfg, device="cpu"))[0])
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    tree = tinit(init_seed, cfg, device="cpu")
    assert ("bbox" in tree) == cfg.bbox_head
    assert ("sent_mutan" in tree["levels"]["c4"]) == cfg.sent_fusion


@pytest.mark.parametrize("size", [1, 3])
@pytest.mark.parametrize("name", PLUS)
def test_forward_matches_jax(monkeypatch, name, size):
    """`sigm` and the per-level logits of the port's forward against JAX
    apply_model(train=False) (its kernels in interpret mode at batch 1, the
    XLA route at batch 3); v5+'s decoded boxes too, from the raw and from
    the prepared parameters."""
    if size == 1:
        monkeypatch.setenv("CMPC_FUSED", "interpret")
    else:
        monkeypatch.delenv("CMPC_FUSED", raising=False)
    geo = {**TINY, "batch_size": size}
    jcfg, tcfg = jget(name, **geo), tget(name, **geo)
    batch = _batch(tcfg, size)
    jp, js = jinit(0, jcfg)
    want, _ = jax.jit(lambda p, s, b: japply(p, s, jcfg, b))(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    state = init_model_state(tcfg, device="cpu")
    params = tinit(0, tcfg, device="cpu")
    feed = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = tapply(params, tcfg, feed, model_state=state)
        again = tapply(prepare_params(params, tcfg), tcfg, feed,
                       model_state=state)
    np.testing.assert_allclose(got.sigm.numpy(), np.asarray(want.sigm),
                               rtol=0, atol=1e-4)
    assert torch.equal(again.sigm, got.sigm)
    for lv in jcfg.levels:
        np.testing.assert_allclose(got.up_levels[lv].numpy(),
                                   np.asarray(want.up_levels[lv]),
                                   rtol=1e-4, atol=1e-4, err_msg=lv)
    if tcfg.bbox_head:
        assert got.bbox[1].shape == (size, 4, 4, 3, 5)
        for g, w in zip(got.bbox, want.bbox):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
    else:
        assert got.bbox is None and want.bbox is None


@pytest.mark.parametrize("name", PLUS)
def test_predict_service_matches_jax(name, rng):
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


@pytest.mark.parametrize("name", PLUS)
def test_evaluate_matches_jax(name):
    """The reference protocol on 7 samples at batch 4 (the last batch
    padded): per-sample IoU atol 1e-5, overall and mean IoU and prec@X as
    tests/test_torch_eval.py holds them."""
    jcfg, tcfg = jget(name, **TINY), tget(name, **TINY)
    params, state = jax.tree.map(np.asarray,
                                 jinit(jax.random.PRNGKey(0), jcfg))
    samples = _samples(tcfg)
    keys = ("im", "words", "seq_len", "orig_size", "target_native")
    jsamples = [{k: s[k] for k in keys} for s in samples]
    want, ious = _ious(lambda vis: jev.evaluate(
        jcfg, params, state, iter(jsamples), batch_size=4,
        visualize_fn=vis), samples)
    got, tious = _ious(lambda vis: tev.evaluate(
        tcfg, params_from_jax(params, tcfg, device="cpu"),
        model_state_from_jax(state, device="cpu"), iter(samples),
        batch_size=4, device="cpu", visualize_fn=vis), samples)
    np.testing.assert_allclose(tious, ious, rtol=0, atol=1e-5)
    _check_results(got["no_crf"], want["no_crf"], ious)


@pytest.mark.parametrize("name", PLUS)
def test_checkpoint_round_trip_is_bit_equal(tmp_path, name):
    """A state after one step (v5+ with box labels) restores bit-equal into
    a state from another seed, the sent_mutan, both graph rounds and the
    bbox head included."""
    from test_torch_plus_train import _box_labels
    cfg = tget(name, **{**TINY, "batch_size": 2, "is_aug": False})
    batch = _batches(cfg, 1)[0]
    if cfg.bbox_head:
        batch.update(_box_labels(cfg, np.random.default_rng(1)))
    state = ttrain.create_train_state(0, cfg, device="cpu")
    metrics = ttrain.make_train_step(cfg)(state, batch)
    assert ("loss_bbox" in metrics) == cfg.bbox_head
    tck.save_checkpoint(str(tmp_path), state, 1)
    restored = tck.restore_checkpoint(
        str(tmp_path), ttrain.create_train_state(1, cfg, device="cpu"))
    _assert_bit_equal(restored, state)
    paths = {p for p in tck.torch.load(
        str(tmp_path / "1" / tck.FILE), weights_only=True)["trainable"]}
    assert (("bbox", "conv", "DW") in paths) == cfg.bbox_head
    assert (("levels", "c4", "sent_mutan", "vis_trans", "DW") in paths) \
        == cfg.sent_fusion
    assert (("levels", "c5", "graph", "gconv", 1, "update", "DW") in paths) \
        == (cfg.num_graph_conv == 2)
