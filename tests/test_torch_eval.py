"""The port's evaluation protocol against the JAX package's, on the CPU.

- `native_prediction` on the same numpy logits at several native sizes:
  bit-equal masks, with the inclusive 1e-9 threshold and the dilated
  boundary of tests/test_eval_protocol.py.
- The metrics (`mask_intersection_union`, `batched_mask_iu`,
  `seg_accuracy`, `compute_bbox_iou`, `SegEvalAccumulator`) and
  `print_results`: equal results, the same printed text.
- `evaluate` for CMPC_model and CMPCv4_model and `evaluate_sharded` on one
  device, float32, the same parameters and samples, at the TINY geometry
  of tests/test_model.py, 7 samples in batches of 4 (the last one
  padded): overall and mean IoU within 1e-5; precision@X equal, but for a
  sample whose IoU lies within 1e-5 of the threshold (none does here).
"""

import jax
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import model_state_from_jax, params_from_jax
from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR, resize_and_pad
from cmpc_refseg_torch.ops import metrics as tmetrics
from cmpc_refseg_torch.train import evaluator as tev
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.ops import metrics as jmetrics
from cmpc_refseg_tpu.train import evaluator as jev

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, res4_blocks=2,
            batch_size=4)
N_SAMPLES = 7        # batches of 4: the last holds 3 and a copy


def boundary_heavy_logits(h=32, w=32, seed=0):
    """tests/test_eval_protocol.py's logits: a blob with a checkerboard
    fringe, so the resize leaves many fractional pixels."""
    rng = np.random.default_rng(seed)
    up = rng.standard_normal((h, w)).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    blob = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2) < (h / 3) ** 2
    up = np.where(blob, np.abs(up) + 0.1, -np.abs(up) - 0.1)
    up[h // 2:, :] *= np.where((yy[h // 2:, :] + xx[h // 2:, :]) % 2, 1, -1)
    return up.astype(np.float32)


@pytest.mark.parametrize("oh,ow", [(45, 37), (50, 41), (32, 32), (17, 60),
                                   (120, 90), (20, 20)])
def test_native_prediction_matches_jax(oh, ow):
    up = boundary_heavy_logits(seed=oh)
    up[3:6, 3:6] = tev.SCORE_THRESHOLD          # inclusive threshold
    up[7, 7] = np.nextafter(np.float32(tev.SCORE_THRESHOLD), np.float32(0))
    got = tev.native_prediction(up, oh, ow)
    want = jev.native_prediction(up, oh, ow)
    assert got.dtype == bool and got.shape == (oh, ow)
    np.testing.assert_array_equal(got, want)
    assert tev.SCORE_THRESHOLD == jev.SCORE_THRESHOLD
    if (oh, ow) == (45, 37):
        # the boundary dilates: a superset of the > 0.5 re-threshold
        from cmpc_refseg_torch.data.image import resize_and_crop
        eroded = resize_and_crop((up >= 1e-9).astype(np.float32),
                                 oh, ow) > 0.5
        assert got.sum() > eroded.sum() and np.all(got[eroded])


def test_threshold_is_inclusive():
    up = np.full((8, 8), -1.0, np.float32)
    up[2:5, 2:5] = tev.SCORE_THRESHOLD
    assert tev.native_prediction(up, 8, 8)[3, 3]


def test_mask_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.random((5, 9, 7, 1)) > 0.5
    target = (rng.random((5, 9, 7, 1)) > 0.6).astype(np.float32)
    pred[2] = False
    target[2] = 0                    # an empty sample: U = 0
    got = tmetrics.batched_mask_iu(torch.from_numpy(pred),
                                   torch.from_numpy(target))
    want = jmetrics.batched_mask_iu(pred, target)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tmetrics.mask_intersection_union(torch.from_numpy(pred[0]),
                                           torch.from_numpy(target[0]))
    want = jmetrics.mask_intersection_union(pred[0], target[0])
    assert [int(v) for v in got] == [int(v) for v in want]
    scores = rng.standard_normal((6, 6)).astype(np.float32)
    labels = (rng.random((6, 6)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(tmetrics.seg_accuracy(scores, labels),
                                  jmetrics.seg_accuracy(scores, labels))
    boxes = rng.integers(0, 50, (4, 4)).astype(np.float64)
    boxes[:, 2:] += boxes[:, :2]
    np.testing.assert_array_equal(
        tmetrics.compute_bbox_iou(boxes, boxes[::-1]),
        jmetrics.compute_bbox_iou(boxes, boxes[::-1]))
    assert tmetrics.EVAL_PRECISION_THRESHOLDS == \
        jmetrics.EVAL_PRECISION_THRESHOLDS


def test_accumulator_and_printout_match_jax(capsys):
    # IoUs exactly at the thresholds (>= counts), an empty union, others
    pairs = [(1, 2), (3, 5), (7, 10), (4, 5), (9, 10), (0, 0), (0, 7),
             (10, 10), (5, 11), (61, 64)]
    acc_t, acc_j = tmetrics.SegEvalAccumulator(), jmetrics.SegEvalAccumulator()
    for i, u in pairs:
        acc_t.update(np.int64(i), np.int64(u))
        acc_j.update(np.int64(i), np.int64(u))
    got, want = acc_t.result(), acc_j.result()
    assert got == want and got["prec@0.5"] == 0.7
    tev.print_results({"no_crf": got})
    out_t = capsys.readouterr().out
    jev.print_results({"no_crf": want})
    assert out_t == capsys.readouterr().out and "precision@0.9" in out_t


def _samples(cfg, seed=3):
    """N_SAMPLES samples of several native sizes: the image resized and
    padded to the model's size, 2-6 words, a boundary-heavy native mask
    and its model-resolution copy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_SAMPLES):
        oh, ow = 45 + 3 * i, 37 + 2 * i + (11 if i % 2 else 0)
        native_im = rng.integers(0, 256, (oh, ow, 3)).astype(np.float32)
        yy, xx = np.mgrid[:oh, :ow]
        blob = ((yy - oh / 2) ** 2 + (xx - ow / 3) ** 2) < (oh / 3) ** 2
        mask = blob ^ (((yy + xx) % 2).astype(bool) & (xx > ow // 2))
        im = resize_and_pad(native_im, cfg.H, cfg.W)[..., ::-1] \
            - IMAGE_MEAN_BGR
        n = int(rng.integers(2, cfg.num_steps + 1))
        words = np.zeros((1, cfg.num_steps), np.int32)
        words[0, :n] = rng.integers(3, cfg.vocab_size, n)
        out.append({"im": im[None].astype(np.float32), "words": words,
                    "seq_len": np.asarray([n], np.int32),
                    "orig_size": (oh, ow), "target_native": mask,
                    "target": (resize_and_pad(mask.astype(np.float32),
                                              cfg.H, cfg.W) > 0
                               ).astype(np.float32)[None, ..., None]})
    return out


def _ious(fn, samples):
    """Per-sample IoU of `fn(..., visualize_fn=...)`'s predictions."""
    ious = {}

    def visualize(n, sample, pred, sigm):
        target = sample["target_native"]
        u = np.logical_or(pred, target).sum()
        ious[n] = np.logical_and(pred, target).sum() / u if u else 0.0

    return fn(visualize), [ious[n] for n in range(len(samples))]


def _check_results(got, want, ious):
    """Overall and mean IoU within 1e-5; each prec@X equal but for the
    samples whose IoU lies within 1e-5 of X."""
    assert got["n"] == want["n"]
    for k in ("overall_iou", "mean_iou"):
        assert abs(got[k] - want[k]) <= 1e-5, k
    for thr in tmetrics.EVAL_PRECISION_THRESHOLDS:
        near = sum(abs(v - thr) <= 1e-5 for v in ious)
        assert abs(got[f"prec@{thr}"] - want[f"prec@{thr}"]) * got["n"] \
            <= near + 1e-9, thr


@pytest.fixture(scope="module")
def models():
    """name -> the config's JAX parameters from seed 0, the same in the
    port's layout, and the samples; built at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, tcfg = jget(name, **TINY), tget(name, **TINY)
            params, state = jax.tree.map(
                np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
            cache[name] = {
                "jcfg": jcfg, "tcfg": tcfg, "jparams": params,
                "jstate": state,
                "tparams": params_from_jax(params, tcfg, device="cpu"),
                "tstate": model_state_from_jax(state, device="cpu"),
                "samples": _samples(tcfg)}
        return cache[name]
    return get


@pytest.fixture(params=["CMPC_model", "CMPCv4_model"])
def model(models, request):
    return models(request.param)


@pytest.fixture
def flagship(models):
    return models("CMPC_model")


def test_evaluate_matches_jax(model):
    m, samples = model, model["samples"]
    keys = ("im", "words", "seq_len", "orig_size", "target_native")
    jsamples = [{k: s[k] for k in keys} for s in samples]
    want, ious = _ious(lambda vis: jev.evaluate(
        m["jcfg"], m["jparams"], m["jstate"], iter(jsamples), batch_size=4,
        visualize_fn=vis), samples)
    got, tious = _ious(lambda vis: tev.evaluate(
        m["tcfg"], m["tparams"], m["tstate"], iter(samples), batch_size=4,
        device="cpu", visualize_fn=vis), samples)
    assert set(got) == set(want) == {"no_crf"}
    assert got["no_crf"]["n"] == N_SAMPLES
    np.testing.assert_allclose(tious, ious, rtol=0, atol=1e-5)
    _check_results(got["no_crf"], want["no_crf"], ious)
    # max_samples stops early, as JAX's loop does
    short = tev.evaluate(m["tcfg"], m["tparams"], m["tstate"],
                         iter(samples), batch_size=4, max_samples=5,
                         device="cpu")
    assert short["no_crf"]["n"] == jev.evaluate(
        m["jcfg"], m["jparams"], m["jstate"], iter(jsamples), batch_size=4,
        max_samples=5)["no_crf"]["n"]


def test_evaluate_bert_matches_jax():
    """`evaluate` of CMPCv4_BERT_model (bert_dim=16, vw_emb_dim=8) on
    samples that carry 'words_feat' [1, T, 16] and 'sequence_mask' [1, T]
    instead of tokens: the padded last batch pads them too, as JAX's
    evaluator does; IoUs within 1e-5, the results as above."""
    geo = {**TINY, "bert_dim": 16, "vw_emb_dim": 8}
    jcfg, tcfg = jget("CMPCv4_BERT_model", **geo), tget("CMPCv4_BERT_model",
                                                       **geo)
    params, state = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(5)
    samples = []
    for s in _samples(tcfg):
        n = int(s["seq_len"][0])
        samples.append({
            "im": s["im"], "orig_size": s["orig_size"],
            "target_native": s["target_native"],
            "words_feat": rng.standard_normal(
                (1, tcfg.num_steps, 16)).astype(np.float32),
            "sequence_mask": (np.arange(tcfg.num_steps)[None] < n
                              ).astype(np.float32)})
    want, ious = _ious(lambda vis: jev.evaluate(
        jcfg, params, state, iter(samples), batch_size=4,
        visualize_fn=vis), samples)
    got, tious = _ious(lambda vis: tev.evaluate(
        tcfg, params_from_jax(params, tcfg, device="cpu"),
        model_state_from_jax(state, device="cpu"), iter(samples),
        batch_size=4, device="cpu", visualize_fn=vis), samples)
    assert got["no_crf"]["n"] == N_SAMPLES
    np.testing.assert_allclose(tious, ious, rtol=0, atol=1e-5)
    _check_results(got["no_crf"], want["no_crf"], ious)


def test_evaluate_sharded_matches_jax(flagship):
    m, samples = flagship, flagship["samples"]
    # samples 0-3 and 3-6: two whole batches of 4
    batches = [{k: np.concatenate([s[k] for s in samples[i:i + 4]])
                for k in ("im", "words", "seq_len", "target")}
               for i in (0, 3)]
    want = jev.evaluate_sharded(m["jcfg"], m["jparams"], m["jstate"],
                                iter(batches))
    got = tev.evaluate_sharded(m["tcfg"], m["tparams"], m["tstate"],
                               iter(batches), device="cpu")
    assert set(got) == set(want) and got["n"] == 8
    # per-sample model-resolution IoUs, to find those near a threshold
    step = tev.make_eval_step(m["tcfg"])
    ious = []
    for b in batches:
        up, _ = step(m["tparams"], m["tstate"], b)
        i, u = tev.model_res_iu(up, torch.from_numpy(b["target"]))
        ious += (i.double() / u.clamp(min=1).double()).tolist()
    _check_results(got, want, ious)


def test_unported_options_raise(flagship, tmp_path):
    """The options of ported items run.  `evaluate_sharded` over a 1-rank
    gloo group (ROADMAP item 11; 2 ranks: tests/test_torch_parallel.py)
    gives what it gives without one; the DenseCRF option (item 9) scores
    the refined masks beside the plain ones (held against JAX in
    tests/test_torch_postproc.py)."""
    import torch.distributed as dist

    from cmpc_refseg_torch.parallel.mesh import initialize_distributed
    m = flagship
    rng = np.random.default_rng(9)
    samples = [{**s, "im_native": rng.integers(
        0, 256, (*s["orig_size"], 3), dtype=np.uint8)}
        for s in m["samples"][:2]]
    res = tev.evaluate(m["tcfg"], m["tparams"], m["tstate"], iter(samples),
                       use_crf=True, device="cpu")
    assert set(res) == {"no_crf", "crf"} and res["crf"]["n"] == 2
    batches = [{k: np.concatenate([s[k] for s in m["samples"][i:i + 4]])
                for k in ("im", "words", "seq_len", "target")}
               for i in (0, 3)]
    want = tev.evaluate_sharded(m["tcfg"], m["tparams"], m["tstate"],
                                iter(batches), device="cpu")
    initialize_distributed(f"file://{tmp_path / 'init'}", 1, 0,
                           device="cpu")
    try:
        got = tev.evaluate_sharded(m["tcfg"], m["tparams"], m["tstate"],
                                   iter(batches), mesh=dist.group.WORLD,
                                   device="cpu")
    finally:
        dist.destroy_process_group()
    assert got == want and got["n"] == 8


def test_eval_needs_cuda_unless_cpu(flagship, monkeypatch):
    m = flagship
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.evaluate(m["tcfg"], m["tparams"], m["tstate"],
                     iter(m["samples"]))


def test_routes_agree_on_the_cpu(model):
    """The plain route (`use_kernels=False`, the kernels' reference) and the
    kernel route, which on CPU tensors runs the kernels' plain versions
    through its own code path (the packed graph), within float32
    rounding."""
    m = model
    batch = {k: np.concatenate([s[k] for s in m["samples"][:4]])
             for k in ("im", "words", "seq_len")}
    up_k, sigm_k = tev.make_eval_step(m["tcfg"])(m["tparams"], m["tstate"],
                                                 batch)
    up_p, _ = tev.make_eval_step(m["tcfg"], use_kernels=False)(
        m["tparams"], m["tstate"], batch)
    assert up_k.shape == (4, 32, 32, 1) and up_k.device.type == "cpu"
    assert torch.isfinite(sigm_k).all()
    torch.testing.assert_close(up_k, up_p, rtol=0, atol=1e-4)
