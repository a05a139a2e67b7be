"""The port's serving path against the JAX package's, on the CPU.

Text and image preprocessing (both the cv2 and the scipy branch of the
image resize), `PredictService.predict` against the JAX `PredictService`
on one non-square image at the TINY geometry in float32, and a `/predict`
round trip over HTTP.  Tolerances: the preprocessing copies must give the
same tokens and the same pixels to float32 rounding (atol 1e-5); `prob`
within atol 1e-4, the whole forward's acceptance bound, and the masks
equal except where |prob - 0.5| < 1e-4, where that bound may flip them."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cmpc_refseg_torch.api import build_service
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.data import image as timage
from cmpc_refseg_torch.data import text as ttext
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_torch.serving import server as tserver
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.data import image as jimage
from cmpc_refseg_tpu.data import text as jtext
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.serving import server as jserver

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=1,
            res4_blocks=2)
VOCAB = {"<pad>": 0, "<go>": 1, "<eos>": 2, "the": 3, "dog": 4, "<unk>": 5,
         "man": 6, "left": 7, "on": 8, "red": 9}
SENTENCES = ["the dog", "The man on the LEFT.", "red, red dog!",
             "  the unknown thing on the left of the red man  ", "", "."]


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sentence", SENTENCES)
def test_text_matches_jax(sentence):
    assert ttext.sentence2vocab_indices(sentence, VOCAB) == \
        jtext.sentence2vocab_indices(sentence, VOCAB)
    assert ttext.preprocess_sentence_lstm(sentence, VOCAB, 6) == \
        jtext.preprocess_sentence_lstm(sentence, VOCAB, 6)


def test_vocab_file_and_synthetic_vocab(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    assert ttext.load_vocab_dict_from_file(str(path)) == \
        jtext.load_vocab_dict_from_file(str(path)) == VOCAB
    vocab = ttext.synthetic_vocab(30)
    assert len(vocab) == 30 and sorted(vocab.values()) == list(range(30))
    assert vocab[ttext.PAD_IDENTIFIER] == 0
    tokens, n = ttext.preprocess_sentence_lstm("w4 w29 zebra", vocab, 6)
    assert (tokens, n) == ([4, 29, vocab[ttext.UNK_IDENTIFIER], 0, 0, 0], 3)


@pytest.fixture(params=["cv2", "scipy"])
def resize_branch(request, monkeypatch):
    """Both modules on the same resize branch: cv2 (where it imports) or
    scipy.ndimage."""
    use_cv2 = request.param == "cv2"
    if use_cv2 and not timage._HAS_CV2:
        pytest.skip("cv2 is not installed")
    monkeypatch.setattr(timage, "_HAS_CV2", use_cv2)
    monkeypatch.setattr(jimage, "_HAS_CV2", use_cv2)
    return request.param


@pytest.mark.parametrize("shape", [(40, 56, 3), (75, 31, 3), (24, 24)])
def test_image_geometry_matches_jax(rng, resize_branch, shape):
    im = rng.integers(0, 256, shape).astype(np.uint8)
    for fn, args in ((lambda m, *a: m.resize_and_pad(im.astype(np.float32),
                                                     *a), (32, 32)),
                     (lambda m, *a: m.resize_and_crop(im.astype(np.float32),
                                                      *a), (50, 70)),
                     (lambda m, *a: m.resize(im, *a), (13, 90))):
        np.testing.assert_allclose(fn(timage, *args), fn(jimage, *args),
                                   rtol=0, atol=1e-5)
    assert np.array_equal(timage.resize(im > 128, 17, 9),
                          jimage.resize(im > 128, 17, 9))
    np.testing.assert_array_equal(timage.IMAGE_MEAN_BGR,
                                  jimage.IMAGE_MEAN_BGR)


# ---------------------------------------------------------------------------
# the predict service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def services():
    jcfg, tcfg = jget("CMPC_model", **TINY), tget("CMPC_model", **TINY)
    jp, js = jinit(0, jcfg)
    jsvc = jserver.PredictService(jcfg, jp, js, VOCAB)
    tsvc = tserver.PredictService(tcfg, tinit(0, tcfg, device="cpu"), VOCAB,
                                  device="cpu")
    return jsvc, tsvc


@pytest.mark.parametrize("expression", ["the dog", "the red man on the left"])
def test_predict_matches_jax_service(services, rng, expression):
    """One non-square image through both services at batch 1, where the
    port's spatial graph runs level-packed."""
    jsvc, tsvc = services
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    want_prob, want_mask = jsvc.predict(img, expression)
    kernels.reset_launch_counts()
    prob, mask = tsvc.predict(img, expression)
    assert prob.shape == mask.shape == (40, 56)
    np.testing.assert_allclose(prob, want_prob, rtol=0, atol=1e-4)
    sure = np.abs(want_prob - 0.5) >= 1e-4
    np.testing.assert_array_equal(mask[sure], want_mask[sure])
    # the tensors lay on the CPU: plain versions, no kernel launch
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("name", ["CMPCv5_HSV_model",
                                  "CMPCv5_BiLSTM_HSV_model"])
def test_hsv_predict_matches_jax_service(rng, name):
    """The HSV configs' services (the image's HSV channels beside the
    spatial grid, K = v_emb_dim + 11 padded for the mutan; the second with
    the BiLSTM encoder and tanh laterals) against JAX's, at batch 1."""
    from cmpc_refseg_torch.convert import model_state_from_jax
    jcfg, tcfg = jget(name, **TINY), tget(name, **TINY)
    jp, js = jinit(0, jcfg)
    jsvc = jserver.PredictService(jcfg, jp, js, VOCAB)
    tsvc = tserver.PredictService(tcfg, tinit(0, tcfg, device="cpu"), VOCAB,
                                  model_state=model_state_from_jax(
                                      js, device="cpu"), device="cpu")
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    want_prob, _ = jsvc.predict(img, "the red man on the left")
    prob, mask = tsvc.predict(img, "the red man on the left")
    assert prob.shape == mask.shape == (40, 56)
    np.testing.assert_allclose(prob, want_prob, rtol=0, atol=1e-4)


def test_bert_service_is_refused():
    """A service tokenizes an expression; BERT features come from a model
    outside the repository, so a 'bert' config raises a clear ValueError
    (the JAX package's service has no BERT route either)."""
    cfg = tget("CMPCv4_BERT_model", **TINY)
    params = tinit(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="bert"):
        tserver.PredictService(cfg, params, VOCAB, model_state={},
                               device="cpu")
    with pytest.raises(ValueError, match="bert"):
        build_service("CMPCv4_BERT_model", device="cpu", **TINY)


def test_service_rules(monkeypatch, rng):
    """`quantize=True` runs on the CPU (the int8 backbone's units, its
    answer against JAX's: tests/test_torch_int8.py); without a CUDA device
    and without device='cpu' a service raises."""
    cfg = tget("CMPC_model", **TINY)
    params = tinit(0, cfg, device="cpu")
    svc = tserver.PredictService(cfg, params, VOCAB, device="cpu",
                                 quantize=True)
    unit = svc.params["backbone"]["res2a"]["branch2b"]
    assert unit["w_q"].dtype == torch.int8 and "w" not in unit
    prob, mask = svc.predict(rng.integers(0, 256, (21, 47, 3),
                                          dtype=np.uint8), "the dog")
    assert prob.shape == mask.shape == (21, 47) and np.isfinite(prob).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.PredictService(cfg, params, VOCAB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_service("CMPC_model", **TINY)


def test_build_service_on_cpu(rng):
    svc = build_service("CMPC_model", device="cpu",
                        **{**TINY, "batch_size": 4})
    assert svc.cfg.batch_size == 1 and len(svc.vocab) == 30
    prob, mask = svc.predict(rng.integers(0, 256, (21, 47, 3),
                                          dtype=np.uint8), "w4 w5 w6")
    assert prob.shape == (21, 47) and np.isfinite(prob).all()
    assert svc.n_requests == 1


def test_http_predict_roundtrip(services, rng):
    """/healthz and /predict over a real socket on an ephemeral port, and a
    clean 400 for a malformed body (mirrors tests/test_serving.py)."""
    from PIL import Image

    _, tsvc = services
    httpd = tserver.serve(tsvc, port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            assert json.load(r)["status"] == "ok"
        img = rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        payload = json.dumps({
            "image": base64.b64encode(buf.getvalue()).decode(),
            "expression": "the dog"}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=payload,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.load(r)
        mask = np.asarray(Image.open(io.BytesIO(
            base64.b64decode(out["mask"]))))
        assert mask.shape == (40, 56)
        prob, _ = tsvc.predict(img, "the dog")
        assert out["prob_max"] == pytest.approx(float(prob.max()))
        np.testing.assert_array_equal(mask > 0, prob > 0.5)

        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=b"not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=60)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=60)
    assert not t.is_alive()
