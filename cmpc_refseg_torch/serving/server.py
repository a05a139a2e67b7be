"""Minimal stdlib HTTP inference server for the port.

The counterpart of the JAX package's serving/server.py, with the same
request and response contract:

  POST /predict   {"image": <base64 PNG/JPEG>, "expression": "...",
                   "threshold": 0.5 (optional)}
               -> {"mask": <base64 PNG, native resolution>,
                   "prob_max": float, "latency_ms": float}
  GET  /healthz  -> {"status": "ok", "requests": int}

The forward runs at a fixed batch of 1 on one CUDA device (on the CPU only
when the caller asks for it).  Requests are served one at a time: the
service holds a lock around the forward, since the card runs one stream
and concurrency belongs in a fleet balancer.  PIL is imported by the HTTP
handler only, so the service itself needs none.

`quantize=True` serves with the int8 backbone (``models/backbone.py``:
per-channel int8 weights, per-tensor int8 activations, int32 products),
its activation scales dynamic or calibrated on `calibration_images`.

`main()` serves a checkpoint (the JAX package's server command line, with
`-device`):

    python -m cmpc_refseg_torch.serving.server -ckpt_dir CKPT \
        -vocab data/vocabulary_Gref.txt [-n CMPC_model] [-port 8500] \
        [-quantize]
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from cmpc_refseg_torch.convert import resolve_device, to_device
from cmpc_refseg_torch.data.image import (IMAGE_MEAN_BGR, resize_and_crop,
                                          resize_and_pad)
from cmpc_refseg_torch.data.text import preprocess_sentence_lstm
from cmpc_refseg_torch.models.backbone import calibrate_backbone
from cmpc_refseg_torch.models.model import apply_model, prepare_params


class PredictService:
    """The batch-1 forward and its pre- and post-processing.

    `params` are the port's parameters (``init_model`` or
    ``params_from_jax``) and `model_state` the BN moving statistics
    (``init_model_state`` or ``model_state_from_jax``; required by the
    ASPP decoder, whose missing state raises); they are moved to `device`
    (CUDA when None; raises without it), the params prepared for inference
    once.  `quantize=True` serves with the int8 backbone
    (`prepare_params(quantize_backbone=True)`); with `calibration_images`
    (mean-subtracted BGR [B, H, W, 3] arrays) its activation scales are
    baked from them (`calibrate_backbone`), else taken per call."""

    def __init__(self, cfg, params, vocab_dict, *, model_state=None,
                 device=None, quantize: bool = False,
                 calibration_images=None):
        if cfg.text_encoder == "bert":
            # as the JAX package's service: it tokenizes an expression
            # (serving/server.py:83-97 there), and BERT features come from a
            # model outside the repository
            raise ValueError(f"{cfg.variant or 'this config'}: the 'bert' "
                             "encoder takes precomputed features, which a "
                             "PredictService (text in) cannot make")
        if model_state is None and cfg.decoder != "multiscore":
            raise ValueError(f"{cfg.variant or 'this config'}: the ASPP "
                             "decoder needs model_state")
        self.device = resolve_device(device)
        self.cfg = dataclasses.replace(cfg, batch_size=1)
        self.vocab = vocab_dict
        self.params = prepare_params(to_device(params, self.device),
                                     self.cfg, quantize_backbone=quantize)
        if quantize and calibration_images is not None:
            self.params["backbone"] = calibrate_backbone(
                self.params["backbone"], calibration_images,
                res4_blocks=cfg.res4_blocks)
        self.model_state = to_device(model_state or {}, self.device)
        self.n_requests = 0
        self._lock = threading.Lock()

    def preprocess(self, image_rgb: np.ndarray, expression: str) -> dict:
        """The batch-1 feed of one request: the image resized and padded to
        the model's size as mean-subtracted BGR, and the back-padded tokens
        with their length, on the service's device."""
        cfg = self.cfg
        tokens, seq_len = preprocess_sentence_lstm(expression, self.vocab,
                                                   cfg.num_steps)
        im = resize_and_pad(image_rgb.astype(np.float32), cfg.H, cfg.W)
        im = (im[..., ::-1] - IMAGE_MEAN_BGR)[None].astype(np.float32)
        return {"im": torch.from_numpy(im).to(self.device),
                "words": torch.tensor([tokens], dtype=torch.int64,
                                      device=self.device),
                "seq_len": torch.tensor([seq_len], dtype=torch.int64,
                                        device=self.device)}

    def forward(self, batch: dict) -> np.ndarray:
        """sigm [H, W] of a batch-1 feed, on the host."""
        with self._lock, torch.inference_mode():
            sigm = apply_model(self.params, self.cfg, batch,
                               model_state=self.model_state).sigm
            self.n_requests += 1
            return sigm[0, :, :, 0].float().cpu().numpy()

    @staticmethod
    def postprocess(sigm: np.ndarray, native_hw, threshold: float = 0.5):
        """(prob, mask) of sigm [H, W] taken back to the native size."""
        prob = resize_and_crop(sigm, *native_hw)
        return prob, prob > threshold

    def warmup(self) -> None:
        self.predict(np.zeros((self.cfg.H, self.cfg.W, 3), np.uint8), "")
        self.n_requests = 0

    def predict(self, image_rgb: np.ndarray, expression: str,
                threshold: float = 0.5):
        """(prob, mask) at the image's native size for an RGB image
        [h, w, 3] and a referring expression."""
        sigm = self.forward(self.preprocess(image_rgb, expression))
        return self.postprocess(sigm, image_rgb.shape[:2], threshold)


def make_handler(service: PredictService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _reply(self, code: int, obj: dict):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "requests": service.n_requests})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                from PIL import Image
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                img = np.asarray(Image.open(io.BytesIO(
                    base64.b64decode(req["image"]))).convert("RGB"))
                t0 = time.perf_counter()
                prob, mask = service.predict(
                    img, req["expression"], float(req.get("threshold", 0.5)))
                latency = (time.perf_counter() - t0) * 1000
                buf = io.BytesIO()
                Image.fromarray(mask.astype(np.uint8) * 255).save(
                    buf, format="PNG")
                self._reply(200, {
                    "mask": base64.b64encode(buf.getvalue()).decode(),
                    "prob_max": float(prob.max()),
                    "latency_ms": round(latency, 2),
                })
            except Exception as e:   # a bad request must not stop the server
                self._reply(400, {"error": str(e)[:200]})
    return Handler


def serve(service: PredictService, host: str = "127.0.0.1",
          port: int = 8500) -> ThreadingHTTPServer:
    """Warm the service up, then start (and return) the HTTP server; the
    caller decides the blocking policy (``serve_forever`` in a thread)."""
    service.warmup()
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    """Serve a checkpoint over HTTP (the JAX package's server main, with
    `-device`): the state from `create_train_state` + `restore_checkpoint`
    of `-ckpt_dir`, in the config the checkpoint was saved with (it must
    be `-n`'s), the vocabulary from `-vocab`, the embedding from
    `load_glove`, the int8 backbone with `-quantize`.  CUDA (bf16) unless
    `-device cpu` (float32); raises without a CUDA device otherwise."""
    import argparse
    ap = argparse.ArgumentParser("cmpc_refseg_torch inference server")
    ap.add_argument("-n", dest="model_name", default="CMPC_model")
    ap.add_argument("-ckpt_dir", dest="ckpt_dir", default="./checkpoints")
    ap.add_argument("-vocab", dest="vocab", required=True)
    ap.add_argument("-port", type=int, default=8500)
    ap.add_argument("-emb", dest="emb_name", default="refvos")
    ap.add_argument("-emb_dir", dest="emb_dir", default="data")
    ap.add_argument("-quantize", action="store_true",
                    help="serve with the int8 backbone "
                         "(models/backbone.py::quantize_backbone)")
    ap.add_argument("-device", dest="device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu")
    args = ap.parse_args(argv)

    from cmpc_refseg_torch.cli import load_glove
    from cmpc_refseg_torch.data.text import load_vocab_dict_from_file
    from cmpc_refseg_torch.train.checkpoint import (restore_checkpoint,
                                                    saved_config)
    from cmpc_refseg_torch.train.trainer import create_train_state

    device = resolve_device(args.device)
    saved = saved_config(args.ckpt_dir)
    if saved.variant != args.model_name:
        raise ValueError(f"-n {args.model_name}: the checkpoint under "
                         f"{args.ckpt_dir} is of {saved.variant!r}")
    cfg = saved.replace(compute_dtype="bfloat16" if device.type == "cuda"
                        else "float32")
    glove = load_glove(args.emb_dir, args.emb_name)
    state = create_train_state(0, cfg, glove, device=device)
    state = restore_checkpoint(args.ckpt_dir, state)
    service = PredictService(cfg, state.params(),
                             load_vocab_dict_from_file(args.vocab),
                             model_state=state.model_state, device=device,
                             quantize=args.quantize)
    httpd = serve(service, port=args.port)
    print(f"serving on :{httpd.server_address[1]} (POST /predict, "
          "GET /healthz)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
