"""Serving export (reference: export_model_serving.py — a TF SavedModel with
signature `predict_images` {images, sentences, sequence_lenghts} -> {masks};
the JAX package's serving/export.py).

- `make_predict_fn`: the signature's function on the plain route
  (`apply_model(use_kernels=False)`, the port's counterpart of the JAX
  package's `xla_only_dispatch`): an exported program must not be pinned
  to the exporting card's kernel binaries.
- `export_program` / `load_program`: a `torch.export` program of it at a
  static batch, saved with `torch.export.save` (the counterparts of
  `export_stablehlo` / `load_stablehlo`).

The TF SavedModel export (`export_savedmodel`, jax2tf there) has no bridge
from torch without ONNX and is not ported (ROADMAP queue 1).
"""

from __future__ import annotations

import os

import torch

from cmpc_refseg_torch.config import ModelConfig
from cmpc_refseg_torch.models.model import apply_model, prepare_params


def make_predict_fn(cfg: ModelConfig, params: dict, model_state=None):
    """(images [B,H,W,3] f32 BGR - mean, sentences [B,T] int, sequence
    lengths [B] int) -> masks [B,H,W] sigmoid, the export_model_serving.py
    :57-71 signature, on the plain route; the parameters prepared once, on
    their own device, out of any autograd graph (a train state's
    trainable leaves require grad)."""
    prepared = _detached(prepare_params(params, cfg))
    state = _detached(model_state or {})

    def predict(images, sentences, sequence_lengths):
        batch = {"im": images, "words": sentences,
                 "seq_len": sequence_lengths}
        outputs = apply_model(prepared, cfg, batch, model_state=state,
                              train=False, use_kernels=False)
        return outputs.sigm[..., 0]
    return predict


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


class _Predict(torch.nn.Module):
    def __init__(self, predict):
        super().__init__()
        self.predict = predict

    def forward(self, images, sentences, sequence_lengths):
        return self.predict(images, sentences, sequence_lengths)


def export_program(cfg: ModelConfig, params: dict, model_state, path: str,
                   batch_size: int = 1) -> str:
    """`torch.export` `make_predict_fn` at `batch_size` on the parameters'
    device and save the program to `path` (`torch.export.save`); the
    weights are constants of the program."""
    predict = make_predict_fn(cfg, params, model_state)
    dev = next(iter(params["levels"].values()))["mutan"]["vis_trans"]["DW"] \
        .device
    example = (
        torch.zeros((batch_size, cfg.H, cfg.W, 3), dtype=torch.float32,
                    device=dev),
        torch.zeros((batch_size, cfg.num_steps), dtype=torch.int64,
                    device=dev),
        torch.ones((batch_size,), dtype=torch.int64, device=dev),
    )
    with torch.no_grad():
        program = torch.export.export(_Predict(predict), example)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_program(path: str):
    """The saved program as a callable (images, sentences, lengths) ->
    masks."""
    return torch.export.load(path).module()
