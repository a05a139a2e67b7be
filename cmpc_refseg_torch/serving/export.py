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
- `export_savedmodel`: that program, traced in float32 on the CPU, lowered
  op by op into a `tf.function` (`serving/tf_lowering.py`) and saved as a
  TF SavedModel with the reference's `predict_images` signature (its
  `sequence_lenghts` typo kept, for drop-in TF-Serving compatibility);
  TensorFlow is needed on the exporting host only, and is imported there.
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


def _trace(cfg: ModelConfig, params: dict, model_state, batch_size: int):
    """`torch.export` of `make_predict_fn` at `batch_size` on the
    parameters' device; the weights are constants of the program."""
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
        return torch.export.export(_Predict(predict), example)


def export_program(cfg: ModelConfig, params: dict, model_state, path: str,
                   batch_size: int = 1) -> str:
    """`torch.export` `make_predict_fn` at `batch_size` on the parameters'
    device and save the program to `path` (`torch.export.save`); the
    weights are constants of the program."""
    program = _trace(cfg, params, model_state, batch_size)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def _cpu_f32(tree):
    """A tree with every tensor detached, on the CPU, floating ones in
    float32."""
    if isinstance(tree, dict):
        return {k: _cpu_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu_f32(v) for v in tree]
    t = tree.detach().cpu()
    return t.float() if t.is_floating_point() else t


def export_savedmodel(cfg: ModelConfig, params: dict, model_state,
                      export_dir: str, batch_size: int = 1) -> str:
    """TF SavedModel at `export_dir` with the reference's `predict_images`
    signature: images f32 [B, H, W, 3], sentences int32 [B, T] and
    sequence_lenghts int32 [B] (sic) -> masks [B, H, W], B = `batch_size`.
    The plain route is traced in float32 on the CPU (parameters on the card
    are copied) and lowered op by op into TensorFlow, its weights saved as
    variables.  Returns `export_dir`.  A video config exports its image
    forward (one image per sentence), as the JAX package's exporter does:
    JAX's `apply_model` never dispatches to the video model.  A BERT config
    takes BERT features, not token ids, and raises ValueError (JAX's
    exporter fails there too)."""
    if cfg.text_encoder == "bert":
        raise ValueError(f"{cfg.variant}: a BERT config takes BERT features "
                         "[B, T, 768]; the predict_images signature takes "
                         "token ids")
    import tensorflow as tf

    from cmpc_refseg_torch.serving import tf_lowering

    cfg = cfg.replace(compute_dtype="float32", video=False)
    program = _trace(cfg, _cpu_f32(params), _cpu_f32(model_state or {}),
                     batch_size)
    module = tf_lowering.lower(program, [
        tf.TensorSpec([batch_size, cfg.H, cfg.W, 3], tf.float32,
                      name="images"),
        tf.TensorSpec([batch_size, cfg.num_steps], tf.int32,
                      name="sentences"),
        tf.TensorSpec([batch_size], tf.int32,
                      name="sequence_lenghts"),  # sic: the reference's typo
    ])
    tf.saved_model.save(module, export_dir, signatures={
        "predict_images": module.predict.get_concrete_function()})
    return export_dir


def load_program(path: str):
    """The saved program as a callable (images, sentences, lengths) ->
    masks."""
    return torch.export.load(path).module()
