"""High-level API: build a model, a predict service or a trainer by
reference name.

>>> from cmpc_refseg_torch.api import build_model, build_service
>>> model = build_model("CMPC_model", batch_size=8, dtype="bfloat16")
>>> out = model.forward(batch)          # on the CUDA device
>>> service = build_service("CMPC_model", dtype="bfloat16")
>>> prob, mask = service.predict(image_rgb, "the man on the left")
>>> trainer = build_trainer("CMPC_model", batch_size=8, dtype="bfloat16")
>>> metrics = trainer.step(batch)       # one Adam update
>>> trainer.train(reader, max_iter=1000)

Under a process group, ``build_trainer(..., mesh=make_mesh((d, m)))``
(``parallel/mesh.py``) lays the trainer out for tensor parallelism and
ZeRO; its `step` then takes the rows of the rank's data slot
(``shard_batch(batch, mesh)``).

All run on CUDA unless the caller passes ``device="cpu"``; with no CUDA
device and no explicit device, they raise.  The weights come from `seed`
(and the embedding from `glove` [vocab_size, glove_dim] when given, as the
reference starts from GloVe)
(no trained checkpoint ships with the repository: ``train.checkpoint.
restore_checkpoint`` loads one into ``trainer.state``, and
tools/jax_checkpoint_to_torch.py and tools/tf_checkpoint_to_torch.py
turn a JAX package or TF checkpoint into one); the model state (the
ASPP decoder's BN moving statistics, {} for the multiscore decoder) is
built with them at its initial values and passed along: `Model`
and `PredictService` hold it, `Trainer.state.model_state` updates it.
"""

from __future__ import annotations

import dataclasses

import torch

from cmpc_refseg_torch.config import ModelConfig, get_config
from cmpc_refseg_torch.convert import resolve_device
from cmpc_refseg_torch.data.text import synthetic_vocab
from cmpc_refseg_torch.models.model import (ModelOutputs, apply_model,
                                            init_model, init_model_state,
                                            prepare_params)
from cmpc_refseg_torch.serving.server import PredictService
from cmpc_refseg_torch.train.trainer import (TrainState, create_train_state,
                                             make_train_step, train_loop)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    params: dict
    model_state: dict
    device: torch.device

    def forward(self, batch: dict) -> ModelOutputs:
        """batch: 'im' [B,H,W,3], 'words' [B,T] and 'seq_len' [B]
        (back-padded) or 'valid_idx' [B] (front-padded), or for the 'bert'
        encoder 'words_feat' [B,T,768] and 'sequence_mask' [B,T]; numpy or
        tensors, moved to the model's device."""
        feed = {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}
        with torch.inference_mode():
            return apply_model(self.params, self.cfg, feed,
                               model_state=self.model_state)


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    state: TrainState

    def __post_init__(self):
        self._step = make_train_step(self.cfg)

    def step(self, batch: dict) -> dict:
        """One train step on `batch` (see `trainer.make_train_step`):
        updates the state, returns the metrics."""
        return self._step(self.state, batch)

    def train(self, reader, *, max_iter: int, **kw) -> TrainState:
        """`trainer.train_loop` from this state over `reader`."""
        self.state = train_loop(self.cfg, reader, max_iter=max_iter,
                                state=self.state, **kw)
        return self.state


def _config(name: str, dtype, overrides: dict) -> ModelConfig:
    if dtype is not None:
        overrides["compute_dtype"] = str(dtype).replace("torch.", "")
    return get_config(name, **overrides)


def build_model(name: str, *, seed: int = 0, glove=None, device=None,
                dtype=None, **overrides) -> Model:
    """Construct a variant by reference name with parameters from `seed`
    (the embedding from `glove` when given), on `device` (CUDA when None:
    the port never falls back to the CPU by itself).  `dtype` ('bfloat16' /
    'float32' or a torch dtype) sets the compute dtype."""
    dev = resolve_device(device)
    cfg = _config(name, dtype, overrides)
    params = prepare_params(init_model(seed, cfg, glove, device=dev), cfg)
    return Model(cfg=cfg, params=params,
                 model_state=init_model_state(cfg, device=dev), device=dev)


def build_service(name: str, *, seed: int = 0, glove=None, device=None,
                  dtype=None, vocab=None, quantize: bool = False,
                  calibration_images=None, **overrides) -> PredictService:
    """A batch-1 `PredictService` for variant `name` with parameters from
    `seed` (the embedding from `glove` when given), on `device` (CUDA when
    None).  `vocab` is a word -> index map; when None, a synthetic
    vocabulary of the config's size stands in for the reference's
    vocabulary file.  `quantize` and `calibration_images`: the service's
    int8 backbone.  A 'bert' config raises: the service tokenizes an
    expression, and BERT features come from a model outside the
    repository."""
    dev = resolve_device(device)
    cfg = _config(name, dtype, {**overrides, "batch_size": 1})
    return PredictService(cfg, init_model(seed, cfg, glove, device=dev),
                          vocab or synthetic_vocab(cfg.vocab_size),
                          model_state=init_model_state(cfg, device=dev),
                          device=dev, quantize=quantize,
                          calibration_images=calibration_images)


def build_trainer(name: str, *, seed: int = 0, glove=None, device=None,
                  dtype=None, mesh=None, **overrides) -> Trainer:
    """A `Trainer` for variant `name` from parameters drawn from `seed` (the
    embedding from `glove` when given), on `device` (CUDA when None; raises
    without it).  `dtype` sets the compute dtype; the trainable weights and
    Adam's moments stay float32.  With `mesh` (``parallel.mesh.make_mesh``)
    the state is laid out on it: the leaves whose output channels are at
    least 512 wide stored split over its model axis, Adam sharded over its
    world (``trainer.shard_train_state``)."""
    cfg = _config(name, dtype, overrides)
    return Trainer(cfg=cfg, state=create_train_state(
        seed, cfg, glove, device=resolve_device(device), mesh=mesh))


def get_segmentation_model(name: str, **kwargs) -> Model:
    """Name-compatible entry point (reference: get_model.py:15-17, which
    `eval()`s the model name; the JAX package's api.get_segmentation_model):
    `build_model(name, **kwargs)`."""
    return build_model(name, **kwargs)
