"""High-level API: build a model by reference name and run its forward.

>>> from cmpc_refseg_torch.api import build_model
>>> model = build_model("CMPC_model", batch_size=8, dtype="bfloat16")
>>> out = model.forward(batch)          # on the CUDA device

The model runs on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit device, `build_model` raises.
"""

from __future__ import annotations

import dataclasses

import torch

from cmpc_refseg_torch.config import ModelConfig, get_config
from cmpc_refseg_torch.convert import resolve_device
from cmpc_refseg_torch.models.model import (ModelOutputs, apply_model,
                                            init_model, prepare_params)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    params: dict
    device: torch.device

    def forward(self, batch: dict) -> ModelOutputs:
        """batch: 'im' [B,H,W,3], 'words' [B,T], 'seq_len' [B] (numpy or
        tensors); moved to the model's device."""
        feed = {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}
        with torch.inference_mode():
            return apply_model(self.params, self.cfg, feed)


def build_model(name: str, *, seed: int = 0, device=None, dtype=None,
                **overrides) -> Model:
    """Construct a variant by reference name with parameters from `seed`,
    on `device` (CUDA when None: the port never falls back to the CPU by
    itself).  `dtype` ('bfloat16' / 'float32' or a torch dtype) sets the
    compute dtype."""
    dev = resolve_device(device)
    if dtype is not None:
        overrides["compute_dtype"] = str(dtype).replace("torch.", "")
    cfg = get_config(name, **overrides)
    params = prepare_params(init_model(seed, cfg, device=dev), cfg)
    return Model(cfg=cfg, params=params, device=dev)
