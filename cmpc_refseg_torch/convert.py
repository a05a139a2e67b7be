"""Bridge from the JAX package's parameter pytree, model state (the BN
moving statistics) and train state to the port's parameters, model state
and TrainState.

The port keeps the JAX pytree's structure and names.  Leaves become float32
tensors; the backbone's conv kernels go from HWIO to PyTorch's OIHW (the
backbone runs through ``F.conv2d``).  Head kernels stay HWIO, as the port's
``conv2d`` takes them (a 1x1 head conv is a channel matmul with DW[0, 0]).
"""

from __future__ import annotations

import numpy as np
import torch

from cmpc_refseg_torch.config import ModelConfig
from cmpc_refseg_torch.models.backbone import resnet_stages


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when None: the port never falls back to the CPU by
    itself, so asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain versions on the CPU")
    return dev


def _tensor(leaf, device):
    return torch.as_tensor(np.array(leaf, dtype=np.float32), device=device)


def _tree(node, device, in_backbone=False):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if in_backbone and k == "w":
                out[k] = _tensor(np.transpose(np.asarray(v), (3, 2, 0, 1)),
                                 device)
            else:
                out[k] = _tree(v, device, in_backbone)
        return out
    if isinstance(node, (list, tuple)):
        return [_tree(v, device, in_backbone) for v in node]
    return _tensor(node, device)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """JAX parameter pytree (numpy leaves, as the JAX package's init_model
    or a checkpoint gives them) -> the port's parameters on `device` (CUDA
    when None; raises without it)."""
    device = resolve_device(device)
    blocks = {f"{stage}{b}" for stage, names, *_ in
              resnet_stages(cfg.res4_blocks) for b in names} | {"conv1"}
    if set(tree["backbone"]) != blocks:
        raise ValueError("backbone blocks do not match res4_blocks="
                         f"{cfg.res4_blocks}")
    if tuple(tree["levels"]) != tuple(cfg.levels):
        raise ValueError(f"levels {tuple(tree['levels'])} do not match the "
                         f"config's {tuple(cfg.levels)}")
    return _convert(tree, device)


def _convert(tree: dict, device) -> dict:
    return {k: _tree(v, device, in_backbone=k == "backbone")
            for k, v in tree.items()}


def model_state_from_jax(tree: dict, *, device=None) -> dict:
    """JAX model state (the BN moving statistics init_model returns beside
    the params, or a train state's `model_state`; numpy leaves) -> the
    same tree of float32 tensors on `device` (CUDA when None)."""
    return _tree(tree, resolve_device(device))


def train_state_from_jax(trainable: dict, frozen: dict, mu: dict, nu: dict,
                         count, cfg: ModelConfig, *, model_state=None,
                         device=None):
    """The port's TrainState from a JAX train state: the trainable and
    frozen trees and Adam's first and second moments `mu`, `nu` (trees of
    the trainable's structure), `count` and the BN moving statistics
    `model_state` ({} or None for the multiscore decoder; required by the
    ASPP decoder), all as numpy (the JAX package's ``state.unravel(...)``
    of its flat vectors).  The port's Adam then holds the same exp_avg,
    exp_avg_sq and step, and the state's step is `count`."""
    from cmpc_refseg_torch.train.optimizer import merge_params, named_leaves
    from cmpc_refseg_torch.train.trainer import train_state_from_params
    device = resolve_device(device)
    if model_state is None and cfg.decoder != "multiscore":
        raise ValueError("the ASPP decoder's train state needs model_state")
    state = train_state_from_params(
        params_from_jax(merge_params(trainable, frozen), cfg, device=device),
        cfg, model_state_from_jax(model_state or {}, device=device))
    moments = [dict(named_leaves(_convert(m, device))) for m in (mu, nu)]
    for path, p in named_leaves(state.trainable):
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moments[0][path], "exp_avg_sq": moments[1][path]}
    state.step = int(count)
    return state
