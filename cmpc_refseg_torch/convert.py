"""Bridge from the JAX package's parameter pytree, model state (the BN
moving statistics) and train state to the port's parameters, model state
and TrainState.

The port keeps the JAX pytree's structure and names.  Leaves become float32
tensors; the backbone's conv kernels go from HWIO to PyTorch's OIHW (the
backbone runs through ``F.conv2d``), a quantized backbone's int8 `w_q`
likewise, staying int8 (its `w_scale` and calibrated `x_scale` are
float32).  Head kernels stay HWIO, as the port's ``conv2d`` takes them (a
1x1 head conv is a channel matmul with DW[0, 0]); so do VGG16-FCN's.
"""

from __future__ import annotations

import re

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


def to_device(tree, device):
    """A tree of dicts and lists of tensors with every tensor moved to
    `device` (the same tensor where it is there already)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def _tensor(leaf, device):
    return torch.as_tensor(np.array(leaf, dtype=np.float32), device=device)


def _tree(node, device, in_backbone=False):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if in_backbone and k == "w":
                out[k] = _tensor(np.transpose(np.asarray(v), (3, 2, 0, 1)),
                                 device)
            elif in_backbone and k == "w_q":
                out[k] = torch.as_tensor(np.ascontiguousarray(np.transpose(
                    np.asarray(v, np.int8), (3, 2, 0, 1))), device=device)
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


def backbone_from_jax(tree: dict, *, device=None) -> dict:
    """A JAX backbone pytree alone (`init_backbone`, or `quantize_backbone`
    / `calibrate_backbone` of it) -> the port's backbone tree on `device`
    (CUDA when None)."""
    return _tree(tree, resolve_device(device), in_backbone=True)


def vgg16_fcn_from_jax(tree: dict, *, device=None) -> dict:
    """JAX VGG16-FCN parameters (`init_vgg16_fcn`) -> float32 tensors on
    `device` (CUDA when None), HWIO kernels as the port's ``conv2d`` takes
    them."""
    return _tree(tree, resolve_device(device))


_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def params_from_npz(path, cfg: ModelConfig, *, device=None) -> dict:
    """The port's parameters from the .npz that
    tools/convert_tf_checkpoint.py writes: one array per leaf of the JAX
    parameter pytree, keyed by its path as ``jax.tree_util.keystr`` prints
    it (``['backbone']['conv1']['w']``, a list index as ``[0]``).  The file
    holds the parameters only: the ASPP decoder's BN moving statistics are
    not in it (tools/tf_checkpoint_to_torch.py keeps them)."""
    tree: dict = {}
    with np.load(path) as npz:
        for name in npz.files:
            keys = [k if k else int(i) for k, i in _KEY.findall(name)]
            if not keys or keystr(keys) != name:
                raise ValueError(f"{path}: {name!r} is not a tree path")
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = npz[name]
    return params_from_jax(_lists(tree), cfg, device=device)


def keystr(path) -> str:
    """A tree path (dict keys and list indices) as ``jax.tree_util.keystr``
    prints it: ``['backbone']['conv1']['w']``, a list index as ``[0]``."""
    return "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def npz_arrays(tree, path=()) -> dict:
    """{keystr(path): array} of each leaf of a numpy parameter tree in the
    JAX layout: the .npz that tools/convert_tf_checkpoint.py writes, which
    `params_from_npz` reads."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {keystr(path): np.asarray(tree)}
    return {k: v for key, node in items
            for k, v in npz_arrays(node, path + (key,)).items()}


def _lists(node):
    """Nested dicts whose keys are all ints (list indices) become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


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
                         step=None, accum=None, device=None):
    """The port's TrainState from a JAX train state: the trainable and
    frozen trees (with conv5, the res3-5 kernels in the trainable one) and
    Adam's first and second moments `mu`, `nu` (trees of the trainable's
    structure), `count` and the BN moving statistics `model_state` ({} or
    None for the multiscore decoder; required by the ASPP decoder), all as
    numpy (the JAX package's ``state.unravel(...)`` of its flat vectors).
    Under grad_accum > 1 the JAX optimizer is optax's MultiSteps: `count`
    is its inner Adam's, `step` the state's micro-step count and `accum`
    its `acc_grads` tree.  The port's Adam then holds the same exp_avg,
    exp_avg_sq and step, and the state's step is `step` (`count` when
    None)."""
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
    state.step = int(count if step is None else step)
    if accum is not None:
        state.accum = [leaf for _, leaf in
                       named_leaves(_convert(accum, device))]
    return state
