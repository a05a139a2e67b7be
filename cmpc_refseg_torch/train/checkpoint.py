"""Checkpoints of the port's TrainState (reference: tf.train.Saver
snapshots with max_to_keep=4, trainval_model.py:56,136-142; the JAX
package saves the same state through orbax).

One file per step, ``<directory>/<step>/train_state.pt``, as orbax lays
out its steps: a ``torch.save`` of a dict of tensors keyed by the tree
paths of `optimizer.named_leaves`, read back with ``weights_only=True``:

- 'trainable', 'exp_avg', 'exp_avg_sq': the trainable weights (with
  conv5, the res3-5 conv kernels as trained) and Adam's moments (zeros
  before the first update), 'adam_step' Adam's count;
- 'accum' with grad_accum > 1: the running mean of the update in progress
  (zeros at an update boundary), so a resume mid-accumulation continues
  exactly;
- 'frozen': the frozen backbone in float32 (the state's `frozen_f32`,
  whatever the compute dtype);
- 'model_state': the ASPP decoder's BN moving statistics ({} for the
  multiscore decoder);
- 'step' (micro-steps, `TrainState.step`), and 'config': the config's
  name and fields.

A step is written under a temporary name, flushed to disk and moved into
place with ``os.replace``, so a kill in mid-save leaves no step behind
that `latest_step` would take.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
from typing import Optional

import torch

from cmpc_refseg_torch.convert import to_device
from cmpc_refseg_torch.models.model import prepare_backbone
from cmpc_refseg_torch.train.optimizer import named_leaves

FILE = "train_state.pt"
# fields a checkpoint may be restored across: the batch, and the compute
# dtype (the weights, Adam's moments and the saved backbone are float32)
RUNTIME_FIELDS = ("batch_size", "compute_dtype")


def _step_file(directory: str, step: int) -> str:
    return os.path.join(directory, str(step), FILE)


def _steps(directory: str) -> list:
    """The steps under `directory` whose file is complete, ascending."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isfile(_step_file(directory, n)))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under `directory`, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def saved_config(directory: str, step: Optional[int] = None):
    """The config step `step` (the newest when None) under `directory` was
    saved with: the registry's config of its name with its saved fields.
    The file is mapped, not read.  FileNotFoundError when there is no
    such step."""
    from cmpc_refseg_torch.config import get_config
    step = latest_step(directory) if step is None else step
    if step is None or not os.path.isfile(_step_file(directory, step)):
        raise FileNotFoundError(f"no checkpoint step {step} under "
                                f"{directory}")
    record = torch.load(_step_file(directory, step), map_location="cpu",
                        weights_only=True, mmap=True)["config"]
    return get_config(record["name"], **record["fields"])


def _config_record(cfg) -> dict:
    return {"name": cfg.variant, "fields": dataclasses.asdict(cfg)}


def _key(path) -> tuple:
    """A tree path with its strings interned: pickle writes a string once
    per object and refers back to it after, so keys that are equal but
    distinct objects (a restored tree's, a tree built by another code
    path) would give the same state other bytes."""
    return tuple(sys.intern(k) if isinstance(k, str) else k for k in path)


def _flat(tree) -> dict:
    return {_key(path): leaf.detach().cpu()
            for path, leaf in named_leaves(tree)}


def save_checkpoint(directory: str, state, step: int,
                    max_to_keep: int = 4) -> None:
    """Write `state` (a TrainState) as step `step` under `directory`, then
    remove all but the newest `max_to_keep` steps."""
    leaves = list(named_leaves(state.trainable))
    adam = [state.optimizer.state.get(p, {}) for _, p in leaves]
    moments = {key: {_key(path): (st[key] if st else torch.zeros_like(p))
                     .cpu()
                     for (path, p), st in zip(leaves, adam)}
               for key in ("exp_avg", "exp_avg_sq")}
    counts = [float(st["step"]) for st in adam if st]
    payload = {"config": _config_record(state.cfg), "step": int(state.step),
               "adam_step": counts[0] if counts else 0.0,
               "trainable": _flat(state.trainable), **moments,
               "frozen": _flat(state.frozen_f32),
               "model_state": _flat(state.model_state)}
    if state.cfg.grad_accum > 1:
        payload["accum"] = {
            _key(path): (torch.zeros_like(p) if state.accum is None
                         else a).detach().cpu()
            for (path, p), a in zip(leaves, state.accum or [None] *
                                    len(leaves))}
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, f".{FILE}.tmp-{os.getpid()}")
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _step_file(directory, step))
    fd = os.open(step_dir, os.O_RDONLY)
    try:
        os.fsync(fd)              # the rename itself
    finally:
        os.close(fd)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def _check_config(saved: dict, cfg) -> None:
    want = _config_record(cfg)
    fields = set(saved["fields"]) | set(want["fields"])
    diff = sorted(k for k in fields if k not in RUNTIME_FIELDS
                  and saved["fields"].get(k) != want["fields"].get(k))
    if saved["name"] != want["name"] or diff:
        raise ValueError(f"the checkpoint is of config {saved['name']!r}, "
                         f"the state of {want['name']!r}; fields that "
                         f"differ: {diff}")


def _load(template, saved: dict, what: str, device=None):
    """`template`'s tree with each leaf replaced by the saved tensor of its
    path, in the leaf's dtype, on `device` (the leaf's own when None);
    the paths and shapes must match."""
    paths = {path for path, _ in named_leaves(template)}
    if paths != set(saved):
        diff = sorted(map(str, paths ^ set(saved)))
        raise ValueError(f"checkpoint {what}: leaves differ from the "
                         f"state's: {diff[:4]}")

    def build(node, prefix=()):
        if isinstance(node, dict):
            return {k: build(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, prefix + (i,)) for i, v in enumerate(node)]
        value = saved[prefix]
        if value.shape != node.shape:
            raise ValueError(f"checkpoint {what} {prefix}: shape "
                             f"{tuple(value.shape)}, the state's "
                             f"{tuple(node.shape)}")
        return value.to(node.device if device is None else device,
                        node.dtype)
    return build(template)


def restore_checkpoint(directory: str, target, step: Optional[int] = None):
    """Load step `step` (the newest when None) into `target`, a TrainState
    of the same config up to RUNTIME_FIELDS, on the target's devices and
    dtypes; returns `target`.  Its Adam then holds the saved moments and
    count, so the next update is the one the saved state would make.
    FileNotFoundError when there is no such step."""
    step = latest_step(directory) if step is None else step
    if step is None or not os.path.isfile(_step_file(directory, step)):
        raise FileNotFoundError(f"no checkpoint step {step} under "
                                f"{directory}")
    ck = torch.load(_step_file(directory, step), map_location="cpu",
                    weights_only=True)
    _check_config(ck["config"], target.cfg)
    trainable = _load(target.trainable, ck["trainable"], "trainable",
                      device="cpu")
    moments = [dict(named_leaves(_load(target.trainable, ck[key], key)))
               for key in ("exp_avg", "exp_avg_sq")]
    with torch.no_grad():
        for (path, p), (_, value) in zip(named_leaves(target.trainable),
                                         named_leaves(trainable)):
            p.copy_(value)
            target.optimizer.state[p] = {
                "step": torch.tensor(ck["adam_step"], dtype=torch.float32),
                "exp_avg": moments[0][path], "exp_avg_sq": moments[1][path]}
    target.frozen_f32 = _load(target.frozen_f32, ck["frozen"], "frozen",
                              device="cpu")
    target.frozen = {"backbone": prepare_backbone(
        to_device(target.frozen_f32["backbone"], target.device),
        target.cfg)}
    target.model_state = _load(target.model_state, ck["model_state"],
                               "model_state")
    if target.cfg.grad_accum > 1:
        target.accum = [leaf for _, leaf in named_leaves(
            _load(target.trainable, ck["accum"], "accum"))]
    target.step = ck["step"]
    return target
