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

A state laid out on a (data x model) layout (``TrainState.zero``) saves
the same file one process writes: the segments of the master weights and
of Adam's moments are gathered onto rank 0 alone (and the world's mean of
the accumulators reduced there), and rank 0 writes.  Restored onto a
layout, any such file (of one process, or of another layout) is cut into
the target's shards and segment.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
from typing import Optional

import torch
import torch.distributed as dist

from cmpc_refseg_torch.convert import to_device
from cmpc_refseg_torch.models.model import prepare_backbone
from cmpc_refseg_torch.train.optimizer import named_leaves, rebuild

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


def _optimizer_trees(state):
    """(weights, exp_avg, exp_avg_sq, accum) as lists of full leaves in
    `named_leaves` order (accum None without grad_accum), and Adam's
    count: the state's own, or under a layout gathered onto rank 0 alone
    (collective; accum the world's mean of the ranks' accumulators) and
    None on the other ranks."""
    if state.zero is not None:
        return _gathered_trees(state)
    weights = [p for _, p in named_leaves(state.trainable)]
    adam = [state.optimizer.state.get(p, {}) for p in weights]
    mu, nu = ([st[key] if st else torch.zeros_like(p)
               for p, st in zip(weights, adam)]
              for key in ("exp_avg", "exp_avg_sq"))
    counts = [float(st["step"]) for st in adam if st]
    accum = None
    if state.cfg.grad_accum > 1:
        accum = state.accum or [torch.zeros_like(p) for p in weights]
    return weights, mu, nu, accum, counts[0] if counts else 0.0


def _gathered_trees(state):
    """`_optimizer_trees` of a state under a layout: the segments
    gathered and the accumulators reduced onto rank 0 only."""
    zero = state.zero
    whole = zero.consolidate()
    accum = None
    if state.cfg.grad_accum > 1:
        flat = zero.flatten(state.accum) if state.accum is not None else \
            zero.master.new_zeros(zero.segment * zero.mesh.world_size)
        dist.reduce(flat, dst=0)
        accum = zero.unflatten(flat.div_(zero.mesh.world_size))
    if whole is None:
        return None
    weights, mu, nu, count = whole
    return weights, mu, nu, accum, count


def save_checkpoint(directory: str, state, step: int,
                    max_to_keep: int = 4) -> None:
    """Write `state` (a TrainState) as step `step` under `directory`, then
    remove all but the newest `max_to_keep` steps.  A state under a layout
    is gathered onto rank 0, which writes it; every rank must call this."""
    trees = _optimizer_trees(state)
    if trees is None:
        return
    weights, mu, nu, accum, count = trees
    paths = [_key(path) for path, _ in named_leaves(state.trainable)]

    def by_path(tensors):
        # a copy each: a layout's leaves are views of one gathered vector,
        # whose whole storage torch.save would write with each
        return {path: t.detach().to("cpu", copy=True)
                for path, t in zip(paths, tensors)}
    payload = {"config": _config_record(state.cfg), "step": int(state.step),
               "adam_step": count, "trainable": by_path(weights),
               "exp_avg": by_path(mu), "exp_avg_sq": by_path(nu),
               "frozen": _flat(state.frozen_f32),
               "model_state": _flat(state.model_state)}
    if accum is not None:
        payload["accum"] = by_path(accum)
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
    dtypes, and under the target's layout if it has one (cut into its
    shards and segment; every rank reads the file); returns `target`.
    Its Adam then holds the saved moments and count, so the next update
    is the one the saved state would make.
    FileNotFoundError when there is no such step."""
    step = latest_step(directory) if step is None else step
    if step is None or not os.path.isfile(_step_file(directory, step)):
        raise FileNotFoundError(f"no checkpoint step {step} under "
                                f"{directory}")
    ck = torch.load(_step_file(directory, step), map_location="cpu",
                    weights_only=True)
    _check_config(ck["config"], target.cfg)
    zero = target.zero
    # a template of the full leaves (under a layout the stored ones are
    # shards)
    template = target.trainable if zero is None else rebuild(
        target.trainable, [torch.empty(s, device="meta")
                           for s in zero.shapes])
    device = target.device
    trainable = _load(template, ck["trainable"], "trainable", device="cpu")
    moments = [dict(named_leaves(_load(template, ck[key], key,
                                       device=device)))
               for key in ("exp_avg", "exp_avg_sq")]
    if zero is not None:
        weights = [v for _, v in named_leaves(trainable)]
        zero.load(weights, *([m[p] for p, _ in named_leaves(template)]
                             for m in moments), ck["adam_step"])
        zero.write_back(target.trainable, zero.flatten(weights).to(device))
    else:
        with torch.no_grad():
            for (path, p), (_, value) in zip(named_leaves(target.trainable),
                                             named_leaves(trainable)):
                p.copy_(value)
                target.optimizer.state[p] = {
                    "step": torch.tensor(ck["adam_step"],
                                         dtype=torch.float32),
                    "exp_avg": moments[0][path],
                    "exp_avg_sq": moments[1][path]}
    target.frozen_f32 = _load(target.frozen_f32, ck["frozen"], "frozen",
                              device="cpu")
    target.frozen = {"backbone": prepare_backbone(
        to_device(target.frozen_f32["backbone"], target.device),
        target.cfg)}
    target.model_state = _load(target.model_state, ck["model_state"],
                               "model_state")
    if target.cfg.grad_accum > 1:
        target.accum = [leaf for _, leaf in named_leaves(
            _load(template, ck["accum"], "accum", device=device))]
    target.step = ck["step"]
    return target
