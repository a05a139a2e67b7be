"""Optimizer: polynomial-decay Adam with the reference's bias-gradient
multiplier and trainable set (CMPC_model.py:426-478).

- poly LR: start 2.5e-4 -> 1e-5, power 0.9 over lr_decay_step
  (CMPC_model.py:450-452); the step clamps at the decay horizon.
- bias gradients x2 BEFORE Adam (the reference multiplies the gradient, not
  the lr, CMPC_model.py:462-475).
- trainable set: everything but the backbone (CMPC_model.py:427-432),
  and with conv5=True also the res3/4/5 conv kernels (never their folded
  BN constants; JAX optimizer.py:80-115).
- Adam is ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8: the same update
  as optax's adam); its lr is set before every update from
  `polynomial_lr(update)`, with `update` counting Adam's updates from 0 as
  optax's schedule count does.
- grad_accum = k (optax ``MultiSteps``): k micro-steps make one Adam
  update on the mean of their gradients, accumulated as optax's running
  mean (`accumulate`); the other micro-steps update nothing.
"""

from __future__ import annotations

import torch

from cmpc_refseg_torch.models.backbone import TRAINABLE_STAGES


def polynomial_lr(cfg):
    """`tf.train.polynomial_decay`: step -> lr, clamped at the horizon."""
    def schedule(step):
        frac = min(float(step), cfg.lr_decay_step) / cfg.lr_decay_step
        return ((cfg.start_lr - cfg.end_lr) * (1.0 - frac) ** cfg.lr_power
                + cfg.end_lr)
    return schedule


def named_leaves(tree, prefix=()):
    """(path, leaf) pairs of a parameter tree, depth first in the tree's
    order; a path is the tuple of dict keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def scale_bias_grads(tree) -> None:
    """Double the gradients of conv 'biases' leaves in place (reference
    lr-mult 2, CMPC_model.py:464-465; the LSTM's 'bias' and the layer
    norms are not matched, as by the reference's name filter)."""
    for path, leaf in named_leaves(tree):
        if "biases" in path and leaf.grad is not None:
            leaf.grad.mul_(2.0)


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """Adam over `params` (an iterable of tensors); the caller sets its lr
    from `polynomial_lr` before each step."""
    if cfg.optimizer != "adam":
        raise ValueError(f"Unknown optimizer type {cfg.optimizer!r}")
    return torch.optim.Adam(params, lr=cfg.start_lr, betas=(0.9, 0.999),
                            eps=1e-8)


# ---------------------------------------------------------------------------
# trainable/frozen partition
# ---------------------------------------------------------------------------

def accumulate(acc, grad, n_acc: int):
    """optax MultiSteps' running mean: acc + (grad - acc) / (n_acc + 1), in
    place on `acc`, after `n_acc` earlier micro-steps."""
    acc.add_((grad - acc) / (n_acc + 1))


def partition_params(params: dict, cfg):
    """Split the parameter tree into (trainable, frozen) trees: the head
    trains; the backbone is frozen but for, with conv5=True, the res3/4/5
    conv kernels 'w', which move into trainable['backbone'] (the JAX
    package's layout: {block: {unit: {'w': ...}}})."""
    trainable = {k: v for k, v in params.items() if k != "backbone"}
    frozen_bb, train_bb = {}, {}
    for name, block in params["backbone"].items():
        if cfg.conv5 and name.startswith(TRAINABLE_STAGES):
            train_bb[name] = {u: {"w": unit["w"]} for u, unit in block.items()}
            frozen_bb[name] = {u: {k: v for k, v in unit.items() if k != "w"}
                               for u, unit in block.items()}
        else:
            frozen_bb[name] = block
    if train_bb:
        trainable["backbone"] = train_bb
    return trainable, {"backbone": frozen_bb}


def merge_params(trainable: dict, frozen: dict) -> dict:
    """Inverse of partition_params (the backbone merged unit by unit)."""
    params = {k: v for k, v in trainable.items() if k != "backbone"}
    train_bb = trainable.get("backbone", {})
    params["backbone"] = {
        name: {u: {**unit, **train_bb[name][u]} for u, unit in block.items()}
        if name in train_bb else block
        for name, block in frozen["backbone"].items()}
    return params
