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
- Under a (data x model) layout, `ZeroAdam`: each rank holds Adam's
  state for one segment of the flat trainable vector only (ZeRO, the JAX
  package's P(("data", "model")) of its master vector and moments).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cmpc_refseg_torch.models.backbone import TRAINABLE_STAGES
from cmpc_refseg_torch.parallel.mesh import (Mesh, all_gather_flat,
                                             gather_flat, gather_shards,
                                             reduce_scatter_mean)


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
    """Adam over `params` (an iterable of tensors of one device); the
    caller sets its lr from `polynomial_lr` before each step.  The
    implementation is pinned, torch's default for the device (foreach on
    CUDA, one tensor at a time on the CPU), so that Adam over leaves and
    Adam over one flat segment (`ZeroAdam`) make the same update bit for
    bit."""
    if cfg.optimizer != "adam":
        raise ValueError(f"Unknown optimizer type {cfg.optimizer!r}")
    params = list(params)
    return torch.optim.Adam(params, lr=cfg.start_lr, betas=(0.9, 0.999),
                            eps=1e-8, foreach=params[0].is_cuda)


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


def rebuild(tree, leaves):
    """`tree`'s structure with its leaves replaced, in `named_leaves`
    order, by `leaves`."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it)
    return walk(tree)


class ZeroAdam:
    """Adam ZeRO-sharded over a layout's world, beside the layout's tensor
    parallel storage.

    The flat trainable vector (every leaf in `named_leaves` order, in
    float32, zero-padded to a multiple of the world's W ranks) is cut
    into W contiguous segments; rank r owns segment r: its float32 master
    copy (`master`) and Adam's moments of it (`optimizer`, a
    ``torch.optim.Adam`` over that one tensor), and nothing else of the
    optimizer.  A leaf whose `dims` entry is an int is stored as the
    rank's contiguous slice of it along that dim, in model-rank order
    (`shard`); the others whole.

    An update (`update`): the full gradients, flattened, are
    reduce-scattered over the world as a mean, Adam steps the segment,
    the segments are all-gathered, and each rank writes its shards and
    its whole leaves back.  Pad entries stay zero (their gradient is
    zero, so is Adam's step of them) and reach no leaf."""

    def __init__(self, cfg, mesh: Mesh, leaves, dims):
        leaves = list(leaves)
        self.mesh = mesh
        self.shapes = [tuple(t.shape) for t in leaves]
        self.sizes = [t.numel() for t in leaves]
        # a model axis of 1 splits nothing
        self.dims = list(dims) if mesh.model_size > 1 else [None] * len(leaves)
        self.numel = sum(self.sizes)
        self.segment = -(-self.numel // mesh.world_size)
        start = mesh.rank * self.segment
        self.master = self.flatten(leaves)[start:start + self.segment] \
            .clone().requires_grad_()
        self.optimizer = make_optimizer(cfg, [self.master])

    def flatten(self, tensors) -> torch.Tensor:
        """Full leaves (or their gradients) as the padded flat float32
        vector."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        return F.pad(flat, (0, self.segment * self.mesh.world_size
                            - self.numel))

    def unflatten(self, flat: torch.Tensor) -> list:
        """The padded flat vector as views of the full leaves."""
        return [t.view(shape) for t, shape in zip(
            torch.split(flat[:self.numel], self.sizes), self.shapes)]

    def shard(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """What this rank stores of leaf i, given the full leaf."""
        dim = self.dims[i]
        if dim is None:
            return full
        n = full.shape[dim] // self.mesh.model_size
        return full.narrow(dim, self.mesh.model_index * n, n)

    def shard_tree(self, trainable: dict) -> dict:
        """The full `trainable` tree as this rank stores it: each engaged
        leaf replaced by a new leaf holding its shard."""
        return rebuild(trainable, [
            t if self.dims[i] is None else self.shard(t.detach(), i).clone()
            for i, (_, t) in enumerate(named_leaves(trainable))])

    def gather(self, trainable: dict, requires_grad: bool = True) -> dict:
        """The full tree from the rank's storage (one all-gather over the
        model group, collective): each engaged leaf a new full leaf, the
        others the stored tensors themselves."""
        stored = [t for _, t in named_leaves(trainable)]
        engaged = [i for i, d in enumerate(self.dims) if d is not None]
        full = gather_shards([stored[i] for i in engaged],
                             [self.dims[i] for i in engaged], self.mesh)
        for i, t in zip(engaged, full):
            stored[i] = t.requires_grad_(requires_grad)
        return rebuild(trainable, stored)

    def write_back(self, trainable: dict, flat: torch.Tensor) -> None:
        """Each stored leaf of `trainable` set, in place, to its part of
        the full flat vector `flat`."""
        with torch.no_grad():
            for i, ((_, t), full) in enumerate(zip(named_leaves(trainable),
                                                   self.unflatten(flat))):
                t.copy_(self.shard(full, i))

    def update(self, trainable: dict, grads, lr: float) -> None:
        """One Adam update at `lr` from the ranks' full gradients `grads`
        (one per leaf), their mean over the world taken by a
        reduce-scatter; the stored leaves of `trainable` updated in
        place."""
        self.master.grad = reduce_scatter_mean(self.flatten(grads))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.master.grad = None
        self.write_back(trainable, all_gather_flat(self.master.detach()))

    def moments(self) -> tuple:
        """(exp_avg, exp_avg_sq, step) of the segment: zeros and 0 before
        the first update."""
        st = self.optimizer.state.get(self.master)
        if not st:
            zero = torch.zeros_like(self.master.detach())
            return zero, zero, 0.0
        return st["exp_avg"], st["exp_avg_sq"], float(st["step"])

    def consolidate(self):
        """The whole optimizer as one process holds it, on rank 0 only
        (collective; the segments are gathered there alone): the full
        weights, exp_avg and exp_avg_sq as lists of full leaves (views of
        the gathered vectors), and Adam's step count.  None on the other
        ranks."""
        mu, nu, step = self.moments()
        flats = [gather_flat(seg.detach()) for seg in (self.master, mu, nu)]
        if flats[0] is None:
            return None
        return tuple(self.unflatten(flat) for flat in flats) + (step,)

    def load(self, weights, exp_avg, exp_avg_sq, step: float) -> None:
        """Set the segment's master copy and Adam's state from full
        leaves (weights, moments) and a step count."""
        start = self.mesh.rank * self.segment

        def seg(leaves):
            return self.flatten(leaves)[start:start + self.segment].to(
                self.master.device)
        with torch.no_grad():
            self.master.copy_(seg(weights))
        self.optimizer.state[self.master] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": seg(exp_avg), "exp_avg_sq": seg(exp_avg_sq)}
