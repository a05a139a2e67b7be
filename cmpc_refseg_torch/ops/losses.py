"""Segmentation losses of the flagship's train step (reference:
util/loss.py).

The losses take logits and labels shaped [B, H, W, 1] and reduce as the
reference does: a per-sample sum over (H, W, C), then the mean over the
batch, so the loss scales with H*W as the reference's Adam dynamics expect.
The other losses of the JAX package's ops/losses.py (dice, soft IoU, the
box losses) wait for the variants that use them.
"""

from __future__ import annotations

import torch


def sigmoid_cross_entropy(logits, labels):
    """`tf.nn.sigmoid_cross_entropy_with_logits`:
    max(x, 0) - x*z + log(1 + exp(-|x|)), numerically stable."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def weighed_logistic_loss(scores, labels, pos_loss_mult=1.0,
                          neg_loss_mult=1.0):
    """util/loss.py:6-16: weighted per-pixel sigmoid cross entropy, summed
    over H, W and C, averaged over the batch."""
    loss_mult = labels * (pos_loss_mult - neg_loss_mult) + neg_loss_mult
    per_pix = sigmoid_cross_entropy(scores, labels) * loss_mult
    return torch.mean(torch.sum(per_pix, dim=(1, 2, 3)))


def l2_regularization_loss(params_list, weight_decay: float):
    """util/loss.py:28-32: wd * sum over the leaves of 0.5 * ||w||^2."""
    return weight_decay * sum(0.5 * torch.sum(torch.square(p))
                              for p in params_list)
