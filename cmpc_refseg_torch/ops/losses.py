"""Losses (reference: util/loss.py).

The losses take logits and labels shaped [B, H, W, 1] and reduce as the
reference does: a per-sample sum over (H, W, C), then the mean over the
batch, so the loss scales with H*W as the reference's Adam dynamics expect.
Dice, soft IoU, thresholded IoU and smooth L1 follow the JAX package's
ops/losses.py as well; no train path of either package calls them (they
are kept for parity with that module, held against it by the tests).
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


def dsc_loss(scores, labels):
    """Dice loss (util/loss.py:34-40)."""
    probs = torch.sigmoid(scores)
    inter = 2.0 * torch.sum(probs * labels, dim=(1, 2, 3))
    union = torch.sum(probs, dim=(1, 2, 3)) + torch.sum(labels, dim=(1, 2, 3))
    return torch.mean(1.0 - inter / union)


def iou_loss(scores, labels):
    """Soft-IoU loss (util/loss.py:42-49)."""
    probs = torch.sigmoid(scores)
    inter = torch.sum(probs * labels, dim=(1, 2, 3))
    union = (torch.sum(probs, dim=(1, 2, 3)) + torch.sum(labels, dim=(1, 2, 3))
             - inter)
    return torch.mean(1.0 - inter / union)


def iou_with_threshold(scores_a, scores_b, threshold: float = 0.5):
    """IoU of two sigmoid maps thresholded to masks (util/loss.py:51-68)."""
    mask_a = (scores_a > threshold).float()
    mask_b = (scores_b > threshold).float()
    inter = torch.sum(mask_a * mask_b, dim=(1, 2, 3))
    union = (torch.sum(mask_a, dim=(1, 2, 3))
             + torch.sum(mask_b, dim=(1, 2, 3)) - inter)
    return torch.mean(inter / union)


def smooth_l1_loss(scores, labels, ld: float = 1.0):
    """Smooth-L1 box loss (util/loss.py:72-80); the branch selector carries
    no gradient."""
    diff = scores - labels
    abs_diff = torch.abs(diff)
    sign = (abs_diff < 1.0).float().detach()
    raw = torch.square(diff) * 0.5 * sign + (abs_diff - 0.5) * (1.0 - sign)
    return ld * torch.mean(torch.sum(raw, dim=1))
