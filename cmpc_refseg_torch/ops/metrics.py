"""Evaluation metrics (reference: util/eval_tools.py,
util/processing_tools.py).

The mask terms come as (intersection, union) pairs on the device, so an
evaluation loop sums them there and divides on the host: the reference's
running cum_I / cum_U counters (trainval_model.py:267-284).  The numpy
parts are a copy of the JAX package's ops/metrics.py (the port imports
nothing of it).
"""

from __future__ import annotations

import numpy as np
import torch

# thresholds of the reference eval printout (trainval_model.py:161)
EVAL_PRECISION_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)


def mask_intersection_union(pred: torch.Tensor, target: torch.Tensor):
    """compute_mask_IU (util/eval_tools.py:31-35): pred and target are
    masks of one shape, any nonzero entry foreground; returns the scalar
    (I, U) as int64 tensors on their device."""
    pred, target = pred.bool(), target.bool()
    return (pred & target).sum(), (pred | target).sum()


def batched_mask_iu(pred: torch.Tensor, target: torch.Tensor):
    """Per-sample (I, U) [B] (int64, on the masks' device) of [B, ...]
    masks."""
    pred, target = pred.bool(), target.bool()
    dims = tuple(range(1, pred.dim()))
    return (pred & target).sum(dim=dims), (pred | target).sum(dim=dims)


def seg_accuracy(scores: np.ndarray, labels: np.ndarray):
    """compute_accuracy (util/processing_tools.py:24-35)."""
    is_pos = labels != 0
    is_neg = np.logical_not(is_pos)
    num_pos = int(np.sum(is_pos))
    num_neg = int(np.sum(is_neg))
    is_correct = np.logical_xor(scores < 0, is_pos)
    acc_all = np.sum(is_correct) / (num_pos + num_neg)
    acc_pos = np.sum(is_correct[is_pos]) / (num_pos + 1)
    acc_neg = np.sum(is_correct[is_neg]) / num_neg
    return acc_all, acc_pos, acc_neg


def compute_bbox_iou(boxes_pred, boxes_gt):
    """[x1, y1, x2, y2] IoU (util/eval_tools.py:8-28)."""
    boxes_pred = np.asarray(boxes_pred, dtype=np.float64).reshape(-1, 4)
    boxes_gt = np.asarray(boxes_gt, dtype=np.float64).reshape(-1, 4)
    area_p = ((boxes_pred[:, 2] - boxes_pred[:, 0] + 1)
              * (boxes_pred[:, 3] - boxes_pred[:, 1] + 1))
    area_g = ((boxes_gt[:, 2] - boxes_gt[:, 0] + 1)
              * (boxes_gt[:, 3] - boxes_gt[:, 1] + 1))
    ix1 = np.maximum(boxes_pred[:, 0], boxes_gt[:, 0])
    iy1 = np.maximum(boxes_pred[:, 1], boxes_gt[:, 1])
    ix2 = np.minimum(boxes_pred[:, 2], boxes_gt[:, 2])
    iy2 = np.minimum(boxes_pred[:, 3], boxes_gt[:, 3])
    iw = np.maximum(ix2 - ix1 + 1, 0)
    ih = np.maximum(iy2 - iy1 + 1, 0)
    inter = iw * ih
    return inter / (area_p + area_g - inter)


class SegEvalAccumulator:
    """Running cumulative and mean IoU and precision@X, the reference eval
    loop's counters (trainval_model.py:207-294).  A sample counts at a
    threshold when its IoU is at least that threshold."""

    def __init__(self, thresholds=EVAL_PRECISION_THRESHOLDS):
        self.thresholds = tuple(thresholds)
        self.cum_i = 0.0
        self.cum_u = 0.0
        self.mean_iou_sum = 0.0
        self.seg_correct = np.zeros(len(self.thresholds), dtype=np.int64)
        self.seg_total = 0

    def update(self, i, u):
        i = float(i)
        u = float(u)
        self.cum_i += i
        self.cum_u += u
        iou = i / u if u > 0 else 0.0
        self.mean_iou_sum += iou
        for k, thr in enumerate(self.thresholds):
            if iou >= thr:
                self.seg_correct[k] += 1
        self.seg_total += 1

    def result(self) -> dict:
        out = {
            "overall_iou": self.cum_i / max(self.cum_u, 1e-12),
            "mean_iou": self.mean_iou_sum / max(self.seg_total, 1),
            "n": self.seg_total,
        }
        for k, thr in enumerate(self.thresholds):
            out[f"prec@{thr}"] = (
                self.seg_correct[k] / max(self.seg_total, 1))
        return out
