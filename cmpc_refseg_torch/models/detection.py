"""The YOLO-style detection head of CMPCv5_plus_model (the JAX package's
models/detection.py).

The reference's v5+ train script feeds `label_bbox [B, S, S, 3, 5]` and
`true_bbox [B, 1, 4]` with anchors from data/anchors.txt
(trainval_model_v5+.py:74-75, 92-102, 123-124); the model file that defines
the head is absent from the reference snapshot, and the JAX package
supplies one consistent with that script and with the label assigner
(``data/anchors.py``):

- head: a 3x3 conv on the fused feature -> [B, S, S, A, 5] raw predictions,
  in float32;
- decode: xy = (cell + sigmoid(t_xy)) * stride, wh = anchor *
  exp(clip(t_wh, -10, 8)) * stride, conf = sigmoid(t_conf), in input
  pixels as the labels are;
- loss: GIoU on the assigned anchors scaled by 2 - area / input^2, and
  sigmoid cross-entropy objectness with an ignore band where a predicted
  box overlaps a true box with IoU > 0.5.

Plain PyTorch: the JAX package has no Pallas kernel for the head.
"""

from __future__ import annotations

import torch

from cmpc_refseg_torch.ops.layers import conv2d, init_conv
from cmpc_refseg_torch.ops.losses import sigmoid_cross_entropy

IGNORE_IOU = 0.5


def init_bbox_head(key, cfg):
    return {"conv": init_conv(key, 3, cfg.mlp_dim, cfg.num_anchors * 5)}


def apply_bbox_head(params, fused, anchors, *, stride: int = 8):
    """fused [B, S, S, mlp] -> (raw, decoded), both [B, S, S, A, 5] f32;
    decoded = (x, y, w, h in input pixels, objectness probability).
    anchors [A, 2] in cells of `stride` pixels."""
    b, s1, s2, _ = fused.shape
    a = anchors.shape[0]
    raw = conv2d(params["conv"], fused.float()).reshape(b, s1, s2, a, 5)
    gy, gx = torch.meshgrid(
        torch.arange(s1, dtype=torch.float32, device=fused.device),
        torch.arange(s2, dtype=torch.float32, device=fused.device),
        indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]  # [1,S,S,1,2]
    xy = (torch.sigmoid(raw[..., 0:2]) + grid) * stride
    wh = torch.exp(torch.clamp(raw[..., 2:4], -10.0, 8.0)) * \
        torch.as_tensor(anchors, dtype=torch.float32,
                        device=fused.device) * stride
    conf = torch.sigmoid(raw[..., 4:5])
    return raw, torch.cat([xy, wh, conf], dim=-1)


def _corners(b):
    return torch.cat([b[..., :2] - b[..., 2:4] * 0.5,
                      b[..., :2] + b[..., 2:4] * 0.5], dim=-1)


def _inter_union(a, b):
    a1, b1 = _corners(a), _corners(b)
    lu = torch.maximum(a1[..., :2], b1[..., :2])
    rd = torch.minimum(a1[..., 2:], b1[..., 2:])
    inter = torch.prod(torch.clamp(rd - lu, min=0.0), dim=-1)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter, union, a1, b1


def _iou_xywh(a, b):
    """IoU of broadcastable center-format [x, y, w, h] boxes."""
    inter, union, _, _ = _inter_union(a, b)
    return inter / torch.clamp(union, min=1e-6)


def _giou_xywh(a, b):
    """GIoU = IoU - (enclose - union) / enclose, center-format boxes."""
    inter, union, a1, b1 = _inter_union(a, b)
    iou = inter / torch.clamp(union, min=1e-6)
    lu = torch.minimum(a1[..., :2], b1[..., :2])
    rd = torch.maximum(a1[..., 2:], b1[..., 2:])
    enclose = torch.prod(torch.clamp(rd - lu, min=0.0), dim=-1)
    return iou - (enclose - union) / torch.clamp(enclose, min=1e-6)


def bbox_loss(raw, decoded, label_bbox, true_bbox, *, input_size: int):
    """The detection loss: raw, decoded [B, S, S, A, 5]; label_bbox
    [B, S, S, A, 5] (xywh in pixels and objectness); true_bbox [B, M, 4]
    xywh in pixels.  Returns the batch mean of the per-sample sums."""
    obj = label_bbox[..., 4:5]
    gt_xywh = label_bbox[..., 0:4]
    pred_xywh = decoded[..., 0:4]
    area = gt_xywh[..., 2:3] * gt_xywh[..., 3:4]
    scale = 2.0 - area / float(input_size) ** 2
    giou = _giou_xywh(pred_xywh, gt_xywh)[..., None]
    giou_loss = obj * scale * (1.0 - giou)
    # a predicted box overlapping any true box above the threshold is not
    # penalized as background
    iou_true = _iou_xywh(pred_xywh[:, :, :, :, None, :],
                         true_bbox[:, None, None, None, :, :])
    max_iou = iou_true.amax(dim=-1)[..., None]
    background = (1.0 - obj) * (max_iou < IGNORE_IOU).float()
    conf_loss = (obj + background) * sigmoid_cross_entropy(raw[..., 4:5], obj)
    return torch.mean(torch.sum(giou_loss + conf_loss, dim=(1, 2, 3, 4)))
