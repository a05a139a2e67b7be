"""YOLO-style anchor label assignment for the detection head (the JAX
package's data/anchors.py, a numpy copy).

Reference: util/processing_tools.py:64-146 (bbox_iou and
preprocess_true_boxes: stride 8, 3 anchors, IoU threshold 0.3, else the
best anchor)."""

from __future__ import annotations

import numpy as np

# Default anchors in stride-8 cell units (reference data/anchors.txt, read
# by util/io.read_anchors at trainval_model_v5+.py:35).
DEFAULT_ANCHORS = np.array([
    [4.38013699, 4.5032344],
    [28.66804788, 17.64065378],
    [13.23512686, 13.4864392],
], np.float32)


def bbox_iou_xywh(boxes1, boxes2):
    """IoU of center-format [x, y, w, h] boxes (processing_tools.py:64-85)."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    b1 = np.concatenate([boxes1[..., :2] - boxes1[..., 2:] * 0.5,
                         boxes1[..., :2] + boxes1[..., 2:] * 0.5], axis=-1)
    b2 = np.concatenate([boxes2[..., :2] - boxes2[..., 2:] * 0.5,
                         boxes2[..., :2] + boxes2[..., 2:] * 0.5], axis=-1)
    lu = np.maximum(b1[..., :2], b2[..., :2])
    rd = np.minimum(b1[..., 2:], b2[..., 2:])
    inter = np.maximum(rd - lu, 0.0)
    inter_area = inter[..., 0] * inter[..., 1]
    return inter_area / (area1 + area2 - inter_area + 1e-6)


def preprocess_true_boxes(bboxes, train_input_size, anchors, stride=8,
                          anchor_per_scale=3, max_bbox_per_scale=1):
    """Corner-format [x1, y1, x2, y2] boxes -> the per-cell anchor label
    grid [S, S, A, 5] (xywh in pixels and objectness) and the kept boxes
    [M, 4] xywh (processing_tools.py:87-146)."""
    out_size = train_input_size // stride
    label = np.zeros((out_size, out_size, anchor_per_scale, 5))
    bboxes_xywh = np.zeros((max_bbox_per_scale, 4))
    for count, bbox in enumerate(bboxes):
        coor = np.asarray(bbox[:4], dtype=np.float64)
        xywh = np.concatenate([(coor[2:] + coor[:2]) * 0.5,
                               coor[2:] - coor[:2]], axis=-1)
        scaled = xywh / stride
        anchors_xywh = np.zeros((anchor_per_scale, 4))
        anchors_xywh[:, 0:2] = np.floor(scaled[0:2]).astype(np.int32) + 0.5
        anchors_xywh[:, 2:4] = anchors
        iou_scale = bbox_iou_xywh(scaled[np.newaxis, :], anchors_xywh)
        iou_mask = iou_scale > 0.3
        xind, yind = np.floor(scaled[0:2]).astype(np.int32)
        xind = int(np.clip(xind, 0, out_size - 1))
        yind = int(np.clip(yind, 0, out_size - 1))
        if not np.any(iou_mask):
            iou_mask = np.zeros(anchor_per_scale, bool)
            iou_mask[int(np.argmax(iou_scale.reshape(-1))
                         % anchor_per_scale)] = True
        label[yind, xind, iou_mask, :] = 0
        label[yind, xind, iou_mask, 0:4] = xywh
        label[yind, xind, iou_mask, 4:5] = 1.0
        bboxes_xywh[count % max_bbox_per_scale, :4] = xywh
    return label, bboxes_xywh
