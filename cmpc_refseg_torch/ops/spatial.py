"""Spatial coordinate features (util/processing_tools.py:5-17), and the
reference's two other host helpers of that file: the bilinear upsampling
filter and the box features (:19-22, :44-60), host numpy as there."""

from __future__ import annotations

import numpy as np
import torch


def spatial_coordinate_grid(h: int, w: int, device=None):
    """[h, w, 8] grid of (xmin, ymin, xmax, ymax, xctr, yctr, 1/w, 1/h),
    coordinates in [-1, 1], computed in float64 like the reference."""
    ws = np.arange(w, dtype=np.float64)
    hs = np.arange(h, dtype=np.float64)
    xmin = ws / w * 2 - 1
    xmax = (ws + 1) / w * 2 - 1
    xctr = (xmin + xmax) / 2
    ymin = hs / h * 2 - 1
    ymax = (hs + 1) / h * 2 - 1
    yctr = (ymin + ymax) / 2

    grid = np.zeros((h, w, 8), dtype=np.float32)
    grid[:, :, 0] = xmin[None, :]
    grid[:, :, 1] = ymin[:, None]
    grid[:, :, 2] = xmax[None, :]
    grid[:, :, 3] = ymax[:, None]
    grid[:, :, 4] = xctr[None, :]
    grid[:, :, 5] = yctr[:, None]
    grid[:, :, 6] = 1.0 / w
    grid[:, :, 7] = 1.0 / h
    return torch.as_tensor(grid, device=device)


def generate_bilinear_filter(stride: int) -> np.ndarray:
    """[2*stride, 2*stride, 1, 1] bilinear upsampling kernel
    (util/processing_tools.py:19-22): the outer product of the ramp
    0..stride..1 over stride, the FCN deconvolution initializer."""
    f = np.concatenate((np.arange(0, stride),
                        np.arange(stride, 0, -1))) / stride
    return np.outer(f, f).astype(np.float32)[:, :, np.newaxis, np.newaxis]


def spatial_feature_from_bbox(bboxes, imsize) -> np.ndarray:
    """[N, 8] float64 box features (util/processing_tools.py:44-60): the
    corners and the center in [-1, 1], then the width and height, of
    boxes (x1, y1, x2, y2) in an image of `imsize` (w, h).  A coordinate
    at or past the image's extent fails the reference's assertion
    (:49-51)."""
    bboxes = np.asarray(bboxes).reshape((-1, 4))
    im_w, im_h = imsize
    assert np.all(bboxes[:, 0] < im_w) and np.all(bboxes[:, 2] < im_w)
    assert np.all(bboxes[:, 1] < im_h) and np.all(bboxes[:, 3] < im_h)
    feats = np.zeros((bboxes.shape[0], 8))
    feats[:, 0] = bboxes[:, 0] * 2.0 / im_w - 1
    feats[:, 1] = bboxes[:, 1] * 2.0 / im_h - 1
    feats[:, 2] = bboxes[:, 2] * 2.0 / im_w - 1
    feats[:, 3] = bboxes[:, 3] * 2.0 / im_h - 1
    feats[:, 4] = (feats[:, 0] + feats[:, 2]) / 2
    feats[:, 5] = (feats[:, 1] + feats[:, 3]) / 2
    feats[:, 6] = feats[:, 2] - feats[:, 0]
    feats[:, 7] = feats[:, 3] - feats[:, 1]
    return feats
