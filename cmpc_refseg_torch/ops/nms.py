"""Greedy non-maximum suppression, the port of the JAX package's
ops/nms.py.

Reference: util/nms.pyx:17-68 (Cython `cpu_nms`, Fast R-CNN lineage;
imported dormant at util/eval_tools.py:4-5).  Three implementations:

1. `nms_native`: C++ (native/nms.cpp, `native/libnms.so`, through
   ctypes), the Cython equivalent.
2. `nms_numpy`: the vectorized host reference.
3. `nms_torch`: the O(N^2) masked form on the tensors' device, returning
   a keep mask (the JAX package's `nms_jax`).
All use the Fast R-CNN +1 box-area convention of the reference.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "native", "libnms.so")
    if os.path.isfile(path):
        lib = ctypes.CDLL(path)
        lib.greedy_nms.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # dets [N,5]
            ctypes.c_int,                    # N
            ctypes.c_float,                  # iou threshold
            ctypes.POINTER(ctypes.c_int),    # out keep indices
        ]
        lib.greedy_nms.restype = ctypes.c_int
        _NATIVE = lib
    return _NATIVE


def nms_numpy(dets: np.ndarray, thresh: float) -> list:
    """cpu_nms parity (util/nms.pyx): dets [N,5]=(x1,y1,x2,y2,score),
    returns kept indices in score order."""
    dets = np.asarray(dets, dtype=np.float64)
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    suppressed = np.zeros(len(dets), dtype=bool)
    for _i in range(len(order)):
        i = order[_i]
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[_i + 1:]])
        yy1 = np.maximum(y1[i], y1[order[_i + 1:]])
        xx2 = np.minimum(x2[i], x2[order[_i + 1:]])
        yy2 = np.minimum(y2[i], y2[order[_i + 1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[_i + 1:]] - inter)
        suppressed[order[_i + 1:][ovr > thresh]] = True
    return keep


def nms_native(dets: np.ndarray, thresh: float) -> list:
    """C++ NMS; `nms_numpy` where the library is not built."""
    lib = _load_native()
    if lib is None:
        return nms_numpy(dets, thresh)
    dets32 = np.ascontiguousarray(dets, dtype=np.float32)
    keep = np.empty(len(dets32), dtype=np.int32)
    n = lib.greedy_nms(
        dets32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(dets32), ctypes.c_float(thresh),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:n].tolist()


def nms_torch(boxes, scores, iou_threshold: float = 0.5):
    """Greedy NMS on the tensors' device: boxes [N, 4] (x1, y1, x2, y2),
    scores [N] -> a keep mask [N] bool.  The O(N^2) IoU matrix, then a
    sequential pass in score order (ties in index order): a box survives
    iff no higher-scored kept box overlaps it by more than
    `iou_threshold`.  Queues N small ops and no host sync: for the few
    boxes of one image."""
    n = boxes.shape[0]
    x1, y1, x2, y2 = boxes.float().unbind(1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (torch.clamp(xx2 - xx1 + 1, min=0.0)
             * torch.clamp(yy2 - yy1 + 1, min=0.0))
    iou = inter / (areas[:, None] + areas[None, :] - inter)
    order = torch.argsort(-scores, stable=True)
    # row k: box order[k]'s overlaps with the boxes in score order
    over = iou[order][:, order] > iou_threshold
    ranks = torch.arange(n, device=boxes.device)
    keep_sorted = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for k in range(n):
        higher = ranks < k
        keep_sorted[k] = ~torch.any(over[k] & higher & keep_sorted)
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    return keep
