"""Spatial coordinate features (util/processing_tools.py:5-17)."""

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
