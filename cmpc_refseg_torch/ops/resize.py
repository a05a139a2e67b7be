"""Bilinear resize with TF1 `tf.image.resize_bilinear` semantics.

TF1 legacy resize maps ``src = dst_index * (in_size / out_size)`` with no
half-pixel offset, so ``F.interpolate`` (half-pixel centres) does not match.
The resize is two products with explicit 1-D interpolation matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] row-stochastic bilinear interpolation matrix with
    TF1 legacy grid mapping: src = i * in/out, clamped top edge."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    scale = in_size / out_size
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    m[np.arange(out_size), lo] += 1.0 - t
    m[np.arange(out_size), hi] += t
    return m


def resize_bilinear(x, out_h: int, out_w: int):
    """Resize an NHWC tensor to (out_h, out_w) with TF1 semantics."""
    if x.dim() != 4:
        raise ValueError(f"resize_bilinear expects NHWC, got {tuple(x.shape)}")
    mh = torch.as_tensor(_interp_matrix(x.shape[1], out_h), dtype=x.dtype,
                         device=x.device)
    mw = torch.as_tensor(_interp_matrix(x.shape[2], out_w), dtype=x.dtype,
                         device=x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)
