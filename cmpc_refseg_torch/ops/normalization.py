"""Normalization primitives matching the reference's TF1 idioms."""

from __future__ import annotations

import torch


def l2_normalize(x, dim=-1, epsilon: float = 1e-12):
    """`tf.nn.l2_normalize` parity: x * 1/sqrt(max(sum(x^2), eps)).

    ``F.normalize`` divides by max(norm, eps) instead, which differs near
    zero.  Statistics in float32 whatever the input dtype; output keeps
    x.dtype.  `dim` may be a tuple (the global per-sample norm of
    ``_apply_gv``)."""
    xf = x.float()
    sq = torch.sum(xf * xf, dim=dim, keepdim=True)
    inv = torch.reciprocal(torch.sqrt(torch.clamp(sq, min=epsilon)))
    return (xf * inv).to(x.dtype)


def tf1_layer_norm(x, gamma, beta, epsilon: float = 1e-12):
    """`tf.contrib.layers.layer_norm` parity: normalizes each sample over
    ALL non-batch axes, with gamma/beta over the last axis only.
    Statistics in float32; output keeps x.dtype."""
    dims = tuple(range(1, x.dim()))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, correction=0, keepdim=True)
    inv = torch.reciprocal(torch.sqrt(var + epsilon))
    return ((xf - mean) * inv * gamma + beta).to(x.dtype)
