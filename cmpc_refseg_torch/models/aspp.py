"""ASPP + DeepLabv3+ decoder head (the v4/v5/v6 configs).

Reference: CMPCv4_model.py:199-242 (ASPP, rates 6/12/18 and image-level
pooling) and :181-197 (the v3+ decoder with the res2b_relu 48-channel
lateral).

This is the one subgraph of the model with live BatchNorm (slim conv2d
under resnet_arg_scope, is_training = mode == 'train'); the backbone's BN
is frozen.  The moving statistics are an explicit `state` tree
({unit: {'mean', 'var'}}) passed in and returned, never updated in place.
In train mode BN normalizes with the batch's biased mean and variance over
(B, H, W), computed in float32 whatever the conv's dtype, and the moving
statistics become s * 0.9997 + batch * 0.0003; in eval mode it uses the
moving statistics.  Under a process group of R > 1 ranks the batch is the
global one: the moments are summed over the ranks (`batch_moments`), as
the JAX package's global-batch step computes them.  The convs run through
cuDNN and the BN arithmetic is plain PyTorch, as the JAX package leaves
this subgraph to XLA.

Init functions return numpy trees in the JAX package's layout (HWIO
kernels), draw for draw its init; ``convert.params_from_jax`` turns them
into tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from cmpc_refseg_torch.ops.layers import conv2d, init_conv, split_stream
from cmpc_refseg_torch.ops.resize import resize_bilinear
from cmpc_refseg_torch.parallel.mesh import all_reduce_sum, process_count

BN_EPS = 1e-5
BN_DECAY = 0.9997
ASPP_RATES = (6, 12, 18)   # output_stride=16 (CMPCv4_model.py:152)
ASPP_DEPTH = 256
_ASPP_UNITS = ("conv_1x1", "conv_3x3_1", "conv_3x3_2", "conv_3x3_3",
               "image_level", "conv_1x1_concat")
# the decoder's BN units and their widths
_DECODER_BN = {"low_level": 48, "conv_3x3_1": ASPP_DEPTH,
               "conv_3x3_2": ASPP_DEPTH}


def _init_bn_unit(key, ksize, cin, cout):
    """slim conv2d with normalizer_fn=batch_norm: conv (no bias) + BN."""
    return {"DW": init_conv(key, ksize, cin, cout)["DW"],
            "gamma": np.ones((cout,), np.float32),
            "beta": np.zeros((cout,), np.float32)}


def _init_bn_state(cout):
    return {"mean": np.zeros((cout,), np.float32),
            "var": np.ones((cout,), np.float32)}


def init_state() -> dict:
    """The initial moving statistics of the ASPP and the decoder (numpy):
    what `init_aspp` and `init_v3plus_decoder` return beside their
    params, without drawing the params."""
    return {"aspp": {n: _init_bn_state(ASPP_DEPTH) for n in _ASPP_UNITS},
            "decoder": {n: _init_bn_state(c) for n, c in _DECODER_BN.items()}}


def batch_moments(yf):
    """The biased mean and variance per channel of f32 `yf` [B, h, w, C]
    over (B, h, w): this rank's, or under R > 1 ranks of equal batches
    the global batch's, by a differentiable all-reduce of the sum and then
    of the squared deviations from the global mean (two passes: E[x^2] -
    E[x]^2 loses float32 digits)."""
    count = process_count()
    if count == 1:
        return yf.mean(dim=(0, 1, 2)), yf.var(dim=(0, 1, 2), unbiased=False)
    n = yf.numel() // yf.shape[-1] * count
    mean = all_reduce_sum(yf.sum(dim=(0, 1, 2))) / n
    var = all_reduce_sum(torch.square(yf - mean).sum(dim=(0, 1, 2))) / n
    return mean, var


def _apply_bn_unit(p, s, x, *, dilation=1, train=False, relu=True):
    """conv -> BN (batch or moving statistics, f32) -> relu, cast back to
    the conv's dtype.  Returns (y, the unit's new state)."""
    y = conv2d({"DW": p["DW"]}, x, dilation=dilation)
    yf = y.float()
    if train:
        mean, var = batch_moments(yf)
        with torch.no_grad():
            new_s = {"mean": s["mean"] * BN_DECAY + mean * (1 - BN_DECAY),
                     "var": s["var"] * BN_DECAY + var * (1 - BN_DECAY)}
    else:
        mean, var, new_s = s["mean"], s["var"], s
    yf = (yf - mean) * torch.rsqrt(var + BN_EPS) * p["gamma"] + p["beta"]
    if relu:
        yf = torch.relu(yf)
    return yf.to(y.dtype), new_s


def init_aspp(key, cfg, cin: int):
    """(params, state) of the ASPP head on `cin`-channel features."""
    ks = split_stream(key, 6)
    dims = {"conv_1x1": (1, cin), "conv_3x3_1": (3, cin),
            "conv_3x3_2": (3, cin), "conv_3x3_3": (3, cin),
            "image_level": (1, cin), "conv_1x1_concat": (1, 5 * ASPP_DEPTH)}
    params = {}
    for k, name in zip(ks, _ASPP_UNITS):
        ksize, c_in = dims[name]
        params[name] = _init_bn_unit(k, ksize, c_in, ASPP_DEPTH)
    return params, init_state()["aspp"]


def apply_aspp(params, state, x, *, train=False):
    """x [B,h,w,C] -> ([B,h,w,256], new state) (CMPCv4_model.py:199-242):
    a 1x1 branch, three 3x3 branches at rates 6/12/18, the image-level
    branch (mean over (h, w), 1x1 conv + BN, broadcast) and the 1x1
    projection of their concatenation."""
    b, h, w, _ = x.shape
    new_state = {}
    out, new_state["conv_1x1"] = _apply_bn_unit(
        params["conv_1x1"], state["conv_1x1"], x, train=train)
    branches = [out]
    for i, rate in enumerate(ASPP_RATES, start=1):
        name = f"conv_3x3_{i}"
        out, new_state[name] = _apply_bn_unit(
            params[name], state[name], x, dilation=rate, train=train)
        branches.append(out)
    gap = torch.mean(x, dim=(1, 2), keepdim=True)
    il, new_state["image_level"] = _apply_bn_unit(
        params["image_level"], state["image_level"], gap, train=train)
    branches.append(il.expand(b, h, w, ASPP_DEPTH))
    out, new_state["conv_1x1_concat"] = _apply_bn_unit(
        params["conv_1x1_concat"], state["conv_1x1_concat"],
        torch.cat(branches, dim=-1), train=train)
    return out, new_state


def init_v3plus_decoder(key, cfg, c2_dim: int = 256):
    """(params, state) of the v3+ decoder; its last 1x1 conv has a bias
    and no BN."""
    k1, k2, k3, k4 = split_stream(key, 4)
    params = {
        "low_level": _init_bn_unit(k1, 1, c2_dim, 48),
        "conv_3x3_1": _init_bn_unit(k2, 3, ASPP_DEPTH + 48, ASPP_DEPTH),
        "conv_3x3_2": _init_bn_unit(k3, 3, ASPP_DEPTH, ASPP_DEPTH),
        "conv_1x1": init_conv(k4, 1, ASPP_DEPTH, 1),
    }
    return params, init_state()["decoder"]


def apply_v3plus_decoder(params, state, encoder_output, c2, *, train=False):
    """DeepLabv3+ decoder (CMPCv4_model.py:181-197): the 48-channel c2
    lateral, the encoder output resized to c2's resolution (TF1 resize),
    two 3x3 convs, and the float32 1x1 logits.  Returns (logits
    [B,H/4,W/4,1] f32, new state)."""
    new_state = {}
    low, new_state["low_level"] = _apply_bn_unit(
        params["low_level"], state["low_level"], c2, train=train)
    up = resize_bilinear(encoder_output, low.shape[1], low.shape[2])
    net = torch.cat([up, low], dim=-1)
    for name in ("conv_3x3_1", "conv_3x3_2"):
        net, new_state[name] = _apply_bn_unit(params[name], state[name], net,
                                              train=train)
    return conv2d(params["conv_1x1"], net.float()), new_state
