"""Layer primitives: deterministic numpy init, TF ``SAME`` conv and max pool.

Init is pure numpy and a line-for-line copy of the JAX package's
``InitStream`` family, so an int seed gives bit-identical parameters in both
packages.  Parameter leaf names mirror the reference TF variable names
('DW' / 'biases', CMPC_model.py:412-417).

Activations are NHWC at every public function (the JAX package's layout);
head conv kernels are HWIO like the JAX pytree.  TF ``SAME`` pads
asymmetrically for strided windows (more after than before), which
PyTorch's symmetric ``padding=`` cannot express, so the pads are computed
here and applied with ``F.pad``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class InitStream:
    """Host-side deterministic key stream for parameter init (numpy only).

    The root takes an int seed; children take their SeedSequence.
    """

    def __init__(self, seed):
        self.ss = seed if isinstance(seed, np.random.SeedSequence) \
            else np.random.SeedSequence(int(seed))

    def split(self, n: int):
        return [InitStream(c) for c in self.ss.spawn(n)]

    def rng(self) -> np.random.Generator:
        return np.random.default_rng(self.ss.spawn(1)[0])


def as_stream(key) -> InitStream:
    return key if isinstance(key, InitStream) else InitStream(key)


def split_stream(key, n: int):
    return as_stream(key).split(n)


def xavier_conv_init(key, shape):
    """`tf.contrib.layers.xavier_initializer_conv2d` parity (glorot uniform
    with receptive-field-scaled fans); `shape` is HWIO."""
    kh, kw, cin, cout = shape
    fan_in = kh * kw * cin
    fan_out = kh * kw * cout
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return as_stream(key).rng().uniform(-limit, limit, shape).astype(
        np.float32)


def glorot_uniform(key, shape):
    """TF1 `get_variable` default initializer for >=2D variables."""
    fan_in = int(np.prod(shape[:-1]))
    fan_out = int(shape[-1])
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return as_stream(key).rng().uniform(-limit, limit, shape).astype(
        np.float32)


def normal_init(key, shape, stddev=0.01):
    return (stddev * as_stream(key).rng().standard_normal(shape)).astype(
        np.float32)


def init_conv(key, ksize: int, cin: int, cout: int):
    """Conv param dict ({'DW': [k,k,cin,cout] HWIO, 'biases': [cout]})."""
    return {"DW": xavier_conv_init(key, (ksize, ksize, cin, cout)),
            "biases": np.zeros((cout,), np.float32)}


def init_layer_norm(cout: int):
    """gamma/beta for tf1_layer_norm (last-axis params)."""
    return {"gamma": np.ones((cout,), np.float32),
            "beta": np.zeros((cout,), np.float32)}


def same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """(before, after) padding of TF ``SAME`` along one spatial axis."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv2d_nchw(x, w, *, stride: int = 1, dilation: int = 1):
    """SAME conv of an NCHW tensor (any memory format) with an OIHW kernel."""
    kh, kw = w.shape[2], w.shape[3]
    ph = same_pads(x.shape[2], kh, stride, dilation)
    pw = same_pads(x.shape[3], kw, stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, dilation=dilation,
                        padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride, dilation=dilation)


def conv2d(params, x, *, stride: int = 1, dilation: int = 1):
    """SAME conv of NHWC `x` with an HWIO 'DW' (+ 'biases').

    The product runs in ``x.dtype`` (f32 weights are cast down to bf16
    activations, never the reverse); the bias is added in that dtype and the
    output keeps it (the JAX ``conv2d`` contract).  1x1 stride-1 convs are a
    channel matmul."""
    dt = x.dtype
    w = params["DW"].to(dt)
    if w.shape[0] == 1 and w.shape[1] == 1 and stride == 1:
        y = torch.matmul(x, w[0, 0])
    else:
        # a contiguous OIHW kernel: the CPU's slow_conv2d backward (taken at
        # batch 1) rejects a permuted one; the head's kernels are small
        y = conv2d_nchw(x.permute(0, 3, 1, 2),
                        w.permute(3, 2, 0, 1).contiguous(),
                        stride=stride, dilation=dilation).permute(0, 2, 3, 1)
    if "biases" in params:
        y = y + params["biases"].to(dt)
    return y


def max_pool_nchw(x, ksize: int, stride: int):
    """SAME max pool of an NCHW tensor: pads with -inf like TF."""
    ph = same_pads(x.shape[2], ksize, stride)
    pw = same_pads(x.shape[3], ksize, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, ksize, stride)


def max_pool(x, ksize: int, stride: int):
    """SAME max pool of NHWC `x` (backbone pool1, deeplab_resnet/model.py:22)."""
    return max_pool_nchw(x.permute(0, 3, 1, 2), ksize, stride
                         ).permute(0, 2, 3, 1)
