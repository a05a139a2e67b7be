"""Atrous VGG16-FCN alternative backbone.

Reference: util/vgg16_fcn.py:7-36, the reference's unused alternative
backbone: VGG16 with pool4 and pool5 removed (conv4 and conv5 run at
pool3's resolution, output stride 8) and the classifier made fully
convolutional (fc6 a 7x7 conv, fc7 and fc8 1x1 convs).  The convs run
through the port's ``ops/layers.conv2d`` (cuDNN; HWIO kernels as in the
JAX package), in the compute dtype when one is given.
"""

from __future__ import annotations

import torch

from cmpc_refseg_torch.ops.layers import (conv2d, init_conv, max_pool,
                                          split_stream)

# (name, kernel, cin, cout) in forward order, each followed by a relu
_SPEC = (
    ("conv1_1", 3, 3, 64), ("conv1_2", 3, 64, 64),          # -> pool1
    ("conv2_1", 3, 64, 128), ("conv2_2", 3, 128, 128),      # -> pool2
    ("conv3_1", 3, 128, 256), ("conv3_2", 3, 256, 256),
    ("conv3_3", 3, 256, 256),                               # -> pool3
    ("conv4_1", 3, 256, 512), ("conv4_2", 3, 512, 512),
    ("conv4_3", 3, 512, 512),
    ("conv5_1", 3, 512, 512), ("conv5_2", 3, 512, 512),
    ("conv5_3", 3, 512, 512),
    ("fc6", 7, 512, 4096), ("fc7", 1, 4096, 4096),
)
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_3"}


def init_vgg16_fcn(key) -> dict:
    """Numpy parameters ({'DW': HWIO, 'biases'} per layer), draw for draw
    the JAX package's init_vgg16_fcn; ``convert.vgg16_fcn_from_jax`` makes
    them tensors."""
    keys = split_stream(key, len(_SPEC) + 1)
    params = {name: init_conv(k, ks, cin, cout)
              for k, (name, ks, cin, cout) in zip(keys, _SPEC)}
    params["fc8"] = init_conv(keys[-1], 1, 4096, 1000)
    return params


def apply_vgg16_fcn(params: dict, im, *, compute_dtype=None) -> dict:
    """Forward NHWC images [B, H, W, 3]; returns every named activation
    (NHWC, in the compute dtype, else the input's), with 'fc8' the
    1000-channel fully convolutional logits at stride 8."""
    outputs = {}
    x = im if compute_dtype is None else im.to(compute_dtype)
    for name, *_ in _SPEC:
        x = torch.relu(conv2d(params[name], x))
        outputs[name] = x
        if name in _POOL_AFTER:
            x = max_pool(x, 2, 2)
            outputs["pool" + name[4]] = x
    outputs["fc8"] = conv2d(params["fc8"], x)      # no relu
    return outputs
