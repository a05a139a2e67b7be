"""DeepLab ResNet-101 backbone (output stride 8, atrous res4/res5).

Reference: external/tensorflow-deeplab-resnet/deeplab_resnet/model.py —
conv1 7x7/2 + pool/2 -> res2 -> res3 (stride 8) -> res4 with atrous rate 2
-> res5 with atrous rate 4.  CMPC taps res3b3 / res4b22 / res5c
(CMPC_model.py:73-76).

The reference runs backbone BN with frozen statistics, so BN is folded into
a per-channel affine (`scale`, `offset`) applied in float32 after the conv.
The convs are plain large products and run through cuDNN (`F.conv2d`);
kernels are OIHW and activations stay NCHW in the channels_last memory
format inside the backbone, so the NHWC input and the NHWC taps are views.
"""

from __future__ import annotations

import numpy as np
import torch

from cmpc_refseg_torch.ops.layers import (conv2d_nchw, max_pool_nchw,
                                          split_stream, xavier_conv_init)


def resnet_stages(res4_blocks: int = 23):
    """Stage spec: (stage, block names, mid, out, stride, dilation).
    res4_blocks=23 is ResNet-101 (the reference); smaller values give
    shallower backbones with identical topology."""
    return (
        ("res2", ("a", "b", "c"), 64, 256, 1, 1),
        ("res3", ("a", "b1", "b2", "b3"), 128, 512, 2, 1),
        ("res4", ("a",) + tuple(f"b{i}" for i in range(1, res4_blocks)),
         256, 1024, 1, 2),
        ("res5", ("a", "b", "c"), 512, 2048, 1, 4),
    )


# the stages whose conv kernels train with conv5=True
TRAINABLE_STAGES = ("res3", "res4", "res5")


def taps_for(stages):
    """c2 = res2b_relu (CMPCv4_model.py:88), c3/c4/c5 = last block of
    res3/res4/res5."""
    last = {s[0]: s[1][-1] for s in stages}
    return {
        "c2": "res2b_relu",
        "c3": f"res3{last['res3']}_relu",
        "c4": f"res4{last['res4']}_relu",
        "c5": f"res5{last['res5']}_relu",
    }


def _init_unit(key, k, cin, cout):
    """One conv+foldedBN unit, in the JAX package's layout (HWIO kernel);
    convert.params_from_jax turns it into the port's OIHW tensors."""
    return {
        "w": xavier_conv_init(key, (k, k, cin, cout)),
        "scale": np.ones((cout,), np.float32),
        "offset": np.zeros((cout,), np.float32),
    }


def init_backbone(key, res4_blocks: int = 23) -> dict:
    """Numpy parameter tree, draw for draw the JAX package's."""
    keys = iter(split_stream(key, 512))
    params = {"conv1": _init_unit(next(keys), 7, 3, 64)}
    cin = 64
    for stage, blocks, mid, cout, _, _ in resnet_stages(res4_blocks):
        for bi, b in enumerate(blocks):
            bp = {}
            if bi == 0:
                bp["branch1"] = _init_unit(next(keys), 1, cin, cout)
            bp["branch2a"] = _init_unit(next(keys), 1,
                                        cin if bi == 0 else cout, mid)
            bp["branch2b"] = _init_unit(next(keys), 3, mid, mid)
            bp["branch2c"] = _init_unit(next(keys), 1, mid, cout)
            params[f"{stage}{b}"] = bp
        cin = cout
    return params


def _conv_bn(unit, x, *, stride=1, dilation=1, relu=True,
             compute_dtype=None):
    """Conv (in the compute dtype) + folded-BN affine in float32."""
    w = unit["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = conv2d_nchw(x, w, stride=stride, dilation=dilation)
    # offset + y * scale in float32 (the product promotes), one pass
    y = torch.addcmul(unit["offset"].view(1, -1, 1, 1), y,
                      unit["scale"].view(1, -1, 1, 1))
    if relu:
        y = y.relu_()
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    return y


def apply_backbone(params: dict, im, *, compute_dtype=None,
                   taps=("c2", "c3", "c4", "c5"),
                   res4_blocks: int = 23) -> dict:
    """Forward mean-subtracted BGR images [B,H,W,3]; returns the requested
    NHWC float32 taps ({'c3': [B,H/8,W/8,512], ...})."""
    x = im.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = _conv_bn(params["conv1"], x, stride=2, compute_dtype=compute_dtype)
    x = max_pool_nchw(x, 3, 2)

    outputs = {}
    stages = resnet_stages(res4_blocks)
    want = {taps_for(stages)[t]: t for t in taps}
    for stage, blocks, _, _, stride, dilation in stages:
        for bi, b in enumerate(blocks):
            bname = f"{stage}{b}"
            bp = params[bname]
            block_stride = stride if bi == 0 else 1
            if bi == 0:
                shortcut = _conv_bn(bp["branch1"], x, stride=block_stride,
                                    relu=False, compute_dtype=compute_dtype)
            else:
                shortcut = x
            y = _conv_bn(bp["branch2a"], x, stride=block_stride,
                         compute_dtype=compute_dtype)
            y = _conv_bn(bp["branch2b"], y, dilation=dilation,
                         compute_dtype=compute_dtype)
            y = _conv_bn(bp["branch2c"], y, relu=False,
                         compute_dtype=compute_dtype)
            x = (shortcut + y).relu_()
            name = f"{bname}_relu"
            if name in want:
                outputs[want[name]] = x.permute(0, 2, 3, 1).float()
    return outputs
