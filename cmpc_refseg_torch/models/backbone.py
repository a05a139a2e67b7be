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

The int8 serving path (`quantize_backbone`, `calibrate_backbone`): a unit
holding `w_q` (int8 OIHW, symmetric per output channel, `w_scale`) runs its
conv on int8 codes of the input (a per-tensor scale, static `x_scale` or
the input's abs-max) with int32 accumulation, and folds both scales into
the BN epilogue.  On the card the product is cuBLASLt's int8 GEMM
(`torch._int_mm`) over the channels_last rows, through an im2col for the
k x k convs (`int8_conv_gemm`); on the CPU it is the exact float64
`F.conv2d` of the codes (`int8_conv_plain`), which is also the card's
oracle.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cmpc_refseg_torch.ops.layers import (conv2d_nchw, max_pool_nchw,
                                          same_pads, split_stream,
                                          xavier_conv_init)

INT8_MAX = 127
# torch._int_mm on CUDA: M > 16 rows, K and N multiples of 8
GEMM_K_MULTIPLE = 8


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


def quantize_backbone(params_bb: dict) -> dict:
    """Symmetric per-output-channel int8 weights for serving (the JAX
    package's quantize_backbone): a new tree whose conv units carry `w_q`
    (int8 OIHW, |code| <= 127) and `w_scale` ([cout] float32, amax / 127
    over I, H and W) in place of `w`; `_conv_bn` runs such a unit on the
    int8 path.  The codes and scales equal JAX's bit for bit (f32
    division, round half to even)."""
    def q(unit):
        w = unit["w"].float()
        amax = w.abs().amax(dim=(1, 2, 3))
        w_scale = torch.clamp(amax, min=1e-12) / INT8_MAX
        w_q = torch.round(w / w_scale[:, None, None, None]).clamp_(
            -INT8_MAX, INT8_MAX).to(torch.int8)
        rest = {k: v for k, v in unit.items() if k != "w"}
        return {**rest, "w_q": w_q, "w_scale": w_scale}

    def walk(node):
        if "w" in node:
            return q(node)
        return {k: walk(v) if isinstance(v, dict) else v
                for k, v in node.items()}
    return walk(params_bb)


def gemm_weight(w_q):
    """The int8 GEMM's weight operand of an OIHW `w_q`: [cout, K] with K in
    (kh, kw, cin) order, the im2col's column order, and K padded with zero
    columns to a multiple of 8 (conv1: 7 * 7 * 3 = 147 -> 152; exact).  A
    view of a channels_last `w_q` where no padding is needed."""
    cout = w_q.shape[0]
    mat = w_q.permute(0, 2, 3, 1).reshape(cout, -1)
    pad = -mat.shape[1] % GEMM_K_MULTIPLE
    return F.pad(mat, (0, pad)) if pad else mat


def quantize_input(x, s_x):
    """int8 codes clamp(round(x / s_x), -127, 127) of f32 `x` (division, as
    JAX divides, not a reciprocal)."""
    return torch.round(x / s_x).clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def int8_conv_plain(xq, w_q, *, stride=1, dilation=1):
    """The int32 accumulations of a SAME conv of int8 codes `xq` [B, C, H,
    W] with int8 OIHW `w_q`: float64 `F.conv2d`, rounded.  Exact: |sum| <=
    4608 * 127^2 < 2^53."""
    y = conv2d_nchw(xq.double(), w_q.double(), stride=stride,
                    dilation=dilation)
    return torch.round(y).to(torch.int32)


def int8_conv_gemm(xq, w_gemm, *, ksize, stride=1, dilation=1):
    """The same accumulations through `torch._int_mm` on the channels_last
    rows of `xq` [B, C, H, W] (an NHWC view, as the backbone keeps it): a
    1x1 conv is a GEMM on [B*H*W, C] (stride 2: the even rows and
    columns, which TF SAME pads nothing for), a k x k conv one on the
    im2col [B*Ho*Wo, k*k*C] of the zero-padded codes in (kh, kw, C) order,
    K padded to `w_gemm`'s.  `w_gemm` is `gemm_weight(w_q)`.  Returns
    int32 [B, cout, Ho, Wo] (channels_last).  A shape `_int_mm` refuses
    raises."""
    x = xq.permute(0, 2, 3, 1)                      # NHWC
    b, h, w, c = x.shape
    if ksize == 1:
        cols = x[:, ::stride, ::stride] if stride > 1 else x
    else:
        ph = same_pads(h, ksize, stride, dilation)
        pw = same_pads(w, ksize, stride, dilation)
        xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        ho, wo = -(-h // stride), -(-w // stride)
        cols = torch.cat(
            [xp[:, i * dilation:i * dilation + (ho - 1) * stride + 1:stride,
                j * dilation:j * dilation + (wo - 1) * stride + 1:stride]
             for i in range(ksize) for j in range(ksize)], dim=-1)
    ho, wo = cols.shape[1:3]
    a = cols.reshape(b * ho * wo, cols.shape[-1])
    if a.shape[1] != w_gemm.shape[1]:
        a = F.pad(a, (0, w_gemm.shape[1] - a.shape[1]))
    y = torch._int_mm(a, w_gemm.t())
    return y.view(b, ho, wo, -1).permute(0, 3, 1, 2)


def _int8_conv_bn(unit, x, *, stride, dilation, relu, compute_dtype):
    """The int8 unit (JAX's `_conv_bn` int8 branch): codes of the f32 input
    at the static `x_scale` or the dynamic (max |x| + 1e-12) / 127, the
    int32 product (`int8_conv_gemm` on the card with the prepared
    `w_gemm`, `int8_conv_plain` on the CPU), then y * (s_x * w_scale *
    scale) + offset in float32, the relu and the compute dtype."""
    x = x.float()
    s_x = unit.get("x_scale")
    if s_x is None:
        s_x = (x.abs().amax() + 1e-12) / INT8_MAX
    xq = quantize_input(x, s_x)
    if x.is_cuda:
        acc = int8_conv_gemm(xq, unit["w_gemm"], ksize=unit["w_q"].shape[2],
                             stride=stride, dilation=dilation)
    else:
        acc = int8_conv_plain(xq, unit["w_q"], stride=stride,
                              dilation=dilation)
    mult = s_x * unit["w_scale"] * unit["scale"]
    y = torch.addcmul(unit["offset"].view(1, -1, 1, 1), acc.float(),
                      mult.view(1, -1, 1, 1))
    if relu:
        y = y.relu_()
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    return y


def _conv_bn(unit, x, *, stride=1, dilation=1, relu=True,
             compute_dtype=None, record=None, name=None):
    """Conv (in the compute dtype) + folded-BN affine in float32; an int8
    unit (`w_q`) takes `_int8_conv_bn`.  `record[name]` gets the input's
    abs-max (float32) when `record` is given."""
    if record is not None:
        record[name] = x.abs().amax().float()
    if "w_q" in unit:
        return _int8_conv_bn(unit, x, stride=stride, dilation=dilation,
                             relu=relu, compute_dtype=compute_dtype)
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
                   res4_blocks: int = 23, record=None) -> dict:
    """Forward mean-subtracted BGR images [B,H,W,3]; returns the requested
    NHWC float32 taps ({'c3': [B,H/8,W/8,512], ...}).  `record` (a dict)
    collects each conv unit's input abs-max under its name
    ('conv1', 'res2a/branch1', ...) for `calibrate_backbone`."""
    x = im.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = _conv_bn(params["conv1"], x, stride=2, compute_dtype=compute_dtype,
                 record=record, name="conv1")
    x = max_pool_nchw(x, 3, 2)

    outputs = {}
    stages = resnet_stages(res4_blocks)
    want = {taps_for(stages)[t]: t for t in taps}
    for stage, blocks, _, _, stride, dilation in stages:
        for bi, b in enumerate(blocks):
            bname = f"{stage}{b}"
            bp = params[bname]
            block_stride = stride if bi == 0 else 1
            unit = dict(compute_dtype=compute_dtype, record=record)
            if bi == 0:
                shortcut = _conv_bn(bp["branch1"], x, stride=block_stride,
                                    relu=False, name=f"{bname}/branch1",
                                    **unit)
            else:
                shortcut = x
            y = _conv_bn(bp["branch2a"], x, stride=block_stride,
                         name=f"{bname}/branch2a", **unit)
            y = _conv_bn(bp["branch2b"], y, dilation=dilation,
                         name=f"{bname}/branch2b", **unit)
            y = _conv_bn(bp["branch2c"], y, relu=False,
                         name=f"{bname}/branch2c", **unit)
            x = (shortcut + y).relu_()
            name = f"{bname}_relu"
            if name in want:
                outputs[want[name]] = x.permute(0, 2, 3, 1).float()
    return outputs


def calibrate_backbone(params_q: dict, images, *, res4_blocks: int = 23,
                       margin: float = 1.0) -> dict:
    """Static int8 activation scales from calibration data (the JAX
    package's calibrate_backbone): the quantized backbone runs in float32
    over each of `images` (mean-subtracted BGR [B, H, W, 3] arrays or
    tensors), each unit's input abs-max is recorded, the running max over
    the images kept on the host, and a new tree returned whose int8 units
    carry x_scale = margin * (amax + 1e-12) / 127 (a float32 0-d tensor),
    so the forward skips the dynamic abs-max."""
    dev = params_q["conv1"]["w_scale"].device
    agg: dict = {}
    with torch.inference_mode():
        for im in images:
            rec: dict = {}
            apply_backbone(params_q, torch.as_tensor(
                im, dtype=torch.float32, device=dev), taps=("c5",),
                res4_blocks=res4_blocks, record=rec)
            for k, v in rec.items():
                agg[k] = max(agg.get(k, 0.0), float(v))

    def walk(node, prefix):
        if "w_q" in node:
            key = prefix.rstrip("/")
            if key not in agg:
                return node
            s = np.float32(margin * (agg[key] + 1e-12) / 127.0)
            return {**node, "x_scale": torch.tensor(s, device=dev)}
        if "w" in node:
            return node
        return {k: walk(v, prefix + k + "/") if isinstance(v, dict) else v
                for k, v in node.items()}
    return walk(params_q, "")
