"""Caffemodel weights into the VOC model: a kaffe-converted ``.npy``
({op_name: {param_name: array}}, conv kernels HWIO, the BN scopes'
gamma / beta / moving_mean / moving_variance; tools/parse_caffemodel.py
writes it) -> the backbone with its BN folded (eps 1e-3, the vendored
slim BN) and the VOC head's four atrous convs fc1_voc12_c0..c3.

A copy of the JAX package's tools/convert_tf_checkpoint.py:27-88 on numpy
trees in the JAX layout (HWIO kernels), and `voc_params_from_kaffe_npy`,
which returns the port's tensors (OIHW kernels, as
``convert.backbone_from_jax`` lays the backbone out).
"""

from __future__ import annotations

import numpy as np

BN_EPS = 1e-3   # slim.batch_norm's epsilon in the vendored backbone


def fold_bn(gamma, beta, mean, var, eps=BN_EPS):
    """(scale, offset) of frozen BN: gamma / sqrt(var + eps) and
    beta - mean * scale, float32."""
    scale = gamma / np.sqrt(var + eps)
    offset = beta - mean * scale
    return scale.astype(np.float32), offset.astype(np.float32)


def bn_name_for(conv_name: str) -> str:
    """caffe conv name -> its BN scope (res2a_branch1 -> bn2a_branch1,
    conv1 -> bn_conv1; deeplab_resnet/model.py)."""
    if conv_name == "conv1":
        return "bn_conv1"
    assert conv_name.startswith("res")
    return "bn" + conv_name[len("res"):]


def convert_backbone(get, params_bb: dict) -> dict:
    """Fill a numpy backbone tree (HWIO 'w', 'scale', 'offset' per unit) in
    place from `get(name)`, name '<scope>/<param>'."""
    def fill(unit, conv_name):
        unit["w"] = get(f"{conv_name}/weights")
        bn = bn_name_for(conv_name)
        unit["scale"], unit["offset"] = fold_bn(
            get(f"{bn}/gamma"), get(f"{bn}/beta"),
            get(f"{bn}/moving_mean"), get(f"{bn}/moving_variance"))

    fill(params_bb["conv1"], "conv1")
    for bname, bp in params_bb.items():
        if bname == "conv1":
            continue
        for branch, unit in bp.items():
            fill(unit, f"{bname}_{branch}")
    return params_bb


def convert_backbone_from_kaffe_npy(npy_path: str, params_bb: dict,
                                    params_head=None) -> dict:
    """Fill a numpy backbone tree (and, when given, the numpy VOC head
    {'c0'..'c3': {'w' HWIO, 'b'}}) in place from the kaffe ``.npy`` at
    `npy_path`; returns the backbone tree."""
    data = np.load(npy_path, allow_pickle=True).item()

    def get(name):
        op, param = name.rsplit("/", 1)
        return np.asarray(data[op][param], np.float32)

    convert_backbone(get, params_bb)
    if params_head is not None:
        for i in range(len(params_head)):
            params_head[f"c{i}"]["w"] = get(f"fc1_voc12_c{i}/weights")
            params_head[f"c{i}"]["b"] = get(f"fc1_voc12_c{i}/biases")
    return params_bb


def voc_params_from_kaffe_npy(npy_path: str, *, res4_blocks: int = 23,
                              num_classes: int = 21, device=None) -> dict:
    """The VOC model's parameters from a kaffe ``.npy``: {'backbone': the
    port's backbone tree, 'head': {'c0'..'c3': {'w' OIHW, 'b'}}} as
    float32 tensors on `device` (CUDA when None)."""
    from cmpc_refseg_torch.tools.pretrain_backbone import (init_numpy,
                                                           params_to_torch)
    tree = init_numpy(0, res4_blocks, num_classes)
    convert_backbone_from_kaffe_npy(npy_path, tree["backbone"], tree["head"])
    return params_to_torch(tree, device=device)
