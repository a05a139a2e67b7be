"""Host side of the VOC pretraining pipeline: the label palette, the data
list, image loading, augmentation, label downsampling and eval padding.

A copy of the JAX package's tools/pretrain_backbone.py helpers (the
reference's image_reader.py:6-93 and utils.py:41-59): the same numpy
`Generator` drawn in the same order (scale, then mirror, then crop) gives
the same bytes, so a seed gives the same batches in both packages.
Imports no torch: `downsample_labels` indexes numpy arrays and tensors
alike.
"""

from __future__ import annotations

import os

import numpy as np

# train.py:20 — caffe BGR mean (the CMPC drivers' values)
IMG_MEAN = np.array((104.00698793, 116.66876762, 122.67891434), np.float32)
IGNORE_LABEL = 255


def make_voc_colormap(n: int = 256) -> np.ndarray:
    """The PASCAL VOC label palette [n, 3] uint8 RGB (bit-interleave
    construction; deeplab_resnet/utils.py's label_colours for 0..20)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def downsample_labels(labels, factor: int = 8, out_size=None):
    """Nearest-neighbour downsample of labels [H, W] or [B, H, W] (numpy
    or a tensor) to the stride-`factor` grid, ceil(H / factor), or to
    `out_size` (oh, ow): tf.image.resize_nearest_neighbor's floor mapping
    (utils.py:55)."""
    h, w = labels.shape[-2:] if labels.ndim == 2 else labels.shape[1:3]
    if out_size is None:
        oh, ow = (h + factor - 1) // factor, (w + factor - 1) // factor
    else:
        oh, ow = out_size
    ridx = (np.arange(oh) * h / oh).astype(np.int64)
    cidx = (np.arange(ow) * w / ow).astype(np.int64)
    if isinstance(labels, np.ndarray):
        return labels[..., ridx[:, None], cidx[None, :]]
    return labels.index_select(-2, labels.new_tensor(ridx, dtype=int)) \
        .index_select(-1, labels.new_tensor(cidx, dtype=int))


def read_data_list(data_dir: str, data_list: str):
    """(image paths, mask paths) from lines of '<image> <mask>' relative to
    `data_dir` (image_reader.py:72-93)."""
    images, masks = [], []
    with open(data_list) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            im, mk = line.split()
            images.append(os.path.join(data_dir, im.lstrip("/")))
            masks.append(os.path.join(data_dir, mk.lstrip("/")))
    return images, masks


def load_image(im_path: str) -> np.ndarray:
    """float32 BGR [H, W, 3] minus IMG_MEAN."""
    import cv2
    return cv2.imread(im_path, cv2.IMREAD_COLOR).astype(np.float32) - IMG_MEAN


def load_label(mask_path: str) -> np.ndarray:
    """uint8 labels [H, W]: a palette PNG's indices (VOC's
    SegmentationClass files), any other image in cv2's grey levels (the
    SegmentationClassAug files hold the labels as grey levels).  The JAX
    package reads every mask through cv2's grey conversion, which turns a
    palette PNG's colours, not its indices, into labels."""
    from PIL import Image
    with Image.open(mask_path) as img:
        if img.mode == "P":
            return np.array(img, np.uint8)
    import cv2
    return cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)


def load_pair(im_path: str, mask_path: str):
    """(float32 BGR image minus IMG_MEAN, uint8 labels [H, W])."""
    return load_image(im_path), load_label(mask_path)


def augment_pair(rng: np.random.Generator, im: np.ndarray, label: np.ndarray,
                 crop_h: int, crop_w: int, *, scale=True, mirror=True):
    """Random scale U(0.5, 1.5) (bilinear image, nearest label), mirror with
    probability 1/2, zero-pad to the crop (label padded with IGNORE_LABEL)
    and a random crop (image_reader.py:6-70), drawn from `rng` in that
    order."""
    import cv2
    if scale:
        s = rng.uniform(0.5, 1.5)
        nh, nw = max(1, int(im.shape[0] * s)), max(1, int(im.shape[1] * s))
        im = cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR)
        label = cv2.resize(label, (nw, nh), interpolation=cv2.INTER_NEAREST)
    if mirror and rng.random() < 0.5:
        im, label = im[:, ::-1], label[:, ::-1]
    ph, pw = max(crop_h, im.shape[0]), max(crop_w, im.shape[1])
    if (ph, pw) != im.shape[:2]:
        pim = np.zeros((ph, pw, 3), np.float32)
        plb = np.full((ph, pw), IGNORE_LABEL, label.dtype)
        pim[: im.shape[0], : im.shape[1]] = im
        plb[: label.shape[0], : label.shape[1]] = label
        im, label = pim, plb
    y = rng.integers(0, ph - crop_h + 1)
    x = rng.integers(0, pw - crop_w + 1)
    return (np.ascontiguousarray(im[y: y + crop_h, x: x + crop_w]),
            np.ascontiguousarray(label[y: y + crop_h, x: x + crop_w]))


def pad_to_bucket(im: np.ndarray, label=None, multiple: int = 64):
    """Zero-pad the image to the next multiple of `multiple` on each side
    (label pixels padded with IGNORE_LABEL, int32); (image, (h, w)) or
    (image, label, (h, w)).  The port keeps the JAX package's buckets: the
    padding moves the feature grid and with it the logits resized back,
    so without it the mIoU would not be JAX's."""
    h, w = im.shape[:2]
    bh = ((h + multiple - 1) // multiple) * multiple
    bw = ((w + multiple - 1) // multiple) * multiple
    pim = np.zeros((bh, bw, 3), np.float32)
    pim[:h, :w] = im
    if label is None:
        return pim, (h, w)
    plb = np.full((bh, bw), IGNORE_LABEL, np.int32)
    plb[:h, :w] = label
    return pim, plb, (h, w)
