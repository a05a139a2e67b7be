"""Image geometry: aspect-preserving resize-pad and resize-crop, box and
mask crops, brightness augmentation.

The port's own copy of the JAX package's framework-free image helpers
(reference: util/im_processing.py).  The reference resizes with
`skimage.transform.resize` (bilinear, half-pixel centers, gaussian
anti-aliasing on downscale).  Here the interpolation is cv2 when it
imports, with the same half-pixel mapping and an explicit gaussian
prefilter, and scipy.ndimage otherwise; both branches give the same
geometry.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

try:
    import cv2
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

# BGR mean pixel subtracted by every reference script (trainval_model.py:371)
IMAGE_MEAN_BGR = np.array([104.00698793, 116.66876762, 122.67891434],
                          dtype=np.float32)


def _resize_float(im: np.ndarray, out_h: int, out_w: int,
                  anti_alias: bool = True) -> np.ndarray:
    """Bilinear resize with half-pixel centers (skimage/cv2 convention);
    gaussian anti-aliasing when downscaling (skimage resize default)."""
    im = np.asarray(im, dtype=np.float32)
    in_h, in_w = im.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return im.copy()
    if anti_alias:
        factors = (in_h / out_h, in_w / out_w)
        sigmas = [max(0.0, (f - 1) / 2) for f in factors]
        if any(s > 0 for s in sigmas):
            if _HAS_CV2:
                # the same sampled-gaussian kernel and replicate border as
                # scipy's mode='nearest'; scipy radius = int(4*sigma+0.5)
                ky = 2 * int(4.0 * sigmas[0] + 0.5) + 1 if sigmas[0] else 1
                kx = 2 * int(4.0 * sigmas[1] + 0.5) + 1 if sigmas[1] else 1
                im = cv2.GaussianBlur(
                    im, (kx, ky), sigmaX=sigmas[1] or 1e-9,
                    sigmaY=sigmas[0] or 1e-9,
                    borderType=cv2.BORDER_REPLICATE)
            else:
                full_sigma = sigmas + [0.0] * (im.ndim - 2)
                im = ndi.gaussian_filter(im, sigma=full_sigma, mode="nearest")
    if _HAS_CV2:
        out = cv2.resize(im, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
        if im.ndim == 3 and out.ndim == 2:
            out = out[:, :, None]
        return out
    # scipy: map output coords to input with half-pixel centers
    coords = np.meshgrid(
        (np.arange(out_h) + 0.5) * in_h / out_h - 0.5,
        (np.arange(out_w) + 0.5) * in_w / out_w - 0.5,
        indexing="ij")
    if im.ndim == 2:
        return ndi.map_coordinates(im, coords, order=1, mode="nearest")
    chans = [ndi.map_coordinates(im[..., c], coords, order=1, mode="nearest")
             for c in range(im.shape[-1])]
    return np.stack(chans, axis=-1)


def resize(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """skimage.transform.resize-equivalent dispatch: bool masks resize
    nearest (order 0), float/uint8 resize bilinear with anti-aliasing."""
    if im.dtype == np.bool_:
        in_h, in_w = im.shape[:2]
        ys = np.minimum(((np.arange(out_h) + 0.5) * in_h / out_h
                         ).astype(np.int64), in_h - 1)
        xs = np.minimum(((np.arange(out_w) + 0.5) * in_w / out_w
                         ).astype(np.int64), in_w - 1)
        return im[np.ix_(ys, xs)]
    return _resize_float(im, out_h, out_w)


def resize_and_pad(im: np.ndarray, input_h: int, input_w: int) -> np.ndarray:
    """Aspect-preserving resize + centered zero pad (im_processing.py:7-23)."""
    im_h, im_w = im.shape[:2]
    scale = min(input_h / im_h, input_w / im_w)
    resized_h = int(np.round(im_h * scale))
    resized_w = int(np.round(im_w * scale))
    pad_h = int(np.floor(input_h - resized_h) / 2)
    pad_w = int(np.floor(input_w - resized_w) / 2)

    resized_im = resize(im, resized_h, resized_w)
    if im.ndim > 2:
        new_im = np.zeros((input_h, input_w, im.shape[2]),
                          dtype=resized_im.dtype)
    else:
        new_im = np.zeros((input_h, input_w), dtype=resized_im.dtype)
    new_im[pad_h:pad_h + resized_h, pad_w:pad_w + resized_w, ...] = resized_im
    return new_im


def resize_and_crop(im: np.ndarray, input_h: int, input_w: int) -> np.ndarray:
    """Inverse mapping that takes predictions back to native resolution
    (im_processing.py:25-41; eval at trainval_model.py:245)."""
    im_h, im_w = im.shape[:2]
    scale = max(input_h / im_h, input_w / im_w)
    resized_h = int(np.round(im_h * scale))
    resized_w = int(np.round(im_w * scale))
    crop_h = int(np.floor(resized_h - input_h) / 2)
    crop_w = int(np.floor(resized_w - input_w) / 2)

    resized_im = resize(im, resized_h, resized_w)
    return np.ascontiguousarray(
        resized_im[crop_h:crop_h + input_h, crop_w:crop_w + input_w, ...])


def bboxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """Tight [xmin, ymin, xmax, ymax] boxes per mask (im_processing.py:60-70)."""
    if masks.ndim == 2:
        masks = masks[np.newaxis, ...]
    num_mask = masks.shape[0]
    bboxes = np.zeros((num_mask, 4), dtype=np.int32)
    for n in range(num_mask):
        idx = np.nonzero(masks[n])
        if len(idx[0]) == 0:
            continue
        bboxes[n] = [np.min(idx[1]), np.min(idx[0]),
                     np.max(idx[1]), np.max(idx[0])]
    return bboxes


def crop_bboxes_subtract_mean(im: np.ndarray, bboxes, crop_size: int,
                              image_mean: np.ndarray) -> np.ndarray:
    """Per-bbox square crops, resized and mean-subtracted
    (im_processing.py:43-58): crop im[ymin:ymax+1, xmin:xmax+1], bilinear
    resize to crop_size x crop_size, round to uint8 scale, subtract mean."""
    bboxes = np.asarray(bboxes).reshape((-1, 4))
    im = np.clip(np.rint(np.asarray(im, np.float32)), 0, 255)
    out = np.zeros((bboxes.shape[0], crop_size, crop_size, 3), np.float32)
    for n, (xmin, ymin, xmax, ymax) in enumerate(bboxes):
        crop = im[ymin:ymax + 1, xmin:xmax + 1, :]
        out[n] = np.clip(np.rint(resize(crop, crop_size, crop_size)), 0, 255)
    return out - image_mean


def crop_masks_subtract_mean(im: np.ndarray, masks: np.ndarray,
                             crop_size: int,
                             image_mean: np.ndarray) -> np.ndarray:
    """Mask-tight crops with the background filled by the mean pixel
    (im_processing.py:72-92): mask out the image (background <- uint8 mean),
    crop each mask's tight bbox, resize to crop_size (the reference
    hard-codes 224 — equivalent whenever its call is valid), subtract mean."""
    masks = np.asarray(masks)
    if masks.ndim == 2:
        masks = masks[np.newaxis, ...]
    im = np.clip(np.rint(np.asarray(im, np.float32)), 0, 255
                 ).astype(np.uint8)
    bboxes = bboxes_from_masks(masks)
    out = np.zeros((masks.shape[0], crop_size, crop_size, 3), np.float32)
    mean_u8 = image_mean.astype(np.uint8)
    for n in range(masks.shape[0]):
        xmin, ymin, xmax, ymax = bboxes[n]
        mask = masks[n, ..., np.newaxis].astype(np.uint8)
        im_masked = im * mask + mean_u8 * (1 - mask)
        crop = im_masked[ymin:ymax + 1, xmin:xmax + 1, :].astype(np.float32)
        out[n] = np.clip(np.rint(resize(crop, crop_size, crop_size)), 0, 255)
    return out - image_mean


def brightness(x: np.ndarray, gamma: float = 0.2, gain: float = 1.0,
               is_random: bool = True, rng: np.random.Generator | None = None
               ) -> np.ndarray:
    """Gamma brightness augmentation (im_processing.py:94-113)."""
    if is_random:
        rng = rng or np.random.default_rng()
        gamma = rng.uniform(1 - gamma, 1 + gamma)
    x = np.asarray(x)
    if x.dtype == np.uint8:
        lut = (np.clip(((np.arange(256) / 255.0) ** gamma) * gain, 0, 1)
               * 255).astype(np.uint8)
        return lut[x]
    return np.clip((x ** gamma) * gain, 0, None)
