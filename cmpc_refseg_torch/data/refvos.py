"""RefVOS (YouTube-VOS referring) online data pipeline (the JAX package's
data/refvos.py, a copy: framework-free host code).

Reference: util/data_reader_refvos.py — loads a JPEG frame + palette PNG
mask, decodes the referred object by its palette color, resize-pads to
(H, W), derives YOLO anchor labels from the mask bbox, tokenizes the
expression (back-pad + seq_len).  PIL and cv2 are imported where a frame
is decoded, and nothing here imports torch: the readers' spawned workers
import this module.
"""

from __future__ import annotations

import json
import os
from functools import partial
from typing import Optional

import numpy as np

from cmpc_refseg_torch.data import image as im_proc
from cmpc_refseg_torch.data import text as text_proc
from cmpc_refseg_torch.data.anchors import preprocess_true_boxes
from cmpc_refseg_torch.data.reader import PrefetchReader, ProcessPrefetchReader

# palette colors of YouTube-VOS object ids (util/data_reader_refvos.py:14-21)
OBJECT_COLOR = {
    "1": [236, 95, 103],
    "2": [249, 145, 87],
    "3": [250, 200, 99],
    "4": [153, 199, 148],
    "5": [98, 179, 178],
    "6": [102, 153, 204],
}


def _imread(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _resized_geom(im_h: int, im_w: int, input_h: int, input_w: int):
    """The resize_and_pad target geometry (im_processing.py:7-23):
    (resized_h, resized_w, pad_h, pad_w)."""
    scale = min(input_h / im_h, input_w / im_w)
    resized_h = int(np.round(im_h * scale))
    resized_w = int(np.round(im_w * scale))
    pad_h = int(np.floor(input_h - resized_h) / 2)
    pad_w = int(np.floor(input_w - resized_w) / 2)
    return resized_h, resized_w, pad_h, pad_w


def load_frame_fast(path: str, input_h: int, input_w: int) -> np.ndarray:
    """Fast-path image load: scaled JPEG decode (libjpeg IDCT scaling via
    PIL draft — the file decodes directly at the smallest 1/2^k scale whose
    result still covers the resize target) + uint8 residual resize +
    centered pad — the decode-side lever for the host input pipeline.
    Semantically `resize_and_pad(imread(path))` rounded to uint8; numerics
    differ from the parity path only in the anti-aliasing filter (DCT box
    scaling + INTER_AREA vs gaussian + bilinear), a few LSB on synthetic
    720p frames (tests/test_readers.py pins the tolerance).  Non-JPEG files
    fall back to a full decode with the same uint8 resize."""
    import cv2
    from PIL import Image
    with Image.open(path) as im:
        native_w, native_h = im.size
        resized_h, resized_w, pad_h, pad_w = _resized_geom(
            native_h, native_w, input_h, input_w)
        if im.format == "JPEG":
            im.draft("RGB", (max(resized_w, 1), max(resized_h, 1)))
        arr = np.asarray(im.convert("RGB"))
    if arr.shape[:2] != (resized_h, resized_w):
        interp = (cv2.INTER_AREA if arr.shape[0] >= resized_h
                  else cv2.INTER_LINEAR)
        arr = cv2.resize(arr, (resized_w, resized_h), interpolation=interp)
    out = np.zeros((input_h, input_w, 3), np.uint8)
    out[pad_h:pad_h + resized_h, pad_w:pad_w + resized_w] = arr
    return out


def load_object_mask_fast(path: str, obj_id: str, input_h: int,
                          input_w: int) -> np.ndarray:
    """Fast-path mask load — BIT-IDENTICAL to
    `resize_and_pad(decode_object_mask(imread(path)))`: the bool resize is
    nearest sampling (image.resize order-0 branch), so sample the decoded
    plane at the output grid FIRST and color-compare only the sampled
    pixels (~25x fewer).  Palette ('P'-mode) PNGs — the real YouTube-VOS
    format — skip the RGB expansion entirely and match by palette index."""
    from PIL import Image
    with Image.open(path) as im:
        native_w, native_h = im.size
        resized_h, resized_w, pad_h, pad_w = _resized_geom(
            native_h, native_w, input_h, input_w)
        ys = np.minimum(((np.arange(resized_h) + 0.5) * native_h
                         / resized_h).astype(np.int64), native_h - 1)
        xs = np.minimum(((np.arange(resized_w) + 0.5) * native_w
                         / resized_w).astype(np.int64), native_w - 1)
        color = np.asarray(OBJECT_COLOR[obj_id], np.uint8)
        if im.mode == "P":
            idx = np.asarray(im)[np.ix_(ys, xs)]
            pal = np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)
            hits = np.nonzero((pal == color).all(1))[0]
            small = np.isin(idx, hits)
        else:
            rgb = np.asarray(im.convert("RGB"))[np.ix_(ys, xs)]
            small = ((rgb[..., 0] == color[0]) & (rgb[..., 1] == color[1])
                     & (rgb[..., 2] == color[2]))
    out = np.zeros((input_h, input_w), bool)
    out[pad_h:pad_h + resized_h, pad_w:pad_w + resized_w] = small
    return out


def decode_object_mask(mask_rgb: np.ndarray, obj_id: str) -> np.ndarray:
    """Binary mask of one object from a palette-rendered RGB mask image
    (util/data_reader_refvos.py:29-30: equality on the R channel after
    comparing all 3 channels — we match all 3 for robustness-equivalence)."""
    c = OBJECT_COLOR[obj_id]
    # three chained channel compares beat np.all(mask == color, -1) ~5x
    # (no [H,W,3] bool intermediate + reduction)
    return ((mask_rgb[..., 0] == c[0]) & (mask_rgb[..., 1] == c[1])
            & (mask_rgb[..., 2] == c[2]))


def preprocess_sample(im: np.ndarray, mask_rgb: np.ndarray, sent: str,
                      obj_id: str, vocab_dict: dict, T: int,
                      input_h: int, input_w: int,
                      anchors: Optional[np.ndarray] = None) -> dict:
    """One training record (util/data_reader_refvos.py:27-46)."""
    mask_obj = decode_object_mask(mask_rgb, obj_id)
    im_out = im_proc.resize_and_pad(im, input_h, input_w)
    im_out = np.clip(np.rint(im_out), 0, 255).astype(np.uint8)
    mask_out = im_proc.resize_and_pad(mask_obj, input_h, input_w)
    text, seq_len = text_proc.preprocess_sentence_lstm(sent, vocab_dict, T)
    rec = {
        "text_batch": np.asarray(text, np.int32),
        "im_batch": im_out,
        "seq_length": np.int32(seq_len),
        "mask_batch": mask_out > 0,
        "sent_batch": np.asarray(sent),
    }
    if anchors is not None:
        bbox = im_proc.bboxes_from_masks(np.asarray(mask_out))
        bbox = bbox.astype(np.float64)
        # reader stores [x, y, w, h] += -> [x1, y1, x2, y2]
        bbox[:, 2:4] += bbox[:, :2]
        label_bbox, true_bbox = preprocess_true_boxes(bbox, input_h, anchors)
        rec["label_bbox"] = label_bbox.astype(np.float32)
        rec["true_bbox"] = true_bbox.astype(np.float32)
    return rec


class RefVOSDataset:
    """Picklable index->sample loader over a metadata list of
    [im, mask, expression, obj_id] records (train_meta.json made by
    generate_trainmeta.py:29-48).  No threads/processes of its own, so it
    can be constructed inside multiprocessing workers."""

    def __init__(self, im_dir: str, mask_dir: str, metadata_path: str,
                 vocab_path: str, T: int = 20, input_h: int = 320,
                 input_w: int = 320, anchors: Optional[np.ndarray] = None,
                 fast_decode: bool = False):
        self.im_dir = im_dir
        self.mask_dir = mask_dir
        with open(metadata_path) as f:
            self.metadata = json.load(f)
        self.T = T
        self.input_h = input_h
        self.input_w = input_w
        self.anchors = anchors
        self.fast_decode = fast_decode
        self.vocab_dict = text_proc.load_vocab_dict_from_file(vocab_path)

    def __len__(self):
        return len(self.metadata)

    def load(self, i: int) -> dict:
        rec = self.metadata[i]
        im_name, mask_name, sent, obj_id = rec[:4]
        if self.fast_decode:
            return self._load_fast(im_name, mask_name, sent, obj_id)
        im = _imread(os.path.join(self.im_dir, im_name))
        mask = _imread(os.path.join(self.mask_dir, mask_name))[:, :, :3]
        return preprocess_sample(im, mask, sent, obj_id, self.vocab_dict,
                                 self.T, self.input_h, self.input_w,
                                 self.anchors)

    def _load_fast(self, im_name, mask_name, sent, obj_id) -> dict:
        """Decode-side fast path: scaled JPEG decode + uint8 resize for the
        frame (approximate to a few LSB), sampled-first palette decode for
        the mask (bit-identical) — see load_frame_fast /
        load_object_mask_fast."""
        im_out = load_frame_fast(os.path.join(self.im_dir, im_name),
                                 self.input_h, self.input_w)
        mask_out = load_object_mask_fast(
            os.path.join(self.mask_dir, mask_name), obj_id,
            self.input_h, self.input_w)
        text, seq_len = text_proc.preprocess_sentence_lstm(
            sent, self.vocab_dict, self.T)
        rec = {
            "text_batch": np.asarray(text, np.int32),
            "im_batch": im_out,
            "seq_length": np.int32(seq_len),
            "mask_batch": mask_out,
            "sent_batch": np.asarray(sent),
        }
        if self.anchors is not None:
            bbox = im_proc.bboxes_from_masks(np.asarray(mask_out))
            bbox = bbox.astype(np.float64)
            bbox[:, 2:4] += bbox[:, :2]
            label_bbox, true_bbox = preprocess_true_boxes(
                bbox, self.input_h, self.anchors)
            rec["label_bbox"] = label_bbox.astype(np.float32)
            rec["true_bbox"] = true_bbox.astype(np.float32)
        return rec


class RefVOSReader:
    """RefVOSDataset + prefetch.  ``num_workers<=1``: one daemon thread (the
    reference's shape, deterministic order).  ``num_workers>1``: worker
    PROCESSES (decode/resize are GIL-bound; threads scale negatively)."""

    COLLATE_KEYS = ["text_batch", "im_batch", "seq_length", "mask_batch"]

    def __init__(self, im_dir: str, mask_dir: str, metadata_path: str,
                 vocab_path: str, shuffle=True, prefetch_num: int = 8,
                 T: int = 20, input_h: int = 320, input_w: int = 320,
                 anchors: Optional[np.ndarray] = None, seed: int = 0,
                 num_workers: int = 1, shard_index: int = 0,
                 shard_count: int = 1, fast_decode: bool = False):
        self.dataset = RefVOSDataset(im_dir, mask_dir, metadata_path,
                                     vocab_path, T, input_h, input_w, anchors,
                                     fast_decode=fast_decode)
        self.num_batch = len(self.dataset)
        if num_workers > 1:
            factory = partial(RefVOSDataset, im_dir, mask_dir, metadata_path,
                              vocab_path, T, input_h, input_w, anchors,
                              fast_decode=fast_decode)
            self._reader = ProcessPrefetchReader(
                factory, self.num_batch, shuffle=shuffle,
                num_workers=num_workers, prefetch_num=prefetch_num,
                seed=seed, shard_index=shard_index, shard_count=shard_count)
        else:
            self._reader = PrefetchReader(self.num_batch, self.dataset.load,
                                          shuffle, prefetch_num, seed,
                                          shard_index=shard_index,
                                          shard_count=shard_count)

    def read_batch(self) -> dict:
        return self._reader.read()

    def read_collated(self, batch_size: int) -> dict:
        return self._reader.read_batch(batch_size, keys=self.COLLATE_KEYS)

    def close(self) -> None:
        """Stop the worker processes (a no-op for the prefetch thread,
        a daemon)."""
        if isinstance(self._reader, ProcessPrefetchReader):
            self._reader.close()


class RefVOSBertReader:
    """RefVOS reader with precomputed per-expression BERT features
    (reference util/data_reader_refvos_bert.py:29-70): metadata records are
    [im, mask, expression, obj_id, eid]; features live at
    ``bert_dir/{video}_{eid}.npz`` with keys 'feature' [T,768] and
    'mask' [T]."""

    def __init__(self, im_dir: str, mask_dir: str, bert_dir: str,
                 metadata_path: str, shuffle=True, prefetch_num: int = 8,
                 T: int = 20, input_h: int = 320, input_w: int = 320,
                 seed: int = 0, num_workers: int = 1, shard_index: int = 0,
                 shard_count: int = 1):
        self.im_dir = im_dir
        self.mask_dir = mask_dir
        self.bert_dir = bert_dir
        with open(metadata_path) as f:
            self.metadata = json.load(f)
        self.T = T
        self.input_h = input_h
        self.input_w = input_w
        self._reader = PrefetchReader(len(self.metadata), self._load,
                                      shuffle, prefetch_num, seed,
                                      num_workers=num_workers,
                                      shard_index=shard_index,
                                      shard_count=shard_count)
        self.num_batch = len(self.metadata)

    def _load(self, i: int) -> dict:
        im_name, mask_name, sent, obj_id, eid = self.metadata[i][:5]
        vid = im_name.split("/")[0]
        feats = np.load(os.path.join(self.bert_dir, f"{vid}_{eid}.npz"))
        im = _imread(os.path.join(self.im_dir, im_name))
        mask_rgb = _imread(os.path.join(self.mask_dir, mask_name))[:, :, :3]
        mask_obj = decode_object_mask(mask_rgb, obj_id)
        im_out = im_proc.resize_and_pad(
            im.astype(np.float32), self.input_h, self.input_w)
        mask_out = im_proc.resize_and_pad(
            mask_obj.astype(np.float32), self.input_h, self.input_w) > 0

        feature = np.asarray(feats["feature"], np.float32)
        seq_mask = np.asarray(feats["mask"], np.float32).reshape(-1)
        # pad/truncate to T
        t = feature.shape[0]
        if t >= self.T:
            feature, seq_mask = feature[:self.T], seq_mask[:self.T]
        else:
            feature = np.pad(feature, ((0, self.T - t), (0, 0)))
            seq_mask = np.pad(seq_mask, (0, self.T - t))
        return {
            "im_batch": im_out,
            "mask_batch": mask_out,
            "words_feat": feature,
            "sequence_mask": seq_mask,
        }

    def read_batch(self) -> dict:
        return self._reader.read()

    def read_collated(self, batch_size: int) -> dict:
        return self._reader.read_batch(
            batch_size,
            keys=["im_batch", "mask_batch", "words_feat", "sequence_mask"])
