"""A2D-Sentences video data pipeline: the port's own copy of the JAX
package's host code (numpy, PIL, h5py; no torch, which spawned readers
need not import).  h5py is imported by `get_masks` alone.

Reference: CMPC_video/build_A2D_batches.py — CSV annotations
(a2d_annotation.txt), h5 per-frame instance masks
(a2d_annotation_with_instances), 16-frame window centered on the GT frame
(frame_range :150-167), train/test split from Release/videoset.csv
(gen_split_dict :170-180).  Batches: {text_batch, mask_batch, sent_batch,
im_batch, frame_id, frames[16]}.
"""

from __future__ import annotations

import csv
import glob
import os
import re

import numpy as np

from cmpc_refseg_torch.data import image as im_proc
from cmpc_refseg_torch.data import text as text_proc

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")


def _imread(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def gen_split_dict(a2d_dir: str) -> dict:
    """video id -> split code (0 train / 1 test) from videoset.csv."""
    result = {}
    with open(os.path.join(a2d_dir, "Release/videoset.csv")) as f:
        for line in csv.reader(f):
            result[line[0]] = int(line[-1])
    return result


def frame_range(frame_id: int, frame_dir: str, window: int = 16):
    """16 frame paths centered on frame_id, clamped to the video extent
    (build_A2D_batches.py:150-167)."""
    frame_paths = sorted(os.listdir(frame_dir))
    frame_num = int(frame_paths[-1][:-4])
    result = []
    for i in range(frame_id - window // 2, frame_id + window // 2):
        fid = min(max(i, 1), frame_num)
        result.append(os.path.join(frame_dir, f"{fid:0>5d}.png"))
    assert len(result) == window
    return result


def get_masks(a2d_dir: str, video_id: str, instance_id):
    """Per-frame binary masks of one instance from the h5 annotation store
    (build_A2D_batches.py:183-209)."""
    import h5py
    mask_files = sorted(glob.glob(os.path.join(
        a2d_dir, "a2d_annotation_with_instances", video_id, "*")))
    masks, frame_ids = [], []
    for mask_file in mask_files:
        with h5py.File(mask_file, "r") as f:
            instance_ids = f["instance"][:]
            if instance_ids.shape[0] == 1:
                mask = f["reMask"][:].T
            else:
                index = np.squeeze(np.argwhere(instance_ids == instance_id))
                mask = np.squeeze(f["reMask"][index].T)
                if index.size != 1:
                    mask = np.sum(mask, axis=2)
        masks.append(mask)
        frame_ids.append(int(os.path.basename(mask_file)[:-3]))
    return masks, frame_ids


def build_a2d_batches(a2d_dir: str, out_dir: str, vocab_file: str,
                      T: int = 20, input_H: int = 320, input_W: int = 320,
                      video: bool = True, max_rows: int | None = None):
    """Write A2D train/test npz batches (build_A2D_batches.py:20-147)."""
    vocab_dict = text_proc.load_vocab_dict_from_file(vocab_file)
    split_dict = gen_split_dict(a2d_dir)
    frame_root = os.path.join(a2d_dir, "Release/frames")
    for sub in ("train_batch", "test_batch"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    counts = {"train": 0, "test": 0, "skipped_empty": 0}
    with open(os.path.join(a2d_dir, "a2d_annotation.txt")) as f:
        reader = csv.reader(f)
        next(reader)
        for row_i, row in enumerate(reader):
            if max_rows is not None and row_i >= max_rows:
                break
            video_id, instance_id, sent = row[0], int(row[1]), row[2]
            split = "test" if split_dict.get(video_id, 0) == 1 else "train"
            masks, frame_ids = get_masks(a2d_dir, video_id, instance_id)
            text, seq_len = text_proc.preprocess_sentence_lstm(
                sent, vocab_dict, T)
            frame_dir = os.path.join(frame_root, video_id)
            for mask, frame_id in zip(masks, frame_ids):
                if not np.any(mask):
                    counts["skipped_empty"] += 1
                    continue
                image = _imread(os.path.join(frame_dir,
                                             f"{frame_id:0>5d}.png"))
                image = np.clip(np.rint(im_proc.resize_and_pad(
                    image.astype(np.float32), input_H, input_W)),
                    0, 255).astype(np.uint8)
                mask_rp = im_proc.resize_and_pad(mask > 0, input_H, input_W)
                frames = []
                if video:
                    for fp in frame_range(frame_id, frame_dir):
                        fr = _imread(fp)
                        fr = np.clip(np.rint(im_proc.resize_and_pad(
                            fr.astype(np.float32), input_H, input_W)),
                            0, 255).astype(np.uint8)
                        frames.append(fr)
                n = counts[split]
                np.savez(os.path.join(out_dir, f"{split}_batch",
                                      f"a2d_{split}_{n}.npz"),
                         text_batch=np.asarray(text, np.int32),
                         seq_length=np.int32(seq_len),
                         mask_batch=(mask_rp > 0),
                         sent_batch=[sent],
                         im_batch=image,
                         frame_id=frame_id,
                         frames=np.stack(frames) if frames else
                         np.zeros((0,), np.uint8))
                counts[split] += 1
    return counts
