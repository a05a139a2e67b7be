"""YouTube-VOS / RefVOS full-set inference of the port (reference: test.py;
the JAX package's infer_video.py, with its flags plus `-device`).

Iterates meta_expressions.json videos -> expressions -> frames
(test.py:237-250), tokenizes each expression (:267), runs the image model
on the frames in fixed batches of `frame_batch` (the tail padded),
thresholds the sigmoid at `threshold` (default 0.5, :419), and writes PNG
masks at half resolution x255 (:307-308) through the async save worker
(:249,329); `-c` refines each mask with the DenseCRF first (:309-322).

  python -m cmpc_refseg_torch.infer_video -meta meta_expressions.json \
      -im_dir JPEGImages -out results -vocab vocab.txt -ckpt_dir ckpt

Runs on the CUDA device unless `-device cpu` is given (bf16 there,
float32 on the CPU); without a CUDA device and without `-device cpu` it
raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def find_pivot_frames(frames_feature, num_propagate: int = 2):
    """Pivot-frame selection for mask propagation (reference test.py:150-180,
    dormant in the reference's inference loop but part of its surface).

    Given per-frame global features (mask-pooled visual features), picks the
    frame most cosine-similar to all others as the first pivot, then walks
    frames ordered by distance to it, greedily selecting pivots and marking
    a +/- num_propagate neighborhood as covered.

    Returns selected frame indices (0-based), in selection order.
    """
    feats = np.asarray(frames_feature, dtype=np.float64)
    n = feats.shape[0]
    norm = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    sim = norm @ norm.T
    first_pivot = int(np.argmax(sim.sum(axis=0)))
    order = np.argsort(sim[first_pivot])
    available = np.ones(n, dtype=bool)
    selected = []
    for fid in order:
        if available[fid]:
            selected.append(int(fid))
            lo = max(fid - num_propagate, 0)
            hi = min(fid + num_propagate + 1, n)
            available[lo:hi] = False
    return selected


def video_output_mask(pred_raw, oh: int, ow: int) -> np.ndarray:
    """Output-resolution uint8 mask with exact reference semantics
    (test.py:307-308, 322-323): the model-resolution FLOAT 0/1 mask
    (sigmoid already thresholded, or CRF argmax) is bilinearly resized to
    (oh, ow) and then uint8-TRUNCATED and scaled x255 — fractional boundary
    pixels from the interpolation fall to 0 (the mask erodes), unlike
    thresholding after the resize."""
    from cmpc_refseg_torch.data.image import resize_and_crop
    return resize_and_crop(np.asarray(pred_raw, np.float32),
                           oh, ow).astype(np.uint8) * 255


def iter_video_expressions(meta_path: str):
    with open(meta_path) as f:
        meta = json.load(f)["videos"]
    for vid in sorted(meta.keys()):
        vdata = meta[vid]
        for eid in sorted(vdata["expressions"].keys()):
            yield vid, eid, vdata["expressions"][eid]["exp"], vdata["frames"]


def make_forward(cfg, inconsistency_report: bool, use_kernels: bool = True):
    """(params, model_state, batch) -> (sigm [B, H, W, 1], consistency [B]).
    With `inconsistency_report`, the consistency is the IoU of the first
    and last levels' aux heads, each sigmoid thresholded at 0.2
    (commented CMPCv5_model.py:146: iou_with_threshold(sigm(score_c4),
    sigm(score_c5), 0.2); test_v5+.py:302-303 flags it below 0.3), NaN
    where both are empty; else zeros, and the aux heads are not read."""
    import torch

    from cmpc_refseg_torch.models.model import apply_model
    lv_lo, lv_hi = cfg.levels[0], cfg.levels[-1]

    def area(x):
        return x.float().sum(dim=(1, 2, 3))

    def forward(params, model_state, batch):
        with torch.inference_mode():
            out = apply_model(params, cfg, batch, model_state=model_state,
                              use_kernels=use_kernels)
            if not inconsistency_report:
                return out.sigm, torch.zeros(out.sigm.shape[0])
            a = torch.sigmoid(out.up_levels[lv_lo]) > 0.2
            c = torch.sigmoid(out.up_levels[lv_hi]) > 0.2
            inter = area(a & c)
            return out.sigm, inter / (area(a) + area(c) - inter)
    return forward


def run_inference(cfg, params, model_state, *, meta_path: str, im_dir: str,
                  out_dir: str, vocab_path: str, threshold: float = 0.5,
                  use_crf: bool = False, frame_batch: int = 8,
                  half_resolution: bool = True, max_expressions=None,
                  inconsistency_report: bool = False, device=None,
                  use_kernels: bool = True):
    """Masks of every (video, expression, frame) of `meta_path` under
    `out_dir`/<video>/<expression>/<frame>.png; returns the number of
    expressions.  The image model `cfg` with `params` (port parameters,
    moved to `device`, CUDA when None, and prepared once) runs on batches
    of `frame_batch` frames of one expression.  With
    `inconsistency_report`, `out_dir`/inconsitent_frames.json lists the
    [video, expression, frame] whose aux heads disagree (`make_forward`;
    the reference's file name)."""
    import torch
    from PIL import Image

    from cmpc_refseg_torch.convert import resolve_device, to_device
    from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR, resize_and_pad
    from cmpc_refseg_torch.data.text import (load_vocab_dict_from_file,
                                             preprocess_sentence_lstm)
    from cmpc_refseg_torch.models.model import prepare_params
    from cmpc_refseg_torch.ops.densecrf import refine_mask
    from cmpc_refseg_torch.utils.save_image_worker import SaveImageWorker

    dev = resolve_device(device)
    params = prepare_params(to_device(params, dev), cfg)
    model_state = to_device(model_state or {}, dev)
    forward = make_forward(cfg, inconsistency_report, use_kernels)
    vocab = load_vocab_dict_from_file(vocab_path)
    saver = SaveImageWorker()
    inconsistent = []
    n_expr = 0
    for vid, eid, exp, frames in iter_video_expressions(meta_path):
        if max_expressions is not None and n_expr >= max_expressions:
            break
        n_expr += 1
        tokens, seq_len = preprocess_sentence_lstm(exp, vocab, cfg.num_steps)
        tokens = np.asarray(tokens, np.int32)

        for start in range(0, len(frames), frame_batch):
            chunk = frames[start:start + frame_batch]
            ims, natives, proc_ims = [], [], []
            for frame in chunk:
                with Image.open(os.path.join(im_dir, vid,
                                             f"{frame}.jpg")) as img:
                    native = np.asarray(img.convert("RGB"))
                natives.append(native)
                im = resize_and_pad(native.astype(np.float32), cfg.H, cfg.W)
                # model-resolution RGB (uint8): the CRF's pairwise image
                # (test.py:282,318: rgbim=proc_im)
                proc_ims.append(np.clip(im, 0, 255).astype(np.uint8))
                ims.append(im[..., ::-1] - IMAGE_MEAN_BGR)
            ims += [np.zeros_like(ims[0])] * (frame_batch - len(chunk))
            batch = {
                "im": np.stack(ims).astype(np.float32),
                "words": np.tile(tokens[None], (frame_batch, 1)),
                "seq_len": np.full((frame_batch,), seq_len, np.int32),
            }
            sigm_b, cons_b = forward(params, model_state, {
                k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            sigm = sigm_b[:, :, :, 0].float().cpu().numpy()
            cons = cons_b.float().cpu().numpy()
            for k, frame in enumerate(chunk):
                if (inconsistency_report and np.isfinite(cons[k])
                        and cons[k] < 0.3):
                    inconsistent.append((vid, eid, frame))
                oh, ow = natives[k].shape[:2]
                if half_resolution:
                    oh, ow = oh // 2, ow // 2
                # reference semantics (test.py:307-323): threshold (or CRF)
                # at MODEL resolution first, bilinear-resize the float 0/1
                # mask to output resolution, then uint8-truncate (x255)
                if use_crf:
                    pred_raw = refine_mask(proc_ims[k], sigm[k],
                                           0.5).astype(np.float32)
                else:
                    pred_raw = (sigm[k] >= threshold).astype(np.float32)
                saver.save_image(
                    os.path.join(out_dir, vid, eid, f"{frame}.png"),
                    video_output_mask(pred_raw, oh, ow))
    saver.flush()
    if inconsistency_report:
        # reference filename typo preserved (test_v5+.py:354)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "inconsitent_frames.json"), "w") as f:
            json.dump([list(t) for t in inconsistent], f)
    return n_expr


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("cmpc_refseg_torch YouTube-VOS inference")
    ap.add_argument("-n", dest="model_name", default="CMPC_model")
    ap.add_argument("-meta", dest="meta", required=True)
    ap.add_argument("-im_dir", dest="im_dir", required=True)
    ap.add_argument("-out", dest="out_dir", required=True)
    ap.add_argument("-vocab", dest="vocab", required=True)
    ap.add_argument("-ckpt_dir", dest="ckpt_dir", default="./checkpoints")
    ap.add_argument("-threshold", type=float, default=0.5)
    ap.add_argument("-c", dest="use_crf", action="store_true")
    ap.add_argument("-full_res", dest="full_res", action="store_true")
    ap.add_argument("-inconsistency_report", action="store_true",
                    help="write inconsitent_frames.json (test_v5+.py:354 "
                         "surface): frames whose c4/c5 aux-head masks "
                         "disagree (IoU@0.2 < 0.3)")
    ap.add_argument("-emb", dest="emb_name", default="refvos")
    ap.add_argument("-emb_dir", dest="emb_dir", default="data")
    ap.add_argument("-device", dest="device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu (the kernels' plain versions)")
    return ap


def main(argv=None):
    from cmpc_refseg_torch.cli import load_glove
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.convert import resolve_device
    from cmpc_refseg_torch.train.checkpoint import restore_checkpoint
    from cmpc_refseg_torch.train.trainer import create_train_state

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    cfg = get_config(args.model_name, batch_size=8, compute_dtype=dtype)
    glove = load_glove(args.emb_dir, args.emb_name)
    state = create_train_state(0, cfg, glove, device=device)
    state = restore_checkpoint(args.ckpt_dir, state)
    n = run_inference(cfg, state.params(), state.model_state,
                      meta_path=args.meta, im_dir=args.im_dir,
                      out_dir=args.out_dir, vocab_path=args.vocab,
                      threshold=args.threshold, use_crf=args.use_crf,
                      half_resolution=not args.full_res,
                      inconsistency_report=args.inconsistency_report,
                      device=device)
    print(f"done: {n} expressions")
    return n


if __name__ == "__main__":
    main()
