"""A2D video train / test driver of the port (reference:
CMPC_video/trainval_video.py; the JAX package's cli_video.py, with the
same flags plus `-device` and `-dtype`).

Train: clip [B, 16, H, W, 3] + the center frame's mask, from the npz
batches `data/a2d.py` writes.  Test: mean and overall IoU and
precision@0.5..0.95 (10 thresholds, trainval_video.py:147), skipping
samples whose ground truth is empty (:250-254).

  python -m cmpc_refseg_torch.cli_video -m train -f ./a2d_sent_new -bs 8
  python -m cmpc_refseg_torch.cli_video -m test -f ./a2d_sent_new

Runs on the CUDA device unless `-device cpu` is given, in bf16 there and
float32 on the CPU unless `-dtype` says otherwise; without a CUDA device
and without `-device cpu` it raises.  torch is imported by the functions
that run the model, not by the module.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR

SAMPLE_KEYS = ("text_batch", "seq_length", "mask_batch", "frames")
PRECISION_THRESHOLDS = tuple(0.5 + 0.05 * i for i in range(10))
# geometry / width overrides (ablations, CI smoke runs)
OVERRIDES = ("H", "W", "num_steps", "rnn_size", "v_emb_dim", "mlp_dim",
             "glove_dim", "res4_blocks", "vocab_size", "num_frames")


def prepare_video_batch(collated: dict) -> dict:
    """uint8 RGB frames -> float32 BGR - mean 'clip'; the center frame's
    mask as 'target'; int32 text (JAX's prepare_video_batch)."""
    frames = collated["frames"].astype(np.float32)      # [B,F,H,W,3] RGB
    out = {"clip": frames[..., ::-1] - IMAGE_MEAN_BGR,
           "target": collated["mask_batch"].astype(np.float32)[..., None],
           "words": collated["text_batch"].astype(np.int32)}
    if "seq_length" in collated:
        out["seq_len"] = collated["seq_length"].astype(np.int32).reshape(-1)
    return out


def prepare_video_batch_u8(collated: dict) -> dict:
    """The compact train feed: uint8 RGB 'clip_u8' and 'target_u8',
    expanded on the device (`train.trainer.device_clip_prologue`, which
    also gathers the sampled frames there)."""
    out = {"clip_u8": np.ascontiguousarray(
               collated["frames"].astype(np.uint8)),
           "target_u8": collated["mask_batch"].astype(np.uint8)[..., None],
           "words": collated["text_batch"].astype(np.int32)}
    if "seq_length" in collated:
        out["seq_len"] = collated["seq_length"].astype(np.int32).reshape(-1)
    return out


def evaluate_a2d(cfg, params, model_state, sample_iter, *, max_samples=None,
                 device=None, use_kernels: bool = True) -> dict:
    """A2D eval (trainval_video.py:147,230-280): each sample of
    `sample_iter` (`prepare_video_batch` of one sample: batch 1 with its
    'target') whose ground truth is empty is skipped before the forward;
    the others' sigm > 0.5 against the target gives the mean IoU, the
    overall IoU (summed I over summed U) and prec@0.50..0.95; 'n' counts
    the samples scored.  Forwards on `device` (CUDA when None)."""
    import torch

    from cmpc_refseg_torch.convert import resolve_device, to_device
    from cmpc_refseg_torch.models.model import apply_model, prepare_params

    dev = resolve_device(device)
    params = prepare_params(to_device(params, dev), cfg)
    model_state = to_device(model_state or {}, dev)
    correct = np.zeros(len(PRECISION_THRESHOLDS), np.int64)
    cum_i = cum_u = miou_sum = 0.0
    n = 0
    for k, sample in enumerate(sample_iter):
        if max_samples is not None and k >= max_samples:
            break
        sample = dict(sample)
        target = np.asarray(sample.pop("target"))[0, :, :, 0] > 0
        if not target.any():
            continue
        feed = {key: torch.as_tensor(np.asarray(v), device=dev)
                for key, v in sample.items()}
        with torch.inference_mode():
            sigm = apply_model(params, cfg, feed, model_state=model_state,
                               use_kernels=use_kernels).sigm
        pred = sigm[0, :, :, 0].float().cpu().numpy() > 0.5
        i = float(np.logical_and(pred, target).sum())
        u = float(np.logical_or(pred, target).sum())
        iou = i / u if u else 0.0
        cum_i += i
        cum_u += u
        miou_sum += iou
        correct += [iou >= t for t in PRECISION_THRESHOLDS]
        n += 1
    out = {"mean_iou": miou_sum / max(n, 1),
           "overall_iou": cum_i / max(cum_u, 1e-12), "n": n}
    for t, thr in enumerate(PRECISION_THRESHOLDS):
        out[f"prec@{thr:.2f}"] = correct[t] / max(n, 1)
    return out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("cmpc_refseg_torch video (A2D)")
    ap.add_argument("-m", dest="mode", required=True,
                    choices=["train", "test"])
    ap.add_argument("-f", dest="data_folder", default="./a2d_sent_new")
    ap.add_argument("-n", dest="model_name",
                    default="CMPC_video_mm_tgraph_allvec")
    ap.add_argument("-i", dest="max_iter", type=int, default=400_000)
    ap.add_argument("-s", dest="snapshot", type=int, default=20_000)
    ap.add_argument("-bs", dest="batch_size", type=int, default=1)
    ap.add_argument("-ckpt_dir", dest="ckpt_dir",
                    default="./checkpoints_video")
    ap.add_argument("-log_dir", dest="log_dir", default="./logs_video")
    ap.add_argument("-emb", dest="emb_name", default="Gref")
    ap.add_argument("-emb_dir", dest="emb_dir", default="data")
    for flag in OVERRIDES:
        ap.add_argument(f"-{flag}", type=int, default=None)
    ap.add_argument("-sampled_frames", default=None,
                    help="comma-separated frame indices (default "
                         "0,4,8,12,15)")
    ap.add_argument("-dtype", dest="compute_dtype", default=None,
                    help="float32|bfloat16 (default: bf16 on CUDA, float32 "
                         "on the CPU)")
    ap.add_argument("-device", dest="device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu (the kernels' plain versions)")
    return ap


def make_config(args, device):
    """The run's config on `device` (a torch.device)."""
    from cmpc_refseg_torch.config import get_config
    overrides = {k: getattr(args, k) for k in OVERRIDES
                 if getattr(args, k, None) is not None}
    if args.sampled_frames:
        overrides["sampled_frames"] = tuple(
            int(x) for x in args.sampled_frames.split(","))
    dtype = args.compute_dtype or ("bfloat16" if device.type == "cuda"
                                   else "float32")
    return get_config(args.model_name, batch_size=args.batch_size,
                      compute_dtype=dtype, **overrides)


def run_train(args, cfg, reader, glove, device):
    """The reference's loop: one step per batch of `reader`, the metrics
    logged every 100 iterations, a snapshot every `-s`, and at SIGTERM or
    SIGINT a checkpoint of the current iteration and a clean stop."""
    from cmpc_refseg_torch.train.checkpoint import save_checkpoint
    from cmpc_refseg_torch.train.trainer import (PreemptionGuard,
                                                 create_train_state,
                                                 make_train_step)
    from cmpc_refseg_torch.utils.logging import MetricLogger

    state = create_train_state(0, cfg, glove, device=device)
    step_fn = make_train_step(cfg)
    logger = MetricLogger(args.log_dir)
    try:
        with PreemptionGuard() as guard:
            for it in range(args.max_iter):
                if guard.fired:
                    save_checkpoint(args.ckpt_dir, state, it)
                    print(f"preempted at iter {it}: checkpoint saved, "
                          "exiting cleanly", flush=True)
                    break
                batch = prepare_video_batch_u8(reader.read_batch(
                    cfg.batch_size, keys=list(SAMPLE_KEYS)))
                metrics = step_fn(state, batch)
                if it % 100 == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    logger.log(it, metrics)
                    print(f"iter {it}: loss {metrics['loss_cls_all']:.2f} "
                          f"lr {metrics['learning_rate']:.2e}", flush=True)
                if (it + 1) % args.snapshot == 0:
                    save_checkpoint(args.ckpt_dir, state, it + 1)
    finally:
        logger.close()
    return state


def run_test(args, cfg, reader, glove, device):
    """The checkpoint under `-ckpt_dir` scored by `evaluate_a2d` over the
    test set, its results printed sorted by name."""
    from cmpc_refseg_torch.train.checkpoint import restore_checkpoint
    from cmpc_refseg_torch.train.trainer import create_train_state

    state = create_train_state(0, cfg, glove, device=device)
    state = restore_checkpoint(args.ckpt_dir, state)

    def samples():
        for _ in range(reader.num_samples):
            z = reader.read()
            yield prepare_video_batch({k: np.asarray(v)[None]
                                       for k, v in z.items()
                                       if k in SAMPLE_KEYS})

    results = evaluate_a2d(cfg, state.params(), state.model_state,
                           samples(), device=device)
    for k, v in sorted(results.items()):
        print(f"{k} = {v}")
    return results


def main(argv=None):
    from cmpc_refseg_torch.cli import load_glove
    from cmpc_refseg_torch.convert import resolve_device
    from cmpc_refseg_torch.data.reader import NpzReader

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_config(args, device)
    glove = load_glove(args.emb_dir, args.emb_name)
    split = "train" if args.mode == "train" else "test"
    reader = NpzReader(os.path.join(args.data_folder, f"{split}_batch"),
                       f"a2d_{split}", shuffle=(args.mode == "train"))
    run = run_train if args.mode == "train" else run_test
    return run(args, cfg, reader, glove, device)


if __name__ == "__main__":
    main()
