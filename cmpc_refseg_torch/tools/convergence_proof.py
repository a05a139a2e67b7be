"""Scaled convergence proof on the port: train the flagship CMPC model at
the full 320x320 / bs=8 geometry on a procedural multi-object referring
dataset and record the held-out IoU curve.

Every image holds several coloured shapes and the expression ("the
{color} {shape}") names exactly one, so the model must ground the
language, not segment saliency.  Done criterion: held-out IoU > 0.7.  The
dataset code is a copy of the JAX package's tools/convergence_proof.py, so
a seed gives its pool bit for bit; training runs on the port's
`build_trainer` / `Trainer.step` (bf16 on CUDA, float32 on the CPU) and the
hold-out on `Model.forward`'s logits (`up >= 1e-9`).

  python -m cmpc_refseg_torch.tools.convergence_proof --steps 4000

writes CONVERGENCE_torch.json (never the JAX package's CONVERGENCE.json);
``--tiny --device cpu`` is a small CPU run.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cmpc_refseg_torch.api import Model, build_trainer
from cmpc_refseg_torch.convert import resolve_device
from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR
from cmpc_refseg_torch.models.model import prepare_params

COLORS = {
    "red": (200, 40, 40), "green": (40, 180, 60), "blue": (40, 70, 200),
    "yellow": (220, 200, 50), "purple": (150, 60, 180),
    "cyan": (60, 190, 190),
}
SHAPES = ("circle", "square", "triangle")
VOCAB = ["<pad>", "<go>", "<eos>", "<unk>", "the"] + list(COLORS) + \
    list(SHAPES)
WORD_ID = {w: i for i, w in enumerate(VOCAB)}
T = 20


def draw_shape(im, mask, shape, color, cy, cx, r, yy, xx):
    """Paint one shape of radius r at (cy, cx) into `im`; returns its
    mask (or-ed into `mask` when given)."""
    if shape == "circle":
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    elif shape == "square":
        m = np.maximum(np.abs(yy - cy), np.abs(xx - cx)) < r
    else:   # triangle (isoceles, apex up)
        m = ((yy > cy - r) & (yy < cy + r)
             & (np.abs(xx - cx) < (yy - (cy - r)) / 2))
    im[m] = color
    if mask is not None:
        mask |= m
    return m


def make_sample(rng, H=320, W=320, n_objects=(2, 4)):
    """(image uint8 RGB, target mask bool, tokens [T], seq_len): 2-4 shapes
    on a textured background, the first drawn the target."""
    yy, xx = np.mgrid[:H, :W]
    base = rng.integers(40, 160, (3,))
    im = (base[None, None] + rng.normal(0, 18, (H, W, 3))
          ).clip(0, 255).astype(np.float64)

    combos = [(c, s) for c in COLORS for s in SHAPES]
    rng.shuffle(combos)
    n = int(rng.integers(n_objects[0], n_objects[1] + 1))
    target_mask = None
    tokens = None
    for k in range(n):
        color_name, shape = combos[k]
        r = int(rng.integers(max(6, H // 11), max(8, H // 6)))
        cy = int(rng.integers(r + 4, H - r - 4))
        cx = int(rng.integers(r + 4, W - r - 4))
        color = np.asarray(COLORS[color_name], np.float64) \
            + rng.normal(0, 8, (3,))
        m = draw_shape(im, None, shape, color.clip(0, 255), cy, cx, r,
                       yy, xx)
        if k == 0:
            target_mask = m
            tokens = [WORD_ID[w] for w in ("the", color_name, shape)]
    seq_len = len(tokens)
    toks = np.zeros((T,), np.int32)
    toks[:seq_len] = tokens
    return im.astype(np.uint8), target_mask, toks, seq_len


def build_pool(n, seed, H=320, W=320):
    """n samples from `default_rng(seed)`: images [n, H, W, 3] uint8,
    masks [n, H, W] bool, tokens [n, T] int32, lengths [n] int32."""
    rng = np.random.default_rng(seed)
    ims = np.zeros((n, H, W, 3), np.uint8)
    masks = np.zeros((n, H, W), bool)
    toks = np.zeros((n, T), np.int32)
    lens = np.zeros((n,), np.int32)
    for i in range(n):
        ims[i], masks[i], toks[i], lens[i] = make_sample(rng, H, W)
    return ims, masks, toks, lens


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--pool", type=int, default=1500)
    ap.add_argument("--holdout", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="CONVERGENCE_torch.json")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny geometry (64x64, res4_blocks 2, narrow)")
    ap.add_argument("--device", default=None,
                    help="torch device (CUDA when not given)")
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    geo = dict(H=64, W=64, res4_blocks=2, rnn_size=64, v_emb_dim=64,
               mlp_dim=48, glove_dim=16) if args.tiny else dict(glove_dim=50)
    trainer = build_trainer(
        "CMPC_model", seed=args.seed, device=device,
        dtype="bfloat16" if device.type == "cuda" else "float32",
        batch_size=args.batch_size, vocab_size=len(VOCAB), start_lr=args.lr,
        lr_decay_step=args.steps, **geo)
    cfg = trainer.cfg

    print(f"building {args.pool}+{args.holdout} samples ...", flush=True)
    t0 = time.time()
    ims, masks, toks, lens = build_pool(args.pool + args.holdout, args.seed,
                                        cfg.H, cfg.W)
    print(f"  built in {time.time() - t0:.0f}s", flush=True)

    def holdout_iou():
        state = trainer.state
        model = Model(cfg=cfg, params=prepare_params(state.params(), cfg),
                      model_state=state.model_state, device=device)
        inter = union = 0
        bs = args.batch_size
        for s in range(0, args.holdout - args.holdout % bs, bs):
            idx = np.arange(args.pool + s, args.pool + s + bs)
            im = ims[idx].astype(np.float32)[..., ::-1] - IMAGE_MEAN_BGR
            out = model.forward({"im": np.ascontiguousarray(im),
                                 "words": toks[idx], "seq_len": lens[idx]})
            pred = (out.up[..., 0] >= 1e-9).cpu().numpy()
            gt = masks[idx]
            inter += np.logical_and(pred, gt).sum()
            union += np.logical_or(pred, gt).sum()
        return float(inter) / float(max(union, 1))

    rng = np.random.default_rng(args.seed + 1)
    curve = []
    t_start = time.time()
    for it in range(args.steps):
        idx = rng.integers(0, args.pool, args.batch_size)
        metrics = trainer.step({
            "im_u8": ims[idx], "target_u8": masks[idx].astype(
                np.uint8)[..., None],
            "words": toks[idx], "seq_len": lens[idx]})
        if it % 100 == 0:
            print(f"step {it}: loss {float(metrics['loss_cls_all']):.1f} "
                  f"mIoU {float(metrics['train_mIoU']):.3f} "
                  f"({(time.time() - t_start):.0f}s)", flush=True)
        if (it + 1) % args.eval_every == 0 or it + 1 == args.steps:
            iou = holdout_iou()
            curve.append({"step": it + 1, "holdout_iou": round(iou, 4),
                          "s": round(time.time() - t_start, 1)})
            print(f"  holdout IoU @ {it + 1}: {iou:.4f}", flush=True)

    result = {
        "metric": "synthetic_grounding_holdout_iou",
        "value": curve[-1]["holdout_iou"],
        "steps": args.steps,
        "geometry": f"{cfg.H}x{cfg.W} bs={args.batch_size} "
                    f"{cfg.compute_dtype}",
        "curve": curve,
        "wall_clock_s": round(time.time() - t_start, 1),
        "passed": bool(curve[-1]["holdout_iou"] > 0.7),
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "curve"}))
    return result


if __name__ == "__main__":
    main()
