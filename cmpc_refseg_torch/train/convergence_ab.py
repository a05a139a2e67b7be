"""The kernel route against the plain route over 300 train steps (the port
of the JAX package's tools/convergence_ab.py).

The kernel route's mutan backward takes its residual v = tanh(x @ W + b)
in bf16 (``ops/autograd.py``, `MutanFunction`), so its gradients match
autograd's exact vjp in the same dtype only to a few percent.  This trains
the same synthetic referring problem twice at full geometry (320 x 320,
ResNet-101, bs=8, bf16), from the same seed on the same batches: once on
the kernel route and once on the plain route (``use_kernels=False``:
autograd through the plain PyTorch versions).  The arms differ in nothing
else.  The 20-step smoothed loss curves must track: the gate is the JAX
package's, `max_rel_curve_gap` < 0.15 and `final_rel_gap` < 0.08 of the
plain curve's range.

The data is a copy of the JAX package's tools/convergence_proof.py
generator: images of 2-4 coloured shapes on a textured background, the
expression "the {colour} {shape}" naming one of them.

    python -m cmpc_refseg_torch.train.convergence_ab [--steps 300]
        [--batch-size 8] [--seed 0] [--out FILE]

Needs a CUDA device.  Prints one JSON line (the readings and `ok`); exits
1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

COLORS = {
    "red": (200, 40, 40), "green": (40, 180, 60), "blue": (40, 70, 200),
    "yellow": (220, 200, 50), "purple": (150, 60, 180),
    "cyan": (60, 190, 190),
}
SHAPES = ("circle", "square", "triangle")
VOCAB = ["<pad>", "<go>", "<eos>", "<unk>", "the"] + list(COLORS) + \
    list(SHAPES)
WORD_ID = {w: i for i, w in enumerate(VOCAB)}
# the JAX package's gate (tools/convergence_ab.py:101)
MAX_GAP, FINAL_GAP, WINDOW = 0.15, 0.08, 20


def _draw_shape(im, shape, color, cy, cx, r, yy, xx):
    if shape == "circle":
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    elif shape == "square":
        m = np.maximum(np.abs(yy - cy), np.abs(xx - cx)) < r
    else:   # triangle (isoceles, apex up)
        m = ((yy > cy - r) & (yy < cy + r)
             & (np.abs(xx - cx) < (yy - (cy - r)) / 2))
    im[m] = color
    return m


def make_sample(rng, H=320, W=320, n_objects=(2, 4)):
    """(image uint8 RGB, target mask bool, tokens [20], seq_len); the
    first shape drawn is the one the expression names."""
    yy, xx = np.mgrid[:H, :W]
    base = rng.integers(40, 160, (3,))
    im = (base[None, None] + rng.normal(0, 18, (H, W, 3))
          ).clip(0, 255).astype(np.float64)
    combos = [(c, s) for c in COLORS for s in SHAPES]
    rng.shuffle(combos)
    n = int(rng.integers(n_objects[0], n_objects[1] + 1))
    target_mask = tokens = None
    for k in range(n):
        color_name, shape = combos[k]
        r = int(rng.integers(max(6, H // 11), max(8, H // 6)))
        cy = int(rng.integers(r + 4, H - r - 4))
        cx = int(rng.integers(r + 4, W - r - 4))
        color = np.asarray(COLORS[color_name], np.float64) \
            + rng.normal(0, 8, (3,))
        m = _draw_shape(im, shape, color.clip(0, 255), cy, cx, r, yy, xx)
        if k == 0:
            target_mask = m
            tokens = [WORD_ID[w] for w in ("the", color_name, shape)]
    toks = np.zeros((20,), np.int32)
    toks[:len(tokens)] = tokens
    return im.astype(np.uint8), target_mask, toks, len(tokens)


def build_pool(n, seed, H=320, W=320):
    """n samples of `make_sample` from `seed`: (ims, masks, toks, lens)."""
    rng = np.random.default_rng(seed)
    ims = np.zeros((n, H, W, 3), np.uint8)
    masks = np.zeros((n, H, W), bool)
    toks = np.zeros((n, 20), np.int32)
    lens = np.zeros((n,), np.int32)
    for i in range(n):
        ims[i], masks[i], toks[i], lens[i] = make_sample(rng, H, W)
    return ims, masks, toks, lens


def run_arm(pool, *, steps: int, batch_size: int, seed: int,
            use_kernels: bool, device=None) -> list:
    """`steps` train steps of CMPC_model (bf16, lr decaying over `steps`)
    from `seed` on batches drawn from `pool` with `seed` + 1; the
    per-step 'loss_cls_all'."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.train.trainer import (create_train_state,
                                                 make_train_step)
    ims, masks, toks, lens = pool
    cfg = get_config("CMPC_model", batch_size=batch_size,
                     vocab_size=len(VOCAB), compute_dtype="bfloat16",
                     lr_decay_step=steps)
    state = create_train_state(seed, cfg, device=device)
    step_fn = make_train_step(cfg, use_kernels=use_kernels)
    rng = np.random.default_rng(seed + 1)
    losses = []
    for _ in range(steps):
        idx = rng.integers(0, len(ims), batch_size)
        metrics = step_fn(state, {"im_u8": ims[idx],
                                  "target_u8": masks[idx, ..., None]
                                  .astype(np.uint8),
                                  "words": toks[idx], "seq_len": lens[idx]})
        losses.append(float(metrics["loss_cls_all"]))
    return losses


def curve_gaps(kernel, plain, window: int = WINDOW) -> tuple:
    """(max, final) point-wise gap of the `window`-step smoothed curves,
    relative to the plain curve's range."""
    box = np.ones(window) / window
    sm_k = np.convolve(np.asarray(kernel), box, mode="valid")
    sm_p = np.convolve(np.asarray(plain), box, mode="valid")
    rel = np.abs(sm_k - sm_p) / max(sm_p.max() - sm_p.min(), 1e-6)
    return float(rel.max()), float(rel[-1]), float(sm_k[-1]), float(sm_p[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--out", default=None,
                    help="also write the readings and both curves here")
    args = ap.parse_args(argv)
    pool = build_pool(args.pool, args.seed)
    curves, secs = {}, {}
    for arm, use_kernels in (("kernel", True), ("plain", False)):
        t0 = time.perf_counter()
        curves[arm] = run_arm(pool, steps=args.steps,
                              batch_size=args.batch_size, seed=args.seed,
                              use_kernels=use_kernels)
        secs[arm] = time.perf_counter() - t0
    max_gap, final_gap, fin_k, fin_p = curve_gaps(curves["kernel"],
                                                  curves["plain"])
    ok = max_gap < MAX_GAP and final_gap < FINAL_GAP
    result = {"steps": args.steps, "batch_size": args.batch_size,
              "kernel_final_ma20": fin_k, "plain_final_ma20": fin_p,
              "kernel_first_loss": curves["kernel"][0],
              "plain_first_loss": curves["plain"][0],
              "max_rel_curve_gap": max_gap, "final_rel_gap": final_gap,
              "gate": {"max_rel_curve_gap": MAX_GAP,
                       "final_rel_gap": FINAL_GAP},
              "seconds": secs, "ok": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "kernel_losses": curves["kernel"],
                       "plain_losses": curves["plain"]}, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
