"""The one traffic generator: a pool of seeded batches from a mix's
parameters (benchmark/traffic/<mix>.json) and a configuration's model dims.

A mix gives:
  mode        'infer' (Model.forward on batches held on the device) or
              'train' (Trainer.step on uint8 host batches, as a reader
              hands them);
  batch       samples a call (images, or clips for the video model);
  pool        distinct batches made in set-up and cycled through;
  len_min, len_max, len_mean
              words per expression: 1 + Poisson(len_mean - 1), clipped;
  padding     'back' (tokens first, 'seq_len') or 'front' (pads first,
              'valid_idx', the number of pads);
  box_min     train masks: one box a sample, each side drawn from
              [box_min, 1] of the image's;
  and the check's parameters (`check.py`).

Every seed gives batches of the same shapes (expressions are padded to
num_steps), so the work of a call does not depend on the seed.  Images and
clips are uniform uint8 RGB drawn on the device; an infer batch holds them
as the model takes them (f32 BGR - mean), a train batch as uint8 on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.model import image_of_u8


def expression_lengths(rng, mix, n, t):
    """1 + Poisson(len_mean - 1) words, clipped to [len_min, len_max] and
    to the T = `t` positions the model reads."""
    lam = max(float(mix["len_mean"]) - 1.0, 0.0)
    return np.clip(1 + rng.poisson(lam, n), mix["len_min"],
                   min(mix["len_max"], t)).astype(np.int64)


def tokens(rng, model, mix, n):
    """Token ids [n, T] in [3, vocab) and their lengths or pad counts."""
    t = model["num_steps"]
    lens = expression_lengths(rng, mix, n, t)
    words = np.zeros((n, t), np.int64)
    front = mix["padding"] == "front"
    for i, k in enumerate(lens):
        ids = rng.integers(3, model["vocab_size"], k)
        if front:
            words[i, t - k:] = ids
        else:
            words[i, :k] = ids
    text = {"valid_idx": t - lens} if front else {"seq_len": lens}
    return {"words": words, **text}


def box_masks(rng, model, mix, n):
    """uint8 [n, H, W, 1]: one box a sample."""
    h, w = model["H"], model["W"]
    out = np.zeros((n, h, w, 1), np.uint8)
    lo = float(mix["box_min"])
    for m in out:
        bh = rng.integers(int(lo * h), h + 1)
        bw = rng.integers(int(lo * w), w + 1)
        y, x = rng.integers(0, h - bh + 1), rng.integers(0, w - bw + 1)
        m[y:y + bh, x:x + bw] = 1
    return out


def image_key(model):
    return "clip" if model["video"] else "im"


def make_pool(model, mix, seed, device):
    """`mix['pool']` batches from `seed` (see the module's docstring)."""
    rng = np.random.default_rng([int(seed), 7])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    b = mix["batch"]
    lead = (b, model["num_frames"]) if model["video"] else (b,)
    shape = (*lead, model["H"], model["W"], 3)
    pool = []
    for _ in range(mix["pool"]):
        u8 = torch.randint(0, 256, shape, generator=gen, device=device,
                           dtype=torch.uint8)
        text = tokens(rng, model, mix, b)
        if mix["mode"] == "infer":
            batch = {image_key(model): image_of_u8(u8),
                     **{k: torch.as_tensor(v, device=device)
                        for k, v in text.items()}}
        else:
            batch = {f"{image_key(model)}_u8": u8.cpu().numpy(),
                     "target_u8": box_masks(rng, model, mix, b), **text}
        pool.append(batch)
    return pool


def reference_batch(model, batch, rows, device):
    """Rows `rows` (a slice) of a pool batch as the reference takes it:
    'im' or 'frames' (the sampled frames) f32 BGR - mean on `device`,
    the tokens, and for a train batch 'target' f32."""
    def dev(v):
        return torch.as_tensor(v[rows], device=device)
    out = {k: dev(batch[k]) for k in ("words", "seq_len", "valid_idx")
           if k in batch}
    key = image_key(model)
    if key in batch:
        x = dev(batch[key])
    else:
        x = image_of_u8(dev(batch[f"{key}_u8"]))
    if model["video"]:
        idx = torch.as_tensor(model["sampled_frames"], device=device)
        out["frames"] = x.index_select(1, idx)
    else:
        out["im"] = x
    if "target_u8" in batch:
        out["target"] = dev(batch["target_u8"]).float()
    return out
