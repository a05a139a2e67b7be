"""Qualitative dumps of the port's forward (reference:
test_visualize_fusion*.py, test_visualize_graph.py, trainval_model.py
visualize_seg :306-334; the JAX package's tools/visualize.py).

From a checkpoint and an eval sample stream, per sample:
- `{i:05d}_sigm.png`, the mask probability as a heatmap;
- `{i:05d}_overlay.png`, the thresholded mask over the native image;
- `{i:05d}_up_{level}.png`, each level's upsampled score map;
- `{i:05d}_parse.json`, the words_parse distribution [T, K] and tokens;
- `{i:05d}_gw_{level}.png`, each word's graph attention (gw_v) in a grid
  of 5 columns (test_visualize_graph.py:269-274).

  python -m cmpc_refseg_torch.tools.visualize -d unc -t val -f ./data \
      -ckpt_dir ./checkpoints -out ./visualize -max 20

Runs on the CUDA device unless `-device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def colorize(prob: np.ndarray) -> np.ndarray:
    """[H, W] in [0, 1] -> uint8 RGB heatmap (blue -> red)."""
    p = np.clip(prob, 0, 1)
    r = (p * 255).astype(np.uint8)
    b = ((1 - p) * 255).astype(np.uint8)
    g = np.zeros_like(r)
    return np.stack([r, g, b], axis=-1)


def overlay(image: np.ndarray, mask: np.ndarray, alpha=0.5) -> np.ndarray:
    """`image` with red blended in over `mask`."""
    out = image.astype(np.float32).copy()
    out[mask] = (1 - alpha) * out[mask] + alpha * np.array([255, 0, 0])
    return out.astype(np.uint8)


def _np(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def dump_sample(out_dir: str, idx: int, sample: dict, outputs, tokens=None):
    """Write every visualization of one eval sample (`outputs` the port's
    `ModelOutputs` of a batch-1 forward)."""
    from PIL import Image

    from cmpc_refseg_torch.data.image import resize_and_crop
    os.makedirs(out_dir, exist_ok=True)
    sigm = _np(outputs.sigm)[0, :, :, 0]
    Image.fromarray(colorize(sigm)).save(
        os.path.join(out_dir, f"{idx:05d}_sigm.png"))
    if "im_native" in sample:
        native = np.asarray(sample["im_native"])
        mask = resize_and_crop(sigm, native.shape[0], native.shape[1]) > 0.5
        Image.fromarray(overlay(native, mask)).save(
            os.path.join(out_dir, f"{idx:05d}_overlay.png"))
    for lv, up in outputs.up_levels.items():
        prob = 1 / (1 + np.exp(-_np(up)[0, :, :, 0]))
        Image.fromarray(colorize(prob)).save(
            os.path.join(out_dir, f"{idx:05d}_up_{lv}.png"))

    parse = _np(outputs.words_parse)[0, 0]                # [T, K]
    rec = {"words_parse": parse.tolist()}
    if tokens is not None:
        rec["tokens"] = list(tokens)
    with open(os.path.join(out_dir, f"{idx:05d}_parse.json"), "w") as f:
        json.dump(rec, f, indent=2)

    # per-word graph attention grid (gw_v: [B, HW, T] per level)
    for lv, (_, gw_v) in outputs.gw.items():
        g = _np(gw_v)[0]                                   # [HW, T]
        hw, t = g.shape
        side = int(np.sqrt(hw))
        cols = 5
        rows = (t + cols - 1) // cols
        grid = np.zeros((rows * side, cols * side), np.float32)
        for w in range(t):
            r, c = divmod(w, cols)
            m = g[:, w].reshape(side, side)
            mx = m.max()
            grid[r * side:(r + 1) * side, c * side:(c + 1) * side] = (
                m / mx if mx > 0 else m)
        Image.fromarray(colorize(grid)).save(
            os.path.join(out_dir, f"{idx:05d}_gw_{lv}.png"))


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-n", dest="model_name", default="CMPC_model")
    ap.add_argument("-d", dest="dataset", default="unc")
    ap.add_argument("-t", dest="split", default="val")
    ap.add_argument("-f", dest="data_folder", default="./data")
    ap.add_argument("-ckpt_dir", dest="ckpt_dir", default="./checkpoints")
    ap.add_argument("-out", dest="out_dir", default="./visualize")
    ap.add_argument("-max", dest="max_samples", type=int, default=20)
    ap.add_argument("-device", dest="device", default=None,
                    help="torch device (CUDA when not given)")
    return ap


def load_model(args):
    """(config, `api.Model`) of the command line's arguments: the config
    `cli.make_config` gives at batch 1 (320x320, 20 words, bf16 on CUDA)
    and the newest checkpoint under -ckpt_dir restored into it."""
    from cmpc_refseg_torch.api import Model
    from cmpc_refseg_torch.cli import make_config
    from cmpc_refseg_torch.convert import resolve_device
    from cmpc_refseg_torch.models.model import prepare_params
    from cmpc_refseg_torch.train.checkpoint import restore_checkpoint
    from cmpc_refseg_torch.train.trainer import create_train_state

    device = resolve_device(args.device)
    args.batch_size, args.num_steps, args.H, args.W = 1, 20, 320, 320
    args.start_lr, args.conv5, args.compute_dtype = 2.5e-4, False, None
    args.grad_accum, args.emb_name = 1, None
    cfg, _ = make_config(args, device)
    state = restore_checkpoint(args.ckpt_dir, create_train_state(
        0, cfg, device=device))
    return cfg, Model(cfg=cfg, params=prepare_params(state.params(), cfg),
                      model_state=state.model_state, device=device)


def main(argv=None) -> int:
    """Dumps up to -max samples; returns the number dumped."""
    from cmpc_refseg_torch.cli import npz_eval_samples

    args = build_argparser().parse_args(argv)
    cfg, model = load_model(args)
    n = 0
    for i, sample in enumerate(npz_eval_samples(
            args.data_folder, args.dataset, args.split, cfg)):
        if i >= args.max_samples:
            break
        outputs = model.forward({k: sample[k] for k in ("im", "words",
                                                         "seq_len")})
        dump_sample(args.out_dir, i, sample, outputs,
                    tokens=sample["words"][0].tolist())
        n += 1
    print(f"wrote visualizations to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
