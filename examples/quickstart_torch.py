"""Quickstart on the PyTorch / CUDA port: build a model, run a forward
pass, train a few steps.

Uses a tiny configuration and synthetic data, so it needs no dataset.
Runs on the CUDA device; ``--device cpu`` runs it on the CPU.

  python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (CUDA when not given)")
    args = ap.parse_args(argv)

    from cmpc_refseg_torch.api import build_model, build_trainer
    from cmpc_refseg_torch.config import VARIANTS
    from cmpc_refseg_torch.convert import resolve_device

    device = resolve_device(args.device)
    print(f"device: {device}")
    print(f"{len(VARIANTS)} model variants: {sorted(VARIANTS)[:4]} ...")

    tiny = dict(H=64, W=64, num_steps=8, vocab_size=100, glove_dim=16,
                rnn_size=32, v_emb_dim=32, mlp_dim=24, res4_blocks=2)

    # --- inference through the high-level API -----------------------------
    model = build_model("CMPC_model", device=device, **tiny)
    rng = np.random.default_rng(0)
    words = np.zeros((1, 8), np.int32)
    words[0, :3] = [5, 17, 31]          # token ids of "the red box"
    batch = {
        "im": rng.standard_normal((1, 64, 64, 3)).astype(np.float32),
        "words": words,
        "seq_len": np.asarray([3], np.int32),
    }
    out = model.forward(batch)
    print(f"forward: mask prob {tuple(out.sigm.shape)}, "
          f"word parse {tuple(out.words_parse.shape)}")

    # --- a few training steps ---------------------------------------------
    trainer = build_trainer("CMPC_model", device=device, batch_size=2,
                            start_lr=1e-3, **tiny)
    tb = {
        "im": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
        "words": np.tile(words, (2, 1)),
        "seq_len": np.asarray([3, 3], np.int32),
        "target": (rng.random((2, 64, 64, 1)) > 0.7).astype(np.float32),
    }
    losses = []
    for it in range(3):
        metrics = trainer.step(tb)
        losses.append(float(metrics["loss_cls_all"]))
        print(f"train step {it}: loss {losses[-1]:.2f}")
    print("ok")
    return losses


if __name__ == "__main__":
    main()
