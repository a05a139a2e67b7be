#!/usr/bin/env python3
"""A reference TF-1.x checkpoint -> a port checkpoint at step 0.

    python3 tools/tf_checkpoint_to_torch.py --ckpt /path/model.ckpt-700000 \
        --model CMPC_model --out OUT

Maps the TF variables onto the JAX package's parameter tree and BN moving
statistics with tools/convert_tf_checkpoint.py's `convert`, converts both
to the port's layout on the CPU, and saves a fresh TrainState (step 0,
Adam's moments zero) under OUT (`cmpc_refseg_torch.train.checkpoint`).
Restore it with `restore_checkpoint(OUT, trainer.state)`, or serve its
`state.params()` with `state.model_state`.

Unlike the .npz that tools/convert_tf_checkpoint.py's own main() writes,
which holds the parameters only, the checkpoint keeps the ASPP decoder's
BN moving statistics (CMPCv4-v6): from that .npz,
`cmpc_refseg_torch.convert.params_from_npz` gives the parameters, and
the decoder configs would run on initial statistics.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(ckpt: str, model: str, out: str, overrides=None) -> None:
    """Convert the TF checkpoint `ckpt` of config `model` (with
    `overrides`) into step 0 of a port checkpoint under `out`."""
    import jax

    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.convert import model_state_from_jax, params_from_jax
    from cmpc_refseg_torch.train.checkpoint import save_checkpoint
    from cmpc_refseg_torch.train.trainer import train_state_from_params
    from tools.convert_tf_checkpoint import convert as tf_to_jax

    _, params, model_state = tf_to_jax(ckpt, model, overrides)
    cfg = get_config(model, **(overrides or {}))
    state = train_state_from_params(
        params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu"),
        cfg, model_state_from_jax(jax.tree.map(np.asarray, model_state),
                                  device="cpu"))
    save_checkpoint(out, state, 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--model", default="CMPC_model")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    convert(args.ckpt, args.model, args.out)
    print(f"wrote step 0 of {args.model} under {args.out}")


if __name__ == "__main__":
    main()
