#!/usr/bin/env python3
"""A JAX package train-state checkpoint (orbax) -> a port checkpoint.

    python3 tools/jax_checkpoint_to_torch.py --ckpt_dir CKPT \
        --model CMPC_model --out OUT [--step N]

Restores step N (the newest when omitted) of the orbax checkpoint under
CKPT into a JAX train state of the config (the video model's built by
the JAX package's cli_video.create_video_train_state), through its
restore_checkpoint (which also migrates its legacy layouts); unravels the
flat trainable vector and Adam's first and second moments into trees;
builds the port's TrainState from them on the CPU
(`cmpc_refseg_torch.convert.train_state_from_jax`: weights, frozen
backbone, moments, Adam's count, BN moving statistics, and under
grad_accum > 1 the MultiSteps accumulator and micro-step count) and saves it as
the same step under OUT (`cmpc_refseg_torch.train.checkpoint`).  Restore
it with `restore_checkpoint(OUT, trainer.state)`.  This tool imports both
packages; the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(ckpt_dir: str, model: str, out: str, step=None,
            overrides=None) -> int:
    """Convert step `step` (the newest when None) of the JAX checkpoint
    under `ckpt_dir` for config `model` (with `overrides`); returns the
    step written under `out`."""
    import jax

    from cmpc_refseg_torch.config import get_config as torch_config
    from cmpc_refseg_torch.convert import train_state_from_jax
    from cmpc_refseg_torch.train.checkpoint import save_checkpoint
    from cmpc_refseg_tpu.config import get_config
    from cmpc_refseg_tpu.train.checkpoint import (latest_step,
                                                  restore_checkpoint)
    from cmpc_refseg_tpu.train.trainer import create_train_state

    overrides = overrides or {}
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    cfg = get_config(model, **overrides)
    if cfg.video:
        from cmpc_refseg_tpu.cli_video import create_video_train_state
        target = create_video_train_state(0, cfg)
    else:
        target = create_train_state(jax.random.PRNGKey(0), cfg)
    jstate = restore_checkpoint(ckpt_dir, target, step)

    def tree(flat):
        return jax.tree.map(np.asarray, jstate.unravel(flat))

    trees, extra = _jax_train_trees(jstate, tree)
    state = train_state_from_jax(
        *trees, torch_config(model, **overrides),
        model_state=jax.tree.map(np.asarray, jstate.model_state),
        device="cpu", **extra)
    save_checkpoint(out, state, step)
    return step


def _jax_train_trees(jstate, tree):
    """(trainable, frozen, mu, nu, count) of a JAX train state, and with
    grad_accum > 1 (optax MultiSteps) `step` and `accum` as keywords of
    `train_state_from_jax`, through `tree` (flat vector -> numpy tree)."""
    import jax
    opt = jstate.opt_state
    multi = hasattr(opt, "inner_opt_state")
    adam = (opt.inner_opt_state if multi else opt)[0]
    trees = [tree(jstate.trainable), jax.tree.map(np.asarray, jstate.frozen),
             tree(adam.mu), tree(adam.nu), int(adam.count)]
    if not multi:
        return trees, {}
    return trees, {"step": int(jstate.step), "accum": tree(opt.acc_grads)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--model", default="CMPC_model")
    ap.add_argument("--out", required=True)
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args()
    step = convert(args.ckpt_dir, args.model, args.out, args.step)
    print(f"wrote step {step} of {args.model} under {args.out}")


if __name__ == "__main__":
    main()
