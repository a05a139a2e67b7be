"""Where the time of the port's forward (or train step) goes on the GPU.

Runs cmpc_refseg_torch's forward of the flagship CMPC_model, or of the
config --model names (the video model's batch: 16-frame clips), at
320x320, bf16, full depth on CUDA under torch.profiler, or with --train
one train step (Trainer.step: forward, backward, Adam) on seeded uint8
batches, and prints the device
time per kernel name and per category (the port's own kernels,
convolutions, GEMMs, other), the device's busy share of the wall time, and
the host time per call.  The Chrome trace goes to <out>/forward/trace.json
(<out>/train/trace.json with --train), written by `utils.profiling.trace`.

    python -m cmpc_refseg_torch.utils.profile_forward [--batch 8]
        [--steps 3] [--train] [--model NAME] [--out DIR]
"""

import argparse
import os
import re
import sys
import time

import numpy as np
import torch

from cmpc_refseg_torch.api import build_model, build_trainer
from cmpc_refseg_torch.utils.profiling import trace

CATEGORIES = (
    ("port kernels", re.compile(r"mutan_|spa_affinity|graph_msg|graph_update|se_sum|convlstm_")),
    ("convolution", re.compile(r"conv|cudnn|implicit_gemm|xmma_fprop|dgrad",
                               re.I)),
    ("gemm", re.compile(r"gemm|gemv|cutlass|cublas|sm90_xmma", re.I)),
)


def category(name: str) -> str:
    for label, pattern in CATEGORIES:
        if pattern.search(name):
            return label
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    ap.add_argument("--model", default="CMPC_model")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_forward: needs a CUDA GPU")

    what = "train step" if args.train else "forward"
    build = build_trainer if args.train else build_model
    model = build(args.model, device="cuda", dtype="bfloat16",
                  batch_size=args.batch)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    words = np.zeros((args.batch, cfg.num_steps), np.int64)
    words[:, :6] = rng.integers(3, cfg.vocab_size, (args.batch, 6))
    image, lead = ("clip", (args.batch, cfg.num_frames)) if cfg.video \
        else ("im", (args.batch,))
    if args.train:
        feed = {f"{image}_u8": rng.integers(0, 256, (*lead, cfg.H, cfg.W, 3),
                                            dtype=np.uint8),
                "target_u8": (rng.random((args.batch, cfg.H, cfg.W, 1))
                              > 0.7).astype(np.uint8),
                "words": words, "seq_len": np.full((args.batch,), 6)}
        call = model.step
    else:
        feed = {image: torch.as_tensor(50 * rng.standard_normal(
                    (*lead, cfg.H, cfg.W, 3)), dtype=torch.float32,
                    device="cuda"),
                "words": torch.as_tensor(words, device="cuda"),
                "seq_len": torch.full((args.batch,), 6, device="cuda")}
        call = model.forward
    for _ in range(2):
        call(feed)
    torch.cuda.synchronize()

    # host time to enqueue one call (no synchronize) against its wall
    # time: when they are close the call is bound by the host
    t0 = time.perf_counter()
    call(feed)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    with trace(os.path.join(args.out, "train" if args.train
                            else "forward")) as prof:
        for _ in range(args.steps):
            call(feed)
        torch.cuda.synchronize()

    rows, host_ops = [], 0
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):          # a device kernel
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            rows.append((dev_us / 1e3 / args.steps, ev.count // args.steps,
                         ev.key))
        elif ev.key.startswith("aten::"):
            host_ops += ev.count
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    card = torch.cuda.get_device_name(0)
    print(f"{card}: {args.model} {what} bs={args.batch}: {wall_ms:.3f} ms "
          f"wall, host "
          f"enqueue {enqueue_ms:.3f} ms; device kernels {busy_ms:.3f} ms "
          f"per call under the profiler ({busy_ms / wall_ms:.1%} of the "
          f"unprofiled wall); {host_ops // args.steps} aten ops and "
          f"{sum(r[1] for r in rows)} kernel launches per call")
    by_cat = {}
    for ms, _, name in rows:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label:14s} {ms:9.3f} ms  {ms / busy_ms:6.1%} of device "
              "time")
    print(f"top device kernels (ms per {what}, launches per {what}):")
    for ms, n, name in rows[:30]:
        print(f"  {ms:9.4f}  {n:5d}  {name[:110]}")


if __name__ == "__main__":
    main()
