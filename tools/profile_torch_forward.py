#!/usr/bin/env python3
"""Where the time of the port's flagship forward goes on the GPU.

Runs cmpc_refseg_torch's CMPC_model forward (320x320, bf16, full depth) on
CUDA under torch.profiler and prints the device time per kernel name and per
category (the port's own kernels, convolutions, GEMMs, other), the device's
busy share of the wall time, and the host time per forward.  The Chrome
trace goes to <out>/torch_forward_trace.json.

    python3 tools/profile_torch_forward.py [--batch 8] [--steps 3] [--out DIR]
"""

import argparse
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_forward: needs a CUDA GPU")
    from torch.profiler import ProfilerActivity, profile

    from cmpc_refseg_torch.api import build_model

    model = build_model("CMPC_model", device="cuda", dtype="bfloat16",
                        batch_size=args.batch)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    words = np.zeros((args.batch, cfg.num_steps), np.int64)
    words[:, :6] = rng.integers(3, cfg.vocab_size, (args.batch, 6))
    feed = {"im": torch.as_tensor(50 * rng.standard_normal(
                (args.batch, cfg.H, cfg.W, 3)), dtype=torch.float32,
                device="cuda"),
            "words": torch.as_tensor(words, device="cuda"),
            "seq_len": torch.full((args.batch,), 6, device="cuda")}
    for _ in range(2):
        model.forward(feed)
    torch.cuda.synchronize()

    # host time to enqueue one forward (no synchronize) against its wall
    # time: when they are close the forward is bound by the host
    t0 = time.perf_counter()
    model.forward(feed)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            model.forward(feed)
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
    print(f"{card}: forward bs={args.batch}: {wall_ms:.3f} ms wall, host "
          f"enqueue {enqueue_ms:.3f} ms; device kernels {busy_ms:.3f} ms "
          f"per forward under the profiler ({busy_ms / wall_ms:.1%} of the "
          f"unprofiled wall); {host_ops // args.steps} aten ops and "
          f"{sum(r[1] for r in rows)} kernel launches per forward")
    by_cat = {}
    for ms, _, name in rows:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label:14s} {ms:9.3f} ms  {ms / busy_ms:6.1%} of device "
              "time")
    print("top device kernels (ms per forward, launches per forward):")
    for ms, n, name in rows[:30]:
        print(f"  {ms:9.4f}  {n:5d}  {name[:110]}")
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out,
                                          "torch_forward_trace.json"))


if __name__ == "__main__":
    main()
