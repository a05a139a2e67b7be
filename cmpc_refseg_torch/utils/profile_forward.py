"""Where the time of the port's forward (or train step) goes on the GPU.

Runs cmpc_refseg_torch's forward of the flagship CMPC_model, or of the
config --model names (the video model's batch: 16-frame clips), at
320x320, bf16, full depth on CUDA under torch.profiler, or with --train
one train step (Trainer.step: forward, backward, Adam) on seeded uint8
batches, and prints the device
time per kernel name and per category (the port's own kernels,
convolutions, GEMMs, other), the device's busy share of the wall time, the
host time per call, the products of `ops.kernels.matmul_f32` by route,
and the time of each of the program's stages (`stage_rows`) with its
largest device operations (`stage_kernels`).  The Chrome trace goes to
<out>/forward/trace.json (<out>/train/trace.json with --train), written by
`utils.profiling.trace`.

    python -m cmpc_refseg_torch.utils.profile_forward [--batch 8]
        [--steps 3] [--train] [--model NAME] [--out DIR]
"""

import argparse
import bisect
import os
import re
import sys
import time

import numpy as np
import torch

from cmpc_refseg_torch.api import build_model, build_trainer
from cmpc_refseg_torch.ops import kernels
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


def innermost(spans):
    """A function of a host time (us) giving the name of the innermost of
    `spans` [(name, start, end)] around it (latest start, then earliest
    end), or 'outside'."""
    points = sorted({t for _, s, e in spans for t in (s, e)})
    names = []
    for t in points:
        best = ("outside", None)
        for name, s, e in spans:
            if s <= t < e and (best[1] is None or (s, -e) > best[1]):
                best = (name, (s, -e))
        names.append(best[0])

    def at(t):
        i = bisect.bisect_right(points, t) - 1
        return names[i] if i >= 0 else "outside"
    return at


def stage_rows(spans, launch_at: dict, device_ops, calls: int) -> dict:
    """{stage: [spans, host ms, device ms, ops, idle ms]} per call of the
    program's stages.  spans: [(name, start, end)] the `cmpc.*` host
    ranges (`utils.profiling.span`); launch_at: {correlation ID: start of
    the host call that launched the operation}; device_ops: [(correlation
    ID, start, end)] the kernels, copies and sets; times in us.

    An operation counts under the innermost span around its launch call,
    by interval and across threads (the autograd engine launches the
    backward from its own thread, inside `cmpc.backward`); 'outside' when
    no span is around it, 'unlinked' when no host call has its ID.  Host
    ms is a span's whole duration; device ms, ops and idle ms (the
    device's idle time while the stage is the innermost span) are the
    stage's own, not its children's."""
    at = innermost(spans)
    rows = {}

    def row(name):
        return rows.setdefault(name, [0, 0.0, 0.0, 0, 0.0])
    for name, s, e in spans:
        row(name)[0] += 1
        row(name)[1] += (e - s) / 1e3
    busy = []
    for corr, s, e in sorted(device_ops, key=lambda op: op[1]):
        r = row(at(launch_at[corr]) if corr in launch_at else "unlinked")
        r[2] += (e - s) / 1e3
        r[3] += 1
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [t for _, s, e in spans for t in (s, e)] + \
        [t for iv in busy for t in iv]
    cuts = sorted(set(edges))
    for a, b in zip(cuts, cuts[1:]):
        i = bisect.bisect_right(busy, [a, float("inf")]) - 1
        if i < 0 or busy[i][1] <= a:
            row(at(a))[4] += (b - a) / 1e3
    return {name: [v / calls for v in r] for name, r in rows.items()}


def _profiled_events(prof):
    """(spans, launch_at, device operations [(correlation ID, start, end,
    name)]) of a finished CPU + CUDA `torch.profiler` profile, as
    `stage_rows` takes them."""
    spans, launch_at, ops = [], {}, []
    events = prof.events()
    host = {ev.name for ev in events
            if not str(ev.device_type).endswith("CUDA")}
    for ev in events:
        iv = (ev.time_range.start, ev.time_range.end)
        if str(ev.device_type).endswith("CUDA"):
            if ev.name not in host and not getattr(
                    ev, "is_user_annotation", False):
                ops.append((ev.id, *iv, ev.name))
        elif ev.name.startswith("cmpc."):
            spans.append((ev.name, *iv))
        elif ev.name.startswith("cu"):
            launch_at[ev.id] = iv[0]
    return spans, launch_at, ops


def profiled_stages(prof, calls: int) -> dict:
    """`stage_rows` of a finished CPU + CUDA `torch.profiler` profile: the
    device's operations linked to the CUDA runtime or driver calls that
    launched them by correlation ID."""
    spans, launch_at, ops = _profiled_events(prof)
    return stage_rows(spans, launch_at, [op[:3] for op in ops], calls)


def stage_kernels(prof, calls: int) -> dict:
    """{stage: {device operation's name: [device ms, operations] per
    call}} of a finished CPU + CUDA profile, each operation under its
    stage as in `profiled_stages`."""
    spans, launch_at, ops = _profiled_events(prof)
    at = innermost(spans)
    out = {}
    for corr, s, e, name in ops:
        row = out.setdefault(at(launch_at[corr]) if corr in launch_at
                             else "unlinked", {}).setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e3 / calls
        row[1] += 1 / calls
    return out


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

    kernels.reset_launch_counts()
    with trace(os.path.join(args.out, "train" if args.train
                            else "forward")) as prof:
        for _ in range(args.steps):
            call(feed)
        torch.cuda.synchronize()
    routes = kernels.product_route_counts()

    rows, host_ops = [], 0
    averages = prof.key_averages()
    # a host range (`record_function`: the stages, Adam's step) shows on
    # the device's rows too, under its host name: not a kernel
    host = {ev.key for ev in averages
            if not str(ev.device_type).endswith("CUDA")}
    for ev in averages:
        if ev.key.startswith("aten::"):
            host_ops += ev.count
        elif ev.key not in host and str(ev.device_type).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            rows.append((dev_us / 1e3 / args.steps, ev.count // args.steps,
                         ev.key))
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
    print(f"products (matmul_f32) per {what}: " + ", ".join(
        f"{route} {n / args.steps:g}" for route, n in routes.items()))
    print(f"stages (per {what}: spans, host ms, then the stage's own "
          "device ms, device operations and device idle ms):")
    for name, r in sorted(profiled_stages(prof, args.steps).items(),
                          key=lambda kv: -kv[1][2]):
        print(f"  {name:14s} {r[0]:4.1f} {r[1]:9.3f} {r[2]:9.3f} "
              f"{r[3]:8.1f} {r[4]:9.3f}")
    print(f"each stage's top device operations (ms and operations per "
          f"{what}):")
    for name, ops in sorted(stage_kernels(prof, args.steps).items()):
        for op, (ms, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"  {name:14s} {ms:9.4f} {n:6.1f}  {op[:100]}")


if __name__ == "__main__":
    main()
