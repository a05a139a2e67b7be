#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (cmpc_refseg_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure:
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
 2. build: nvcc builds every kernel of the port from its sources (timed);
 3. kernels: each kernel's wrapper at the flagship main-path shapes (bs=8,
    320x320 -> N=1600 nodes, C=1000, K=1008, A=1000, T=20) against its
    plain PyTorch version on the same CUDA tensors: error against a stated
    tolerance; median times (CUDA events) of the kernel, the plain version
    and cuBLAS's bf16 product alone; the least time the card could take;
 4. forward: build_model("CMPC_model") on CUDA at 320x320, bs=8, bf16,
    full depth.  Launch counts are reset just before the timed forwards and
    read just after (3 launches of each kernel per forward); outputs must
    be finite and shaped, and sigm must agree with the same forward through
    the plain versions;
 5. the `kernels` JSON line, the nvidia-smi line and the final JSON line.

Exits non-zero, printing no result, without CUDA or without the package.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12        # H100 SXM f32 peak outside the tensor cores
HBM_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth

B, H_IMG, N, C, K, A, T, HEADS = 8, 320, 1600, 1000, 1008, 1000, 20, 5
N_FWD = 5
REPLACES = {
    "mutan_fused": "cmpc_refseg_tpu/ops/pallas_kernels.py:98",
    "spa_affinity": "cmpc_refseg_tpu/ops/pallas_kernels.py:1025",
    "graph_msg": "cmpc_refseg_tpu/ops/pallas_kernels.py:842",
    "graph_update": "cmpc_refseg_tpu/ops/pallas_kernels.py:884",
}
SOURCES = {
    "mutan_fused": "cmpc_refseg_torch/csrc/mutan.cu",
    "spa_affinity": "cmpc_refseg_torch/csrc/spa_affinity.cu",
    "graph_msg": "cmpc_refseg_torch/csrc/graph_conv.cu",
    "graph_update": "cmpc_refseg_torch/csrc/graph_conv.cu",
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def gpu_ms(torch, fn, groups=5, reps=10):
    """Median over `groups` of the mean CUDA-event time of `reps` back-to-back
    calls.  A spin kernel queued first lets the host enqueue every call
    before the timed ones start, so host overhead between calls is hidden."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops_mm, ops_f32, nbytes):
    """Least time: the larger of the bf16 products at the tensor-core peak,
    the f32 elementwise work at the f32 peak (the two units overlap) and
    the bytes at the memory rate."""
    t_ops = max(flops_mm / BF16_FLOPS, ops_f32 / F32_FLOPS)
    t_bytes = nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(torch, got, want, tol, what):
    """max |got - want| and the same over max |want|; fails past tol."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    norm = err / max(ref, 1e-30)
    if not math.isfinite(norm) or norm > tol:
        fail(f"{what}: max abs err {err:.3e} = {norm:.3e} of max |ref| "
             f"{ref:.3e}, tolerance {tol:.0e}")
    return err, norm


def compare_stats(torch, got, want, count, tol, what):
    """Whole-sample statistics given as (sum, sum of squares) partials
    [B, P, 2] over `count` entries per sample: per sample, the mean's error
    over the reference's standard deviation and the variance's relative
    error, each within tol (the two columns are held apart, each at its own
    scale).  Returns (max abs err of the summed columns, the larger of the
    two normalised errors)."""
    def moments(s):
        s = s.double().sum(dim=1)
        mean = s[:, 0] / count
        return s, mean, s[:, 1] / count - mean * mean
    gs, gm, gv = moments(got)
    ws, wm, wv = moments(want)
    err_mean = ((gm - wm).abs() / wv.clamp(min=1e-30).sqrt()).max().item()
    err_var = ((gv - wv).abs() / wv.clamp(min=1e-30)).max().item()
    norm = max(err_mean, err_var)
    if not math.isfinite(norm) or norm > tol:
        fail(f"{what}: mean error {err_mean:.3e} of the std, variance error "
             f"{err_var:.3e} of the variance, tolerance {tol:.0e}")
    return (gs - ws).abs().max().item(), norm


def kernel_inputs(torch, kernels, dev):
    """Flagship-shaped inputs made from a seed, scaled so the logits and
    products are O(1) as in the model; graph_update takes graph_msg's
    (msg, stats) as the main path does."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def uniform(*shape, limit, dtype=torch.bfloat16):
        u = torch.rand(*shape, generator=g, device=dev) * 2 - 1
        return (u * limit).to(dtype)

    lens = torch.randint(3, T + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    msg_args = (torch.softmax(randn(B, N, T, dtype=torch.float32), -1).to(
        torch.bfloat16), randn(B, T, C))
    msg, stats1 = kernels.graph_msg_plain(*msg_args)
    return {
        "mutan_fused": ((randn(B * N, K),
                   uniform(K, HEADS * C, limit=math.sqrt(6 / (K + HEADS * C))),
                   randn(HEADS * C, scale=0.1, dtype=torch.float32),
                   torch.tanh(randn(B, HEADS * C, dtype=torch.float32))),
                  {"heads": HEADS, "rows_per_sample": N}),
        "spa_affinity": ((randn(B, N, C), randn(C, A, scale=0.05),
                          randn(A, scale=0.1), randn(B, T, A),
                          torch.rand(B, 1, T, generator=g, device=dev),
                          mask[:, None].contiguous()),
                         {"scale": math.sqrt(C), "l2n": False,
                          "masked": True}),
        "graph_msg": (msg_args, {}),
        "graph_update": ((randn(B, N, C), msg, stats1,
                          uniform(C, C, limit=math.sqrt(3 / C)),
                          randn(C, scale=0.1),
                          1 + randn(C, scale=0.1, dtype=torch.float32),
                          randn(C, scale=0.1, dtype=torch.float32)), {}),
    }


def kernel_costs():
    """(bf16 product FLOPs, other f32 operations, bytes) of each function at
    the flagship shapes: each input read once, each output written once."""
    m = B * N
    return {
        "mutan_fused": (2 * m * K * HEADS * C, 4 * m * HEADS * C + 4 * m * C,
                        m * K * 2 + K * HEADS * C * 2 + HEADS * C * 4
                        + B * HEADS * C * 4 + m * C * 2),
        "spa_affinity": (2 * m * C * A + 2 * m * A * T,
                         2 * m * A + 12 * m * T,
                         m * C * 2 + C * A * 2 + A * 2 + B * T * A * 2
                         + 2 * B * T * 4 + 2 * m * T * 4),
        "graph_msg": (2 * m * T * C, 3 * m * C,
                      m * T * 2 + B * T * C * 2 + m * C * 2),
        "graph_update": (2 * m * C * C, 10 * m * C,
                         3 * m * C * 2 + C * C * 2 + C * 2 + 2 * C * 4),
    }


def check_kernels(torch, kernels, dev):
    """Phase 3: each kernel against its plain version; returns records."""
    inputs = kernel_inputs(torch, kernels, dev)
    products = {
        "mutan_fused": lambda x, w, *_r, **_k: torch.matmul(x, w),
        "spa_affinity": lambda x, wg, *_r, **_k: torch.matmul(x, wg),
        "graph_msg": lambda wa, p: torch.bmm(wa, p),
        "graph_update": lambda x, m, s, w, *_r: torch.matmul(x, w),
    }
    # bf16 outputs: the kernel and its plain version round at the same
    # places but sum in other orders, so a rounding may land one bf16 ulp
    # apart; 1e-2 of the largest entry admits one ulp there (at most 2^-7)
    tol = 1e-2
    # statistics: the same f32 sums in other orders over 1.6M entries per
    # sample, of msg / z values that may sit one bf16 ulp apart; both move
    # the mean and the variance by far less than 1e-3 of their size, while
    # a wrong or missing column moves them by its whole size
    stats_tol = 1e-3
    costs = kernel_costs()
    records = {}
    for wrapper in kernels.KERNELS:
        name = wrapper.__name__
        args, kw = inputs[name]
        plain = kernels.PLAIN[wrapper]
        torch.cuda.synchronize()
        got = wrapper(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs, stats = [], {}
        for i, (a, b) in enumerate(zip(got, want)):
            if name.startswith("graph_") and i == 1:   # statistics partials
                sum_err, stats_err = compare_stats(
                    torch, a, b, want[0][0].numel(), stats_tol,
                    f"{name} statistics")
                stats = {"stats_abs_err": sum_err, "stats_err": stats_err,
                         "stats_tolerance": stats_tol}
            else:
                errs.append(compare(torch, a, b, tol, f"{name} output {i}"))
        ms = gpu_ms(torch, lambda: wrapper(*args, **kw))
        plain_ms = gpu_ms(torch, lambda: plain(*args, **kw), groups=3,
                          reps=3)
        matmul_ms = gpu_ms(torch, lambda: products[name](*args))
        bound_ms, bound_by = bound(*costs[name])
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": max(e for e, _ in errs),
            "max_norm_err": max(n for _, n in errs),
            "tolerance": tol, **stats, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "matmul_ms": matmul_ms,
        }
        stats_note = (f"; statistics: mean/variance error {stats_err:.3e} <= "
                      f"{stats_tol:.0e}" if stats else "")
        log(f"[kernels] {name}: max abs err {records[name]['max_abs_err']:.3e}"
            f" (norm {records[name]['max_norm_err']:.3e} <= {tol:.0e})"
            f"{stats_note}; {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS "
            f"product alone {matmul_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return records


def make_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, cfg.num_steps + 1, cfg.batch_size)
    words = np.zeros((cfg.batch_size, cfg.num_steps), np.int64)
    for i, n in enumerate(lens):
        words[i, :n] = rng.integers(3, cfg.vocab_size, n)
    return {"im": (50 * rng.standard_normal(
                (cfg.batch_size, cfg.H, cfg.W, 3))).astype(np.float32),
            "words": words, "seq_len": lens.astype(np.int64)}


def run_forward(torch, kernels, build_model, apply_model, card):
    """Phase 4: the port's main path through its user entry point."""
    model = build_model("CMPC_model", device="cuda", dtype="bfloat16",
                        batch_size=B)
    cfg = model.cfg
    if (cfg.H, cfg.res4_blocks, cfg.v_emb_dim) != (H_IMG, 23, C):
        fail(f"unexpected flagship config {cfg}")
    feed = {k: torch.as_tensor(v, device="cuda")
            for k, v in make_batch(cfg).items()}
    model.forward(feed)                       # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(N_FWD):
        t0 = time.perf_counter()
        out = model.forward(feed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, n in counts.items():
        if n != 3 * N_FWD:
            fail(f"{name} launched {n} times in {N_FWD} forwards, "
                 f"expected {3 * N_FWD}")
    def plain_forward():
        # the same forward through the kernels' plain versions, on the card
        with torch.inference_mode():
            return apply_model(model.params, cfg, feed, use_kernels=False)

    plain_forward()                           # warm-up of the plain route
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain_forward()
    torch.cuda.synchronize()
    plain_fwd_ms = (time.perf_counter() - t0) * 1e3

    shapes = {"up": (B, cfg.H, cfg.W, 1), "sigm": (B, cfg.H, cfg.W, 1),
              "pred": (B, cfg.vf_h, cfg.vf_w, 1),
              "words_parse": (B, 1, cfg.num_steps, cfg.parse_classes)}
    for key, shape in shapes.items():
        v = getattr(out, key)
        if tuple(v.shape) != shape or not torch.isfinite(v).all():
            fail(f"forward output {key}: shape {tuple(v.shape)} (want "
                 f"{shape}) or non-finite values")
    # bf16 end to end: the kernels and the plain versions round at the same
    # places but sum in other orders, so single bf16 ulps (2^-8 relative)
    # differ and propagate through 3 levels and the fusion stack.
    sigm_tol = 2e-2
    sigm_err = (out.sigm - ref.sigm).abs().max().item()
    if not sigm_err <= sigm_tol:
        fail(f"sigm: kernels vs plain versions differ by {sigm_err:.3e} "
             f"> {sigm_tol}")
    ms = statistics.median(times)
    runs = [round(t, 3) for t in times]
    log(f"[forward] {card}: CMPC_model 320x320 bs={B} bf16 res4_blocks=23: "
        f"{ms:.3f} ms/batch (median of {N_FWD}; all {runs}), "
        f"{B / ms * 1e3:.1f} masks/s; plain-version forward "
        f"{plain_fwd_ms:.3f} ms; peak memory {peak_gb:.2f} GB; sigm vs plain "
        f"max abs {sigm_err:.3e} <= {sigm_tol}; sigm mean "
        f"{out.sigm.mean().item():.4f}")
    log(f"[forward] launches in {N_FWD} forwards: {counts}")
    return counts, ms


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")
    from cmpc_refseg_torch.api import build_model
    from cmpc_refseg_torch.models.model import apply_model
    from cmpc_refseg_torch.ops import build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {kind}")

    secs = build.build_all()
    log(f"[build] {secs:.1f} s for {list(build.SOURCES)}")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    records = check_kernels(torch, kernels, torch.device("cuda"))
    counts, fwd_ms = run_forward(torch, kernels, build_model, apply_model,
                                 card)
    for name, rec in records.items():
        rec["launches"] = counts[name]
        rec["forwards"] = N_FWD
    share = sum(r["ms"] * r["launches"] / N_FWD
                for r in records.values()) / fwd_ms
    log(f"[forward] the 4 kernels take {share:.1%} of the forward "
        "(kernel ms x launches / ms per batch)")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
