#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (cmpc_refseg_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure:
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
 2. build: nvcc builds every kernel of the port from its sources (timed);
 3. kernels: each kernel's wrapper at the shapes each path of phases 4
    and 5 gives it, against its plain PyTorch version on the same CUDA
    tensors: the flagship bs=8 forward (320x320 -> N=1600 nodes, C=1000,
    K=1008, A=1000, T=20, mlp C=500), the batch-1 request and the bs=64
    forward.  Where the packing rule packs the levels (bs=8 and bs=1), the
    graph kernels run on the packed batch (G=3 levels of B samples) and
    the affinity and update in their grouped forms; at bs=64 the graph
    runs level by level through the ungrouped forms.  One record per
    kernel and path: error against a stated tolerance; median times (CUDA
    events) of the kernel, the plain version and cuBLAS's bf16 product
    alone; the least time the card could take at those shapes;
 4. forward: build_model("CMPC_model") on CUDA at 320x320, bs=8, bf16,
    full depth.  Launch counts are reset just before the timed forwards and
    read just after (the counts the path needs per forward, see
    `expected_launches`); outputs must be finite and shaped, and sigm must
    agree with the same forward through the plain versions.  Then one
    forward at bs=64, above the packing threshold, where the spatial graph
    runs level by level through the ungrouped kernels, counted likewise;
 5. serving: build_service("CMPC_model") at 320x320, bf16, full depth,
    answers 20 requests (seeded images of several sizes and aspect ratios,
    3-20-word expressions) at batch 1.  Counts reset before the requests
    and read after; each mask has its image's native shape, and prob
    agrees with the plain route's.  Per-request latency, and the
    level-packed against the per-level spatial graph at batch 1 to
    128 (time and peak memory);
 6. the kernels' share of each path's run, the `kernels` JSON line (each
    record's launches are its path's count), the nvidia-smi line and the
    final JSON line.

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

DEV = "cuda"
B, H_IMG, N, C, K, A, T, HEADS = 8, 320, 1600, 1000, 1008, 1000, 20, 5
RES4 = 23                    # full depth: ResNet-101
CM, G = 500, 3               # mlp width (fusion stack); levels packed at bs=1
B_LARGE = 64                 # above the packing threshold: per-level graph
N_FWD = 5
SIGM_TOL = 2e-2
N_REQ = 20
PACK_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
REPLACES = {
    "mutan_fused": "cmpc_refseg_tpu/ops/pallas_kernels.py:98",
    "spa_affinity": "cmpc_refseg_tpu/ops/pallas_kernels.py:1025",
    "spa_affinity_grouped": "cmpc_refseg_tpu/ops/pallas_kernels.py:1025",
    "graph_msg": "cmpc_refseg_tpu/ops/pallas_kernels.py:842",
    "graph_update": "cmpc_refseg_tpu/ops/pallas_kernels.py:884",
    "graph_update_grouped": "cmpc_refseg_tpu/ops/pallas_kernels.py:884",
    "se_sum": "cmpc_refseg_tpu/ops/pallas_kernels.py:1155",
    "convlstm_gates": "cmpc_refseg_tpu/ops/pallas_kernels.py:643",
    "convlstm_raw": "cmpc_refseg_tpu/ops/pallas_kernels.py:703",
}
SOURCES = {
    "mutan_fused": "cmpc_refseg_torch/csrc/mutan.cu",
    "spa_affinity": "cmpc_refseg_torch/csrc/spa_affinity.cu",
    "spa_affinity_grouped": "cmpc_refseg_torch/csrc/spa_affinity.cu",
    "graph_msg": "cmpc_refseg_torch/csrc/graph_conv.cu",
    "graph_update": "cmpc_refseg_torch/csrc/graph_conv.cu",
    "graph_update_grouped": "cmpc_refseg_torch/csrc/graph_conv.cu",
    "se_sum": "cmpc_refseg_torch/csrc/se_sum.cu",
    "convlstm_gates": "cmpc_refseg_torch/csrc/convlstm.cu",
    "convlstm_raw": "cmpc_refseg_torch/csrc/convlstm.cu",
}
# which output of a wrapper holds statistics partials [B, P, (Q,) 2]
STATS_OUTPUT = {"graph_msg": 1, "graph_update": 1, "graph_update_grouped": 1,
                "convlstm_gates": 1, "convlstm_raw": 2}


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


def wall_ms(torch, fn, groups=5, reps=5):
    """Median over `groups` of the host-clock time of `reps` calls ending in
    a synchronize, per call: what a caller waits, host dispatch included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


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
    [B, P, 2], or [B, P, Q, 2] for Q statistics, over `count` entries per
    sample: per sample, the mean's error over the reference's standard
    deviation and the variance's relative error, each within tol (the two
    columns are held apart, each at its own scale).  Returns (max abs err
    of the summed columns, the larger of the two normalised errors)."""
    if got.dim() == 4:
        res = [compare_stats(torch, got[:, :, q], want[:, :, q], count, tol,
                             f"{what} [{q}]") for q in range(got.shape[2])]
        return max(r[0] for r in res), max(r[1] for r in res)

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


def path_batches():
    """The paths phases 4 and 5 drive, each with the batch its forward
    runs at: the bs=8 forward, the batch-1 request, and the bs=64 forward
    (above the packing threshold: the per-level spatial graph)."""
    return {"forward_bs8": B, "serving_bs1": 1,
            f"forward_bs{B_LARGE}": B_LARGE}


def kernel_inputs(torch, kernels, cmpc, dev, batch):
    """The inputs of each kernel the forward at `batch` launches, at the
    shapes it gives them, made from a seed and scaled so the logits and
    products are O(1) as in the model; graph_update takes graph_msg's
    (msg, stats) and convlstm_raw takes convlstm_gates' (gates, stats), as
    the path does.  Where the rule packs the levels, the graph kernels see
    the packed batch G*batch and the affinity and update take G weight
    groups.  Returns {wrapper name: (args, kwargs, kernel batch, groups)}."""
    g = torch.Generator(device=dev).manual_seed(batch)
    f32 = torch.float32

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def uniform(*shape, limit, dtype=torch.bfloat16):
        u = torch.rand(*shape, generator=g, device=dev) * 2 - 1
        return (u * limit).to(dtype)

    def word_mask(b):
        lens = torch.randint(3, T + 1, (b,), generator=g, device=dev)
        return (torch.arange(T, device=dev)[None] < lens[:, None]).float()[
            :, None].contiguous()

    def msg_args(b):
        return (torch.softmax(randn(b, N, T, dtype=f32), -1).to(
            torch.bfloat16), randn(b, T, C))

    packed = cmpc.pack_levels(batch, G)
    bg, lead, groups = (G * batch, (G,), G) if packed else (batch, (), 1)
    sfx = "_grouped" if packed else ""
    affinity = ((randn(bg, N, C), randn(*lead, C, A, scale=0.05),
                 randn(*lead, A, scale=0.1), randn(bg, T, A),
                 torch.rand(bg, 1, T, generator=g, device=dev),
                 word_mask(bg)),
                {"scale": math.sqrt(C), "l2n": False, "masked": True})
    msg, stats1 = kernels.graph_msg_plain(*msg_args(bg))
    update = (randn(bg, N, C), msg, stats1,
              uniform(*lead, C, C, limit=math.sqrt(3 / C)),
              randn(*lead, C, scale=0.1),
              1 + randn(*lead, C, scale=0.1, dtype=f32),
              randn(*lead, C, scale=0.1, dtype=f32))
    x, h, cell = (randn(batch, N, CM) for _ in range(3))
    gates_args = (x, h, cell, uniform(2 * CM, 4 * CM,
                                      limit=math.sqrt(6 / (6 * CM))),
                  uniform(N, CM, limit=0.1), uniform(N, CM, limit=0.1))
    gates, gstats = kernels.convlstm_gates_plain(*gates_args)
    return {
        "mutan_fused": ((randn(batch * N, K),
                         uniform(K, HEADS * C,
                                 limit=math.sqrt(6 / (K + HEADS * C))),
                         randn(HEADS * C, scale=0.1, dtype=f32),
                         torch.tanh(randn(batch, HEADS * C, dtype=f32))),
                        {"heads": HEADS, "rows_per_sample": N}, batch, 1),
        "spa_affinity" + sfx: (*affinity, bg, groups),
        "graph_msg": (msg_args(bg), {}, bg, 1),
        "graph_update" + sfx: (update, {}, bg, groups),
        "se_sum": ((randn(batch, N, CM), [randn(batch, N, CM)
                                          for _ in range(2)],
                    [torch.sigmoid(randn(batch, CM, dtype=f32)).to(
                        torch.bfloat16) for _ in range(2)],
                    [uniform(CM, CM, limit=math.sqrt(3 / CM))
                     for _ in range(2)],
                    [randn(CM, scale=0.1) for _ in range(2)]), {}, batch, 1),
        "convlstm_gates": (gates_args, {}, batch, 1),
        "convlstm_raw": ((gates, cell, uniform(N, CM, limit=0.1), gstats,
                          1 + randn(5, CM, scale=0.1, dtype=f32),
                          randn(5, CM, scale=0.1, dtype=f32)), {}, batch, 1),
    }


def kernel_cost(name, bk, groups):
    """(bf16 product FLOPs, other f32 operations, bytes) of a kernel's
    function on a batch of `bk` samples of N rows with `groups` weight
    groups: each input read once, each output written once."""
    m, cm = bk * N, CM
    if name == "mutan_fused":
        return (2 * m * K * HEADS * C, 4 * m * HEADS * C + 4 * m * C,
                m * K * 2 + K * HEADS * C * 2 + HEADS * C * 4
                + bk * HEADS * C * 4 + m * C * 2)
    if name.startswith("spa_affinity"):
        return (2 * m * C * A + 2 * m * A * T, 2 * m * A + 12 * m * T,
                m * C * 2 + groups * (C * A + A) * 2 + bk * T * A * 2
                + 2 * bk * T * 4 + 2 * m * T * 4)
    if name == "graph_msg":
        return (2 * m * T * C, 3 * m * C, m * T * 2 + bk * T * C * 2
                + m * C * 2)
    if name.startswith("graph_update"):
        return (2 * m * C * C, 10 * m * C,
                3 * m * C * 2 + groups * (C * C * 2 + C * 2 + 2 * C * 4))
    if name == "se_sum":     # 2 others: product, bias, relu, gate, add; norm
        return (2 * 2 * m * cm * cm, 2 * 5 * m * cm + 3 * m * cm,
                4 * m * cm * 2 + 2 * (cm * cm + cm + bk * cm) * 2)
    if name == "convlstm_gates":
        return (2 * m * 2 * cm * 4 * cm, 8 * m * cm,
                3 * m * cm * 2 + 2 * cm * 4 * cm * 2 + 2 * N * cm * 2
                + 4 * m * cm * 2)
    # convlstm_raw: 3 layer norms, tanh, 2 sigmoids, the cell and output
    # updates, the statistics: ~40 operations per element
    return (0, 40 * m * cm, 4 * m * cm * 2 + m * cm * 2 + N * cm * 2
            + 2 * 5 * cm * 4 + 2 * m * cm * 2)


def library_product(torch, name, args):
    """cuBLAS's bf16 product of the kernel's main GEMM alone on the same
    inputs, a yardstick (not the same function); None where the kernel has
    no product."""
    if name == "convlstm_gates":
        xh, w = torch.cat(args[:2], dim=-1), args[3]
        return lambda: torch.matmul(xh, w)
    if name == "se_sum":
        return lambda: [torch.matmul(o, w) for o, w in zip(args[1], args[3])]
    if name == "convlstm_raw":
        return None
    if name == "graph_msg":
        return lambda: torch.bmm(args[0], args[1])
    x, w = args[0], args[3 if name.startswith("graph_update") else 1]
    if name.endswith("_grouped"):          # [G, B/G*N, C] @ [G, C, A]
        xg = x.view(w.shape[0], -1, x.shape[-1])
        return lambda: torch.bmm(xg, w)
    return lambda: torch.matmul(x, w)


def check_kernels(torch, kernels, cmpc, dev):
    """Phase 3: each kernel of each path at the shapes that path gives it,
    against its plain version; returns one record per (kernel, path)."""
    # bf16 outputs: the kernel and its plain version round at the same
    # places but sum in other orders, so a rounding may land one bf16 ulp
    # apart; 1e-2 of the largest entry admits one ulp there (at most 2^-7)
    tol = 1e-2
    # statistics: the same f32 sums in other orders over up to 1.6M entries
    # per sample, of values that may sit one bf16 ulp apart; both move the
    # mean and the variance by far less than 1e-3 of their size, while a
    # wrong or missing column moves them by its whole size
    stats_tol = 1e-3
    records = []
    for path, batch in path_batches().items():
        inputs = kernel_inputs(torch, kernels, cmpc, dev, batch)
        for name, (args, kw, bk, groups) in inputs.items():
            wrapper = getattr(kernels, name)
            plain = kernels.PLAIN[wrapper]
            what = f"{name} at {path}"
            torch.cuda.synchronize()
            got = wrapper(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs, stats = [], {}
            for i, (a, b) in enumerate(zip(got, want)):
                if STATS_OUTPUT.get(name) == i:
                    count = want[0].shape[-2] * want[0].shape[-1]
                    sum_err, stats_err = compare_stats(
                        torch, a, b, count, stats_tol, f"{what} statistics")
                    stats = {"stats_abs_err": sum_err, "stats_err": stats_err,
                             "stats_tolerance": stats_tol}
                else:
                    errs.append(compare(torch, a, b, tol, f"{what} output {i}"))
            del got, want
            ms = gpu_ms(torch, lambda: wrapper(*args, **kw))
            plain_ms = gpu_ms(torch, lambda: plain(*args, **kw), groups=3,
                              reps=3)
            product = library_product(torch, name, args)
            matmul_ms = gpu_ms(torch, product) if product else None
            bound_ms, bound_by = bound(*kernel_cost(name, bk, groups))
            rec = {
                "name": f"{name}@{path}", "kernel": name, "path": path,
                "shape": {"batch": bk, "groups": groups, "rows": bk * N},
                "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": max(e for e, _ in errs),
                "max_norm_err": max(n for _, n in errs),
                "tolerance": tol, **stats, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "matmul_ms": matmul_ms,
            }
            records.append(rec)
            stats_note = (f"; statistics: mean/variance error "
                          f"{stats_err:.3e} <= {stats_tol:.0e}"
                          if stats else "")
            prod = (f"cuBLAS product alone {matmul_ms:.4f} ms"
                    if matmul_ms is not None else "no product")
            log(f"[kernels] {name} at {path} (batch {bk}, {groups} weight "
                f"group(s)): max abs err {rec['max_abs_err']:.3e} (norm "
                f"{rec['max_norm_err']:.3e} <= {tol:.0e}){stats_note}; "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {prod}, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
        del inputs
        torch.cuda.empty_cache()
    return records


def expected_launches(cmpc, batch, levels=3):
    """Kernel launches of one flagship forward at `batch`: one mutan, one
    graph per level (or one packed set of launches), one SE sum per level
    in each of the two exchange rounds, and one ConvLSTM step per level."""
    packed = cmpc.pack_levels(batch, levels)
    per_level = 0 if packed else levels
    return {"mutan_fused": levels, "spa_affinity": per_level,
            "spa_affinity_grouped": int(packed),
            "graph_msg": 1 if packed else levels, "graph_update": per_level,
            "graph_update_grouped": int(packed),
            "se_sum": 2 * levels, "convlstm_gates": levels,
            "convlstm_raw": levels}


def check_counts(counts, expected, runs, what):
    for name, n in counts.items():
        if n != expected[name] * runs:
            fail(f"{what}: {name} launched {n} times in {runs} runs, "
                 f"expected {expected[name] * runs}")


def make_batch(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, cfg.num_steps + 1, batch)
    words = np.zeros((batch, cfg.num_steps), np.int64)
    for i, n in enumerate(lens):
        words[i, :n] = rng.integers(3, cfg.vocab_size, n)
    return {"im": (50 * rng.standard_normal(
                (batch, cfg.H, cfg.W, 3))).astype(np.float32),
            "words": words, "seq_len": lens.astype(np.int64)}


def check_forward(torch, cfg, out, ref, batch, what):
    """Outputs finite and shaped, and sigm within the bf16 tolerance of the
    plain route's; returns the sigm error."""
    shapes = {"up": (batch, cfg.H, cfg.W, 1), "sigm": (batch, cfg.H, cfg.W, 1),
              "pred": (batch, cfg.vf_h, cfg.vf_w, 1),
              "words_parse": (batch, 1, cfg.num_steps, cfg.parse_classes)}
    for key, shape in shapes.items():
        v = getattr(out, key)
        if tuple(v.shape) != shape or not torch.isfinite(v).all():
            fail(f"{what} output {key}: shape {tuple(v.shape)} (want "
                 f"{shape}) or non-finite values")
    # bf16 end to end: the kernels and the plain versions round at the same
    # places but sum in other orders, so single bf16 ulps (2^-8 relative)
    # differ and propagate through 3 levels and the fusion stack.
    sigm_err = (out.sigm - ref.sigm).abs().max().item()
    if not sigm_err <= SIGM_TOL:
        fail(f"{what} sigm: kernels vs plain versions differ by "
             f"{sigm_err:.3e} > {SIGM_TOL}")
    return sigm_err


def run_forward(torch, kernels, cmpc, build_model, apply_model, card):
    """Phase 4: the port's main path through its user entry point."""
    model = build_model("CMPC_model", device=DEV, dtype="bfloat16",
                        batch_size=B)
    cfg = model.cfg
    if (cfg.H, cfg.res4_blocks, cfg.v_emb_dim) != (H_IMG, RES4, C):
        fail(f"unexpected flagship config {cfg}")
    feed = {k: torch.as_tensor(v, device=DEV)
            for k, v in make_batch(cfg, B).items()}
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
    check_counts(counts, expected_launches(cmpc, B), N_FWD, "forward")

    def plain_forward(f):
        # the same forward through the kernels' plain versions, on the card
        with torch.inference_mode():
            return apply_model(model.params, cfg, f, use_kernels=False)

    plain_forward(feed)                       # warm-up of the plain route
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain_forward(feed)
    torch.cuda.synchronize()
    plain_fwd_ms = (time.perf_counter() - t0) * 1e3
    sigm_err = check_forward(torch, cfg, out, ref, B, "forward")
    ms = statistics.median(times)
    runs = [round(t, 3) for t in times]
    log(f"[forward] {card}: CMPC_model 320x320 bs={B} bf16 res4_blocks=23: "
        f"{ms:.3f} ms/batch (median of {N_FWD}; all {runs}), "
        f"{B / ms * 1e3:.1f} masks/s; plain-version forward "
        f"{plain_fwd_ms:.3f} ms; peak memory {peak_gb:.2f} GB; sigm vs plain "
        f"max abs {sigm_err:.3e} <= {SIGM_TOL}; sigm mean "
        f"{out.sigm.mean().item():.4f}")
    log(f"[forward] launches in {N_FWD} forwards: {counts}")

    # one forward above the packing threshold: the per-level spatial graph
    big = {k: torch.as_tensor(v, device=DEV)
           for k, v in make_batch(cfg, B_LARGE, seed=1).items()}
    model.forward(big)                        # warm-up at this shape
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.forward(big)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    big_counts = kernels.launch_counts()
    check_counts(big_counts, expected_launches(cmpc, B_LARGE), 1,
                 f"forward bs={B_LARGE}")
    big_err = check_forward(torch, cfg, out, plain_forward(big), B_LARGE,
                            f"forward bs={B_LARGE}")
    log(f"[forward] {card}: bs={B_LARGE} (per-level spatial graph): "
        f"{big_ms:.3f} ms/batch (one run), {B_LARGE / big_ms * 1e3:.1f} "
        f"masks/s; sigm vs plain max abs {big_err:.3e}; launches {big_counts}")
    return {"forward_bs8": (counts, N_FWD, ms),
            f"forward_bs{B_LARGE}": (big_counts, 1, big_ms)}


def request_set(np, vocab_size):
    """N_REQ requests: seeded uint8 RGB images of several native sizes and
    aspect ratios (COCO-like, landscape, portrait and square) and 3-20-word
    expressions over the synthetic vocabulary."""
    rng = np.random.default_rng(0)
    sizes = [(480, 640), (640, 427), (375, 500), (512, 512), (427, 640),
             (333, 500), (640, 480), (240, 320), (500, 375), (360, 640)]
    out = []
    for i in range(N_REQ):
        h, w = sizes[i % len(sizes)]
        words = rng.integers(4, vocab_size, rng.integers(3, 21))
        out.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                    " ".join(f"w{v}" for v in words)))
    return out


def peak_gb(torch, fn):
    """Device memory a call allocates at its peak above what was allocated
    before it (its outputs included), in GB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def time_packing(torch, cmpc, svc, card):
    """The level-packed against the per-level spatial graph on the card at
    each of PACK_BATCHES with the service's prepared weights, as the model
    runs them: outputs held against each other, the peak of device memory
    of each form, then the host-clock time per call (dispatch included;
    the forward is bound by the host), measured in turns per-level, packed,
    packed, per-level.  The packed path runs whatever the rule chooses, so
    the grouped kernels are launched and held."""
    cfg = svc.cfg
    graphs = [svc.params["levels"][lv]["graph"] for lv in cfg.levels]
    stack = svc.params["graph_stack"]
    g = torch.Generator(device=DEV).manual_seed(1)
    hw = cfg.vf_h
    rows = []
    for b in PACK_BATCHES:
        def unit(*shape, dtype=torch.float32):
            v = torch.randn(*shape, generator=g, device=DEV)
            return (v * torch.rsqrt((v * v).sum(-1, keepdim=True))).to(dtype)

        vis = [unit(b, hw, hw, C, dtype=torch.bfloat16) for _ in cfg.levels]
        words = unit(b, 1, T, cfg.rnn_size)
        parse = torch.softmax(torch.randn(b, 1, T, 4, generator=g,
                                          device=DEV), -1)
        lens = torch.randint(3, T + 1, (b,), generator=g, device=DEV)
        mask = (torch.arange(T, device=DEV)[None] < lens[:, None]).float(
            )[:, None, :, None]

        def packed():
            with torch.inference_mode():
                return cmpc.apply_spa_graph_grouped(graphs, cfg, vis, words,
                                                    parse, mask, stack=stack)

        def per_level():
            with torch.inference_mode():
                outs = [cmpc.apply_spa_graph(p, cfg, v, words, parse, mask,
                                             stack=cmpc.level_of(stack, i))
                        for i, (p, v) in enumerate(zip(graphs, vis))]
            return [o[0] for o in outs], [o[1] for o in outs]

        (pk_out, pk_gw), (pl_out, pl_gw) = packed(), per_level()
        for lv, a, r, ga, gr in zip(cfg.levels, pk_out, pl_out, pk_gw, pl_gw):
            compare(torch, a, r, 1e-2, f"packed vs per-level graph {lv} b={b}")
            for x, y in zip(ga, gr):
                compare(torch, x, y, 1e-2, f"packed vs per-level gw {lv}")
        del pk_out, pk_gw, pl_out, pl_gw
        mem = {"per_level_peak_gb": peak_gb(torch, per_level),
               "packed_peak_gb": peak_gb(torch, packed)}
        t = [wall_ms(torch, fn) for fn in (per_level, packed, packed,
                                           per_level)]
        row = {"batch": b, "per_level_ms": (t[0] + t[3]) / 2,
               "packed_ms": (t[1] + t[2]) / 2, "runs_ms": t, **mem,
               "rule_packs": cmpc.pack_levels(b, len(cfg.levels))}
        rows.append(row)
        log(f"[serving] {card}: spatial graph b={b}: per-level "
            f"{row['per_level_ms']:.3f} ms, packed {row['packed_ms']:.3f} ms "
            f"per call (host clock, runs {[round(v, 3) for v in t]}); peak "
            f"memory per-level {mem['per_level_peak_gb']:.3f} GB, packed "
            f"{mem['packed_peak_gb']:.3f} GB; the rule packs: "
            f"{row['rule_packs']}")
        del vis, words, parse, mask
        torch.cuda.empty_cache()
    return rows


def run_serving(torch, np, kernels, cmpc, build_service, apply_model, card):
    """Phase 5: the batch-1 serving path through PredictService.predict."""
    svc = build_service("CMPC_model", dtype="bfloat16", device=DEV)
    cfg = svc.cfg
    if (cfg.H, cfg.res4_blocks, cfg.batch_size, cfg.v_emb_dim) != \
            (H_IMG, RES4, 1, C):
        fail(f"unexpected serving config {cfg}")
    requests = request_set(np, cfg.vocab_size)
    svc.warmup()
    svc.predict(*requests[0])                 # warm-up request
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    latency, results = [], []
    for img, expr in requests:
        t0 = time.perf_counter()
        results.append(svc.predict(img, expr))
        latency.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    check_counts(counts, expected_launches(cmpc, 1), N_REQ, "serving")

    # the stages of the same requests: host preprocessing, the forward
    # (ending in the copy of sigm to the host), host postprocessing
    stages = {"pre": [], "forward": [], "post": []}
    for img, expr in requests:
        t0 = time.perf_counter()
        feed = svc.preprocess(img, expr)
        t1 = time.perf_counter()
        sigm = svc.forward(feed)
        t2 = time.perf_counter()
        svc.postprocess(sigm, img.shape[:2])
        t3 = time.perf_counter()
        for k, a, b in (("pre", t0, t1), ("forward", t1, t2),
                        ("post", t2, t3)):
            stages[k].append((b - a) * 1e3)

    # each answer against the plain route (the kernels' plain versions) on
    # the same feed, with the forward's sigm tolerance
    worst = 0.0
    for (img, expr), (prob, mask) in zip(requests, results):
        if prob.shape != img.shape[:2] or mask.shape != img.shape[:2] \
                or not np.isfinite(prob).all():
            fail(f"serving: prob {prob.shape} / mask {mask.shape} for an "
                 f"image of {img.shape[:2]}, or non-finite prob")
        with torch.inference_mode():
            ref = apply_model(svc.params, cfg, svc.preprocess(img, expr),
                              use_kernels=False).sigm
        ref_prob, _ = svc.postprocess(ref[0, :, :, 0].float().cpu().numpy(),
                                      img.shape[:2])
        worst = max(worst, float(np.abs(prob - ref_prob).max()))
    if not worst <= SIGM_TOL:
        fail(f"serving: prob of the kernels vs the plain route differs by "
             f"{worst:.3e} > {SIGM_TOL}")

    def pct(v, q):
        return float(np.percentile(v, q))

    summary = {"requests": N_REQ, "median_ms": pct(latency, 50),
               "p90_ms": pct(latency, 90),
               **{f"{k}_median_ms": pct(v, 50) for k, v in stages.items()},
               "prob_vs_plain_max_abs": worst}
    log(f"[serving] {card}: CMPC_model 320x320 bf16 res4_blocks=23 batch 1: "
        f"{N_REQ} requests, latency median {summary['median_ms']:.3f} ms, "
        f"p90 {summary['p90_ms']:.3f} ms (after a warm-up; all "
        f"{[round(v, 3) for v in latency]}); stages median: pre "
        f"{summary['pre_median_ms']:.3f}, forward "
        f"{summary['forward_median_ms']:.3f}, post "
        f"{summary['post_median_ms']:.3f} ms; prob vs plain route max abs "
        f"{worst:.3e} <= {SIGM_TOL}")
    log(f"[serving] launches per request: "
        f"{ {k: v / N_REQ for k, v in counts.items()} }")
    summary["packing"] = time_packing(torch, cmpc, svc, card)
    return {"serving_bs1": (counts, N_REQ, summary["forward_median_ms"])}, \
        summary


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")
    from cmpc_refseg_torch.api import build_model, build_service
    from cmpc_refseg_torch.models import cmpc
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

    if cmpc.pack_levels(B_LARGE, G) or not cmpc.pack_levels(B, G):
        fail(f"the packing rule no longer packs bs={B} and not bs={B_LARGE}:"
             " phase 3's paths need new batches")
    records = check_kernels(torch, kernels, cmpc, torch.device(DEV))
    # path -> (launch counts of its runs, runs, ms per run)
    paths = run_forward(torch, kernels, cmpc, build_model, apply_model, card)
    srv_paths, serving = run_serving(torch, np, kernels, cmpc, build_service,
                                     apply_model, card)
    paths.update(srv_paths)
    for rec in records:
        counts, runs, _ = paths[rec["path"]]
        rec["launches"], rec["runs"] = counts[rec["kernel"]], runs
        if not rec["launches"]:
            fail(f"{rec['name']}: no launch on its path")
    unheld = {k for counts, _, _ in paths.values() for k, n in counts.items()
              if n} - {r["kernel"] for r in records if r["launches"]}
    if unheld:
        fail(f"launched on a path but not held in phase 3: {sorted(unheld)}")
    for path, (_, runs, run_ms) in paths.items():
        share = sum(r["ms"] * r["launches"] / runs for r in records
                    if r["path"] == path) / run_ms
        log(f"[{path}] the kernels take {share:.1%} of the {run_ms:.3f} ms "
            "run (kernel ms at this path's shapes x launches per run)")
    log(f"[serving] {json.dumps(serving)}")
    print(json.dumps({"kernels": records}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
