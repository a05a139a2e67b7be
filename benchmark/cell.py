"""One run of one cell: set-up, the measured window, the traced sub-window
and the check, driven entirely by the cell's files.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(benchmark/configs/<file>) and a traffic mix (benchmark/traffic/<mix>.json);
its limits are benchmark/limits/<cell>.json, its per-layer metrics the
readers benchmark/metrics/<metric>.py (or <stem>.py for <stem>.<part>).
The configuration names its plain reference (`reference_of`; the contract
is in benchmark/reference/flagship.py, the one used where it names none).

Set-up: the configuration checked against what its reference follows, the
weights and the pool from the seed, the program built, every shape the
window uses warmed (a train cell's warm-up is the check's first three
steps, through the window's own call).  The window: a closed loop, one
call after another over the pool, for `seconds`; each call's time is taken
from its start to its answer on the host.  The traced run then profiles
`trace_calls` more calls.  After the window the program is freed and the
configuration's reference checks what the timed path produced.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import time
from pathlib import Path

import torch

import check
import devtrace
import generate
import peaks
import program as prog

BENCH = Path(__file__).resolve().parent
# the plain reference of a configuration that names none
DEFAULT_REFERENCE = "benchmark/reference/flagship.py"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(name: str, bench=BENCH) -> Path:
    """metrics/<name>.py, else metrics/<stem>.py for <stem>.<part>."""
    exact = bench / "metrics" / f"{name}.py"
    return exact if exact.exists() else \
        bench / "metrics" / f"{name.split('.')[0]}.py"


def resolve(manifest: dict, workload: str, root: Path):
    """(cell, configuration file, mix, limits, end-to-end metrics,
    per-layer metrics) of a workload, all found by name."""
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    conf_entry = next(c for c in manifest["configs"]
                      if c["name"] == cell["config"])
    conf = load_json(root / conf_entry["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m.get("workloads", [])]
    return cell, conf, mix, limits, e2e, per_layer


def reference_of(conf: dict):
    """The plain reference module that a configuration names with its
    'reference' key, else the flagship's, once it has checked the
    configuration's model (`check_supported`, which raises ValueError for
    one it does not follow).  The path is taken from the root of the
    checkout that holds this harness, the `root` that run.py and
    calibrate.py give `resolve`; an absolute path is taken as it is."""
    mod = load_module(BENCH.parent / conf.get("reference", DEFAULT_REFERENCE))
    mod.check_supported(conf["model"])
    return mod


def cost_spec(model: dict, mix: dict) -> dict:
    """The widths the kernels' cost functions take at this cell."""
    return {"batch": mix["batch"],
            "frames": len(model["sampled_frames"]) if model["video"] else 1,
            "n": (model["H"] // 8) * (model["W"] // 8),
            "c": model["v_emb_dim"], "a": model["v_emb_dim"],
            "k": -(-(model["v_emb_dim"] + 8) // 8) * 8,
            "cm": model["mlp_dim"], "t": model["num_steps"], "heads": 5,
            "levels": len(model["levels"])}


def flops_per_sample(ref, model: dict, mix: dict) -> float:
    """Model FLOPs a sample, counted by FlopCounterMode over the
    reference `ref`'s forward on the meta device (and for training the
    backward of the head's leaves: the backbone is frozen)."""
    from torch.utils.flop_counter import FlopCounterMode
    b, t = mix["batch"], model["num_steps"]
    params = ref.meta_params(model)
    img = (b, len(model["sampled_frames"])) if model["video"] else (b,)
    key = "frames" if model["video"] else "im"
    batch = {key: torch.empty(*img, model["H"], model["W"], 3, device="meta"),
             "words": torch.zeros(b, t, dtype=torch.long, device="meta"),
             "seq_len": torch.zeros(b, dtype=torch.long, device="meta"),
             "target": torch.empty(b, model["H"], model["W"], 1,
                                   device="meta")}
    train = mix["mode"] == "train"
    with FlopCounterMode(display=False) as counter:
        if train:
            head = ref.head_of(params)
            for _, leaf in check.leaf_items(head):
                leaf.requires_grad_()
            out = ref.forward_frozen_backbone(ref.Ops(), params, model, batch,
                                              block=None)
            ref.loss(out, batch["target"], model, head).backward()
        else:
            with torch.no_grad():
                ref.forward(ref.Ops(), params, model, batch)
    return counter.get_total_flops() / b


class Ctx:
    """What a per-layer reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def make_program(cfg, params, mix, device):
    cls = prog.TrainProgram if mix["mode"] == "train" else prog.InferProgram
    return cls(cfg, params, device)


def train_warmup(program, pool, steps):
    """The check's first `steps` train steps through the window's call, on
    pool batches 0..steps-1: {'losses', 'grads' (the first step's gradient
    from Adam's first moment, on the host) and their 'grad_norms',
    'change_norms' (after `steps`)}."""
    leaves = program.leaves()
    start = [t.detach().clone() for _, t in leaves]
    losses, grads = [], None
    for i in range(steps):
        losses.append(program(pool[i]))
        if grads is None:
            grads = {p: (program.first_moment(t) / (1 - check.BETA1)).cpu()
                     for p, t in leaves}
    change = {p: float((t.detach() - s).norm())
              for (p, t), s in zip(leaves, start)}
    return {"losses": losses, "grads": grads, "change_norms": change,
            "grad_norms": {p: float(g.norm()) for p, g in grads.items()}}


def closed_loop(call, pool, seconds, first, *, calls=None):
    """Calls one after another from pool slot `first` on, until `seconds`
    have passed (or `calls` calls are made).  Returns (t_start, t_end,
    latencies, {slot: last answer})."""
    lat, answers = [], {}
    i = first
    t0 = t_end = time.perf_counter()
    while (calls is None and t_end - t0 < seconds) or \
            (calls is not None and len(lat) < calls):
        slot = i % len(pool)
        t = time.perf_counter()
        answers[slot] = call(pool[slot])
        t_end = time.perf_counter()
        lat.append(t_end - t)
        i += 1
    return t0, t_end, lat, answers


def run_cell(manifest: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_process: float, *, root: Path,
             log=print, plant=None, resolved=None):
    """One run; returns what the result's line reports.  A test may pass
    `resolved` (`resolve`'s tuple, shrunk), and break the timed path
    underneath with `plant` (a function of the built program returning the
    program the window drives)."""
    _, conf, mix, limits, e2e, per_layer = resolved or resolve(
        manifest, workload, root)
    model = conf["model"]
    ref = reference_of(conf)
    train = mix["mode"] == "train"
    cfg = prog.port_config(conf, mix)
    params = ref.make_params(model, seed, device)
    pool = generate.make_pool(model, mix, seed, device)
    program = make_program(cfg, params, mix, device)
    del params
    if plant is not None:
        program = plant(program)
    warm = mix["warm_calls"]
    if train:
        record = train_warmup(program, pool, warm)
    else:
        for i in range(warm):
            program(pool[i])
    sync(device)
    setup_peak = peak_bytes(device)
    reset_peak(device)
    t_first = time.perf_counter()
    setup_s = t_first - t_process
    t0, t1, lat, answers = closed_loop(program, pool, seconds, warm)
    sync(device)
    window_peak = peak_bytes(device)
    n = len(lat)
    rate = n * mix["batch"] / (t1 - t0)
    log(f"window: {n} calls of {mix['batch']} samples in {t1 - t0:.6f} s "
        f"({rate:.6f} samples/s); set-up {setup_s:.6f} s; latency median "
        f"{statistics.median(lat) * 1e3:.6f} ms, max {max(lat) * 1e3:.6f} ms")
    wctx = Ctx(calls=n, batch=mix["batch"], seconds=t1 - t0, latencies=lat,
               setup_s=setup_s, peak_bytes=window_peak)
    out = {"attempted": n, "failed": 0, "breakdown": None,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        metrics, tr = traced(ref, program, pool, mix, model, per_layer,
                             rate, warm + n, device, log)
        out["metrics"] = metrics
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    else:
        out["metrics"] = read_metrics(e2e, wctx)
    program = None
    free(device)
    readings = readings_of(ref, model, mix, seed, pool, answers,
                           record if train else None, device)
    for k, v in readings.items():
        if isinstance(v, float):
            log(f"reading {k} {v!r}")
    out["correct"], out["check"] = check.judge(readings, limits)
    return out


def readings_of(ref, model, mix, seed, pool, answers, record, device):
    """The check's readings of the program's infer `answers` or train
    `record` against the reference `ref`."""
    if record is None:
        return check.infer_readings(ref, model, mix, seed, pool, answers,
                                    device)
    frames = len(model["sampled_frames"]) if model["video"] else 1
    reference = check.reference_steps(ref, model, pool, seed,
                                      mix["warm_calls"], device,
                                      block=mix["ref_block"] * frames)
    return check.train_readings(record, reference)


def traced(ref, program, pool, mix, model, per_layer, rate, first, device,
           log=print):
    """Profile `trace_calls` calls and read the per-layer metrics."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    before = prog.launch_counts()
    with profile(activities=acts) as p:
        closed_loop(program, pool, 0, first, calls=mix["trace_calls"])
        sync(device)
    after = prog.launch_counts()
    tr = devtrace.from_profiler(p, mix["trace_calls"])
    ctx = Ctx(trace=tr, samples_per_s=rate, spec=cost_spec(model, mix),
              launches={k: after[k] - before[k] for k in after},
              flops_per_sample=flops_per_sample(ref, model, mix),
              peaks=peaks, bench=BENCH)
    log(f"flops_per_sample {ctx.flops_per_sample!r}; kernel widths "
        f"{json.dumps(ctx.spec, sort_keys=True)}")
    return read_metrics(per_layer, ctx), tr


def read_metrics(entries, ctx):
    """{name: {value, unit}} of each metric whose reader finds something
    to read in `ctx`."""
    metrics = {}
    for m in entries:
        value = load_module(reader_path(m["name"])).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
