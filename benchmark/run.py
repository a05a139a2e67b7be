#!/usr/bin/env python3
"""The benchmark of cmpc_refseg_torch on one NVIDIA H100: one run of one
cell of BENCHMARK.json.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  It loads the cell's configuration and
traffic by name, makes the weights and inputs on the device from the seed,
warms up the cell's shapes, drives the cell's entry for S seconds, then
checks the outputs against the plain reference.  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
`device`, with --trace 1 `breakdown`, and last `check`, each number compared
beside its limit (also the last lines of standard error).  Without a CUDA
device, with fewer devices than the cell asks for, or with JAX loaded in
the process, it exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

# never loaded by a run: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "cmpc_refseg_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_lines(torch):
    lines = [f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"python {sys.version.split()[0]}"]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi failed: {exc}"
    return lines + [f"card: {smi}"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}; cells: {sorted(cells)}")
        return 2

    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    import cell
    device = torch.device("cuda", 0)
    for line in card_lines(torch):
        log(line)
    out = cell.run_cell(manifest, args.workload, args.seed, args.seconds,
                        bool(args.trace), device, T_PROCESS, root=ROOT,
                        log=log)
    bad = forbidden_modules()
    if bad:
        log(f"the process loaded {bad}: a run may not load JAX or the JAX "
            "package")
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": dev}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, v, lim in out["check"]}
    for k, v, lim in out["check"]:
        log(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
