#!/usr/bin/env python3
"""The readings a cell's limits (benchmark/limits/<cell>.json) are set
from, on the card at the cell's own size, in one process: the program's on
a dozen seeds or more (through the window's own call: an infer cell's every
pool batch once after the warm-up, a train cell's first three steps), the
control's (the configuration's reference in fp8 put in the program's
place) and each planted fault's (`faults.py`) on three seeds or more.
Prints one JSON line per reading and a summary: each number's lower
reading (the largest the program gives) and upper ones (the smallest of
the control and of each fault).  A benchmark run never runs this.

    python3 benchmark/calibrate.py --workload NAME --seeds A,B,...
        [--control-seeds C,...] [--fault-seeds F,...] [--out FILE]
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def program_readings(res, seed, device, plant=None):
    import cell
    import program as prog
    from generate import make_pool
    _, conf, mix, *_ = res
    model = conf["model"]
    ref = cell.reference_of(conf)
    cfg = prog.port_config(conf, mix)
    pool = make_pool(model, mix, seed, device)
    program = cell.make_program(cfg, ref.make_params(model, seed, device),
                                mix, device)
    if plant is not None:
        program = plant(program)
    record = answers = None
    if mix["mode"] == "train":
        record = cell.train_warmup(program, pool, mix["warm_calls"])
    else:
        program(pool[0])
        answers = {i: program(batch) for i, batch in enumerate(pool)}
    program = None
    cell.free(device)
    return cell.readings_of(ref, model, mix, seed, pool, answers, record,
                            device)


def control_readings(res, seed, device):
    import cell
    import check
    from generate import make_pool
    _, conf, mix, *_ = res
    model = conf["model"]
    ref = cell.reference_of(conf)
    pool = make_pool(model, mix, seed, device)
    if mix["mode"] == "infer":
        def answer_of(slot, params, ops):
            return check.infer_reference(ref, model, pool[slot], params, ops,
                                         mix["ref_block"], device)
        return check.infer_readings(ref, model, mix, seed, pool,
                                    dict.fromkeys(range(len(pool))), device,
                                    precision="fp8", answer_of=answer_of)
    frames = len(model["sampled_frames"]) if model["video"] else 1
    kw = dict(block=mix["ref_block"] * frames)
    steps = mix["warm_calls"]
    losses, grad1, change = check.reference_steps(ref, model, pool, seed,
                                                  steps, device, "fp8", **kw)
    record = {"losses": losses, "grads": grad1,
              "grad_norms": {k: float(v.norm()) for k, v in grad1.items()},
              "change_norms": {k: float(v.norm()) for k, v in change.items()}}
    cell.free(device)
    reference = check.reference_steps(ref, model, pool, seed, steps, device,
                                      **kw)
    return check.train_readings(record, reference)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate: needs a CUDA device")
    import cell
    import faults
    device = torch.device("cuda", 0)
    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    res = cell.resolve(manifest, args.workload, ROOT)
    mode = res[2]["mode"]
    jobs = [("program", s, None) for s in args.seeds]
    jobs += [("control", s, None) for s in args.control_seeds]
    jobs += [(f"fault:{name}", s, faults.FAULTS[name])
             for name in faults.CELL_FAULTS[mode] for s in args.fault_seeds]
    rows = []
    for kind, seed, plant in jobs:
        t = time.perf_counter()
        if kind == "control":
            r = control_readings(res, seed, device)
        else:
            r = program_readings(res, seed, device, plant)
        row = {"kind": kind, "seed": seed, "readings": r,
               "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in [k for k, v in rows[0]["readings"].items()
                 if isinstance(v, float)]:
        by = {}
        for row in rows:
            by.setdefault(row["kind"], []).append(row["readings"][name])
        summary[name] = {"lower": max(by.get("program", [float("nan")])),
                         **{f"upper_{k}": min(v) for k, v in by.items()
                            if k != "program"}}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows,
                       "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
