#!/usr/bin/env python3
"""Phase 3's kernel records of chip_smoke.py at chosen paths, from one
checkout of the repository.

Imports chip_smoke.py and the port from --repo (this checkout by default),
builds that checkout's kernels, runs its `check_kernels` on the
`path_specs` named by --paths (each kernel against its plain version, CUDA
event times of the kernel and the plain version, the bound) and prints
one JSON line: {"repo", "card", "records": [{name, form, ms, plain_ms,
bound_ms, max_norm_err}, ...]}.  With --edges NAME it times instead the
wide edge records of wrapper NAME that the checkout's
`chip_smoke.wide_edge_inputs` lists ({name, shapes, wide, ms, plain_ms,
bound_ms, max_norm_err}; the bound counts each input and output byte once
and, for graph_msg, its product at the bf16 peak).  To compare two commits
on one card, unpack the other with `git archive` into a directory that
.gitignore lists and run the tool on both in turns in one call (A, B, B,
A).

    python3 tools/kernel_ab.py [--repo DIR] [--paths serving_bs1,train_bs8]
    python3 tools/kernel_ab.py [--repo DIR] --edges graph_msg

Needs a CUDA GPU and nvcc.
"""

import argparse
import json
import os
import sys


def edge_records(torch, chip_smoke, kernels, name):
    """The wide edge records of wrapper `name`, timed (CUDA events) beside
    the plain version, with each one's largest error over the plain
    version's largest entry (statistics summed over their slots)."""
    wrapper = getattr(kernels, name)
    records = []
    for rec_name, tag, args, kw in chip_smoke.wide_edge_inputs(
            torch, kernels, torch.device("cuda")):
        if rec_name != name or not tag.startswith(":wide"):
            continue
        wide = wrapper.wide_launches
        got = wrapper(*args, **kw)
        want = kernels.PLAIN[wrapper](*args, **kw)
        torch.cuda.synchronize()
        outs = list(zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)))
        err = max(((a.float().sum(1) - b.float().sum(1)).abs().max()
                   / b.float().sum(1).abs().max()).item()
                  if a.shape != b.shape else
                  ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item() for a, b in outs)
        nbytes = sum(t.numel() * t.element_size() for t in args
                     if hasattr(t, "numel")) + sum(
            a.numel() * a.element_size() for a, _ in outs)
        flops = 2 * args[0].numel() * args[1].shape[-1] \
            if name == "graph_msg" else 0
        bound_ms, by = chip_smoke.bound(flops, 0, nbytes)
        records.append({
            "name": f"{name}@edge{tag}",
            "shapes": [list(t.shape) for t in args if hasattr(t, "shape")],
            "wide": wrapper.wide_launches > wide,
            "ms": chip_smoke.gpu_ms(torch, lambda: wrapper(*args, **kw)),
            "plain_ms": chip_smoke.gpu_ms(
                torch, lambda: kernels.PLAIN[wrapper](*args, **kw)),
            "bound_ms": bound_ms, "bound_by": by, "max_norm_err": err})
    return records


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--paths", default="serving_bs1,forward_bs8,train_bs8")
    ap.add_argument("--edges", metavar="NAME",
                    help="time the wide edge records of this wrapper")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    import chip_smoke
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models import cmpc
    from cmpc_refseg_torch.ops import build, kernels

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA GPU")
    for mod in (chip_smoke, build):
        if not os.path.abspath(mod.__file__).startswith(repo + os.sep):
            sys.exit(f"kernel_ab: {mod.__name__} imported from "
                     f"{mod.__file__}, not from {repo}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    if args.edges:
        print(json.dumps({"repo": repo, "card": chip_smoke.card_line(),
                          "edges": edge_records(torch, chip_smoke, kernels,
                                                args.edges)}), flush=True)
        return
    specs = chip_smoke.path_specs(get_config)
    records = chip_smoke.check_kernels(
        torch, kernels, cmpc, torch.device("cuda"),
        {p: specs[p] for p in args.paths.split(",")})
    keep = ("name", "form", "ms", "plain_ms", "bound_ms", "max_norm_err")
    print(json.dumps({"repo": repo, "card": chip_smoke.card_line(),
                      "records": [{k: r.get(k) for k in keep}
                                  for r in records]}), flush=True)


if __name__ == "__main__":
    main()
