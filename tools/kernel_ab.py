#!/usr/bin/env python3
"""Phase 3's kernel records of chip_smoke.py at chosen paths, from one
checkout of the repository.

Imports chip_smoke.py and the port from --repo (this checkout by default),
builds that checkout's kernels, runs its `check_kernels` on the
`path_specs` named by --paths (each kernel against its plain version, CUDA
event times of the kernel and the plain version, the bound) and prints
one JSON line: {"repo", "card", "records": [{name, form, ms, plain_ms,
bound_ms, max_norm_err}, ...]}.  To compare two commits on one card,
unpack the other with `git archive` into a directory that .gitignore
lists and run the tool on both in turns in one call (A, B, B, A).

    python3 tools/kernel_ab.py [--repo DIR] [--paths serving_bs1,train_bs8]

Needs a CUDA GPU and nvcc.
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--paths", default="serving_bs1,forward_bs8,train_bs8")
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
