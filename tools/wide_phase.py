#!/usr/bin/env python3
"""The wide forms' records and chip_smoke.py's phase 17 alone, on the card.

Builds the kernels, prints ptxas's report for the wide forms' kernels,
then runs chip_smoke.py's `check_edges` (every edge record, the wide ones
among them), phase 3's `check_kernels` at the `wide_bs2`,
`wide_train_bs2` and `serving_bs1` paths and `run_wide_phase` (phase 17:
the flagship at v_emb_dim 4104 and mlp_dim 1032, bs=2), each fatal on
failure as in chip_smoke.py, and prints the records with their launches
in phase 17 and its summary as JSON lines.  About 90 s of command.

    python3 tools/wide_phase.py

Needs a CUDA GPU and nvcc.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cmpc_refseg_torch import api  # noqa: E402
from cmpc_refseg_torch.config import get_config  # noqa: E402
from cmpc_refseg_torch.models import cmpc  # noqa: E402
from cmpc_refseg_torch.models.model import apply_model  # noqa: E402
from cmpc_refseg_torch.ops import build, kernels  # noqa: E402
from cmpc_refseg_torch.train.optimizer import named_leaves  # noqa: E402
from cmpc_refseg_torch.train.trainer import compute_gradients  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("wide_phase: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    print("[build]", build.build_all(), card, flush=True)
    for name in build.SOURCES:
        rep = [r for r in cs.ptxas_report(build.build_log(name))
               if "wide" in r["kernel"]]
        print("[ptxas]", name, json.dumps(rep), flush=True)
    dev = torch.device("cuda")
    cs.check_edges(torch, kernels, cmpc, dev)
    print("[edges]", round(time.perf_counter() - t0, 1), flush=True)
    specs = cs.path_specs(get_config)
    pick = {k: specs[k] for k in ("wide_bs2", "wide_train_bs2",
                                  "serving_bs1")}
    records = cs.check_kernels(torch, kernels, cmpc, dev, pick)
    print("[phase3]", round(time.perf_counter() - t0, 1), flush=True)
    kernels.reset_launch_counts()
    paths, summary = cs.run_wide_phase(
        torch, kernels, cmpc, api.build_model, api.build_trainer,
        apply_model, compute_gradients, named_leaves, card)
    for rec in records:
        if rec["path"] in paths:
            rec["launches"] = paths[rec["path"]][0][rec["kernel"]]
    print("[records]", json.dumps(records), flush=True)
    print("[widened]", json.dumps(summary), flush=True)
    print("[total]", round(time.perf_counter() - t0, 1), flush=True)


if __name__ == "__main__":
    main()
