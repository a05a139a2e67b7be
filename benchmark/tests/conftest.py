"""The benchmark's own tests: the harness's modules import flat from
benchmark/, the program from the repository's root.

    python -m pytest benchmark/tests -q          # CPU; `gpu` tests skip
    python -m pytest benchmark/tests -q -m gpu   # on the card
"""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the model's widths shrunk for a CPU test run; every other dimension is
# the configuration's own
TINY = {"H": 32, "W": 32, "num_steps": 6, "vocab_size": 30, "glove_dim": 8,
        "rnn_size": 16, "v_emb_dim": 16, "mlp_dim": 12, "res4_blocks": 2}


def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def tiny(workload, batch=4, dtype="float32", *, bench=None, **mix):
    """`cell.resolve`'s tuple for `workload` of BENCHMARK.json (or of the
    manifest `bench`) at TINY widths, `batch` samples a call and a pool
    of 4, the program in `dtype`."""
    import cell
    c, conf, m, limits, e2e, pl = cell.resolve(bench or manifest(), workload,
                                               ROOT)
    conf = copy.deepcopy(conf)
    conf["overrides"] = {**TINY, "compute_dtype": dtype}
    conf["model"].update(TINY, compute_dtype=dtype)
    m = {**m, "batch": batch, "pool": 4, "ref_block": 2, "trace_calls": 2,
         **mix}
    return c, conf, m, limits, e2e, pl


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
