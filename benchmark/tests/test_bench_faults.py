"""A run with its timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU at
TINY widths with each fault of `faults.py` that the cell can have planted
in the program; the unbroken run comes out correct."""

import pytest
import torch

from conftest import manifest, tiny

CELLS = [w["name"] for w in manifest()["workloads"]]


def run(workload, plant=None):
    import cell
    res = tiny(workload, batch=2)
    return cell.run_cell(None, workload, 2**31 + 17, 0.2, False,
                         torch.device("cpu"), 0.0, root=None, resolved=res,
                         log=lambda m: None, plant=plant)


def cases():
    import faults
    for w in CELLS:
        mode = tiny(w)[2]["mode"]
        yield w, None
        for name in faults.CELL_FAULTS[mode]:
            yield w, name


@pytest.mark.parametrize("workload,fault", list(cases()))
def test_fault_makes_the_run_incorrect(workload, fault):
    import faults
    out = run(workload, faults.FAULTS[fault] if fault else None)
    assert out["correct"] == (fault is None), out["check"]
