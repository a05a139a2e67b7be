"""The control of each cell's check: the reference computed in fp8 (the
precision below the configurations' bf16) put in the program's place must
come out not correct.  On the CPU at TINY widths on three seeds; on the card
(`gpu`) at the cell's own size on three seeds, as its limits were set."""

import json

import pytest
import torch

from conftest import BENCH, ROOT, manifest, tiny

CELLS = [w["name"] for w in manifest()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def fails(readings, limits):
    import check
    return not check.judge(readings, limits)[0]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_tiny(workload):
    import calibrate
    res = tiny(workload, batch=2)
    for seed in SEEDS:
        r = calibrate.control_readings(res, seed, torch.device("cpu"))
        assert fails(r, res[3]), (seed, r)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(workload, cuda):
    import calibrate
    import cell
    res = cell.resolve(manifest(), workload, ROOT)
    for seed in SEEDS:
        r = calibrate.control_readings(res, seed, cuda)
        assert fails(r, res[3]), (seed, r)


def test_limits_sit_between_the_readings():
    """Each limit lies above the largest sound reading and below the
    smallest reading of the control (and, for a train cell, of a fault
    where that is its upper one), as benchmark/limits/<cell>.readings.json
    records them."""
    for w in CELLS:
        limits = json.loads((BENCH / "limits" / f"{w}.json").read_text())
        rec = json.loads((BENCH / "limits" / f"{w}.readings.json")
                         .read_text())
        for name, lim in limits.items():
            r = rec[name]
            assert r["lower"] < lim < r["upper"], (w, name, r, lim)
