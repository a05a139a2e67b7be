"""A configuration names its own plain reference.

Every cell resolves to the flagship's entry (benchmark/reference/
flagship.py), which has every name of the contract.  A configuration and
a reference, both new files, drive a whole CPU run of a cell, infer and
train, with no file of the harness edited.  A configuration that its
reference does not follow fails at set-up, before the program is built.
And the four cells' numbers are those of the harness before a
configuration named its reference (it imported `reference.model` by
name): FLOPs a sample at published widths, the kernels' widths, and the
TINY readings at one seed, to the last digit.
"""

import itertools
import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from conftest import BENCH, ROOT, manifest, tiny

CELLS = [w["name"] for w in manifest()["workloads"]]
CONTRACT = ("Ops", "tf32_off", "check_supported", "forward",
            "forward_frozen_backbone", "loss", "poly_lr", "make_params",
            "meta_params", "head_of")

# the harness's numbers before a configuration named its reference
FLOPS = {"cmpc-infer-bs32": 266339742400.0,
         "cmpc-train-bs32": 511186126400.0,
         "video-infer-8clips": 1121108176000.0,
         "video-train-16clips": 1924338480000.0}
WIDTHS = {"n": 1600, "c": 1000, "a": 1000, "k": 1008, "cm": 500, "t": 20,
          "heads": 5, "levels": 3}
SPECS = {"cmpc-infer-bs32": {"batch": 32, "frames": 1, **WIDTHS},
         "cmpc-train-bs32": {"batch": 32, "frames": 1, **WIDTHS},
         "video-infer-8clips": {"batch": 8, "frames": 5, **WIDTHS},
         "video-train-16clips": {"batch": 16, "frames": 5, **WIDTHS}}
# at TINY widths, batch 2, one CPU thread, a window of 4 calls
SEED = 2**31 + 29
READINGS = {"cmpc-infer-bs32": {"sigm_err_scaled": 7.955284367355734e-05},
            "cmpc-train-bs32": {"loss_gap": 2.651770786236779e-07,
                                "grad_diff_median": 5.255008938573636e-07,
                                "change_gap": 8.75165209312388e-07}}
MIXES = sorted(READINGS)

STUB = '''"""A reference that delegates to the flagship's and writes the
name of each call to a file beside it."""
from pathlib import Path

from reference import flagship

CALLS = Path(__file__).with_suffix(".calls")
REFUSE = {refuse!r}


def _note(name):
    with open(CALLS, "a") as f:
        f.write(name + "\\n")


def _counted(name):
    fn = getattr(flagship, name)

    def call(*args, **kw):
        _note(name)
        return fn(*args, **kw)
    return call


for _name in {names!r}:
    globals()[_name] = _counted(_name)


def check_supported(model):
    _note("check_supported")
    if REFUSE:
        raise ValueError(REFUSE)
    flagship.check_supported(model)
'''


@pytest.fixture
def steady(monkeypatch):
    """One CPU thread and a clock of 0.125 s a reading, so that a window
    of 1 s makes 4 calls: the readings do not depend on the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    import cell
    clock = itertools.count(0.0, 0.125)
    monkeypatch.setattr(cell.time, "perf_counter", lambda: next(clock))
    yield
    torch.set_num_threads(threads)


def run(workload, bench=None):
    import cell
    res = tiny(workload, batch=2, bench=bench)
    out = cell.run_cell(None, workload, SEED, 1.0, False, torch.device("cpu"),
                        0.0, root=None, resolved=res, log=lambda m: None)
    return out, res


def calls(tmp_path):
    """{name: count} of the stub's calls."""
    path = tmp_path / "stub_reference.calls"
    return Counter(path.read_text().split()) if path.exists() else Counter()


def named(tmp_path, workload, refuse=""):
    """A copy of BENCHMARK.json whose configuration of `workload` is a copy
    of its file in `tmp_path` that adds only a 'reference' key, naming a
    stub reference there."""
    m = manifest()
    name = next(w["config"] for w in m["workloads"] if w["name"] == workload)
    entry = next(c for c in m["configs"] if c["name"] == name)
    stub = tmp_path / "stub_reference.py"
    stub.write_text(STUB.format(refuse=refuse, names=[
        n for n in CONTRACT if n != "check_supported"]))
    conf = json.loads((ROOT / entry["file"]).read_text())
    conf["reference"] = str(stub)
    copy = tmp_path / Path(entry["file"]).name
    copy.write_text(json.dumps(conf, indent=1))
    entry["file"] = str(copy)
    return m


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_the_flagship_entry(workload):
    import cell
    _, conf, *_ = cell.resolve(manifest(), workload, ROOT)
    assert "reference" not in conf
    ref = cell.reference_of(conf)
    assert Path(ref.__file__) == BENCH / "reference" / "flagship.py"
    for name in CONTRACT:
        assert callable(getattr(ref, name)), name


@pytest.mark.parametrize("workload", MIXES)
def test_tiny_readings_did_not_move(workload, steady):
    out, _ = run(workload)
    assert out["correct"] and out["attempted"] == 4
    assert {k: v for k, v, _ in out["check"]} == READINGS[workload]


@pytest.mark.parametrize("workload", MIXES)
def test_a_new_configuration_and_reference_drive_a_run(workload, steady,
                                                       tmp_path):
    import cell
    out, res = run(workload, named(tmp_path, workload))
    seen = calls(tmp_path)
    assert out["correct"], out["check"]
    # the stub delegates to the flagship: the same numbers
    assert {k: v for k, v, _ in out["check"]} == READINGS[workload]
    called = {"check_supported", "make_params", "Ops", "tf32_off"} | (
        {"forward"} if res[2]["mode"] == "infer" else
        {"forward_frozen_backbone", "loss", "poly_lr", "head_of"})
    assert called <= set(seen), seen
    assert seen["check_supported"] == 1
    ref = cell.reference_of(res[1])
    assert Path(ref.__file__) == tmp_path / "stub_reference.py"


def set_up_of(entry):
    """A call that sets a cell up from `resolve`'s tuple: a run, or
    calibrate.py's readings of the program or of the control."""
    import calibrate
    import cell
    cpu = torch.device("cpu")
    if entry == "run_cell":
        return lambda res: cell.run_cell(
            None, res[0]["name"], SEED, 1.0, False, cpu, 0.0, root=None,
            resolved=res, log=lambda m: None)
    return lambda res: getattr(calibrate, entry)(res, SEED, cpu)


@pytest.mark.parametrize("entry", ["run_cell", "program_readings",
                                   "control_readings"])
@pytest.mark.parametrize("by", ["stub", "flagship"])
def test_a_configuration_its_reference_refuses_fails_at_set_up(
        by, entry, tmp_path, monkeypatch):
    import cell
    import generate

    def built(*args):
        raise AssertionError("the program or the pool was made")
    monkeypatch.setattr(cell, "make_program", built)
    monkeypatch.setattr(generate, "make_pool", built)
    workload = "cmpc-infer-bs32"
    if by == "stub":
        message = "the reference does not follow decoder = 'aspp'"
        res = tiny(workload, batch=2, bench=named(tmp_path, workload,
                                                  refuse=message))
    else:
        res = tiny(workload, batch=2)
        res[1]["model"]["decoder"] = "aspp"
    with pytest.raises(ValueError, match="does not follow decoder = 'aspp'"):
        set_up_of(entry)(res)
    assert calls(tmp_path) == (Counter(check_supported=1) if by == "stub"
                               else Counter())


@pytest.mark.parametrize("workload", CELLS)
def test_flops_per_sample_did_not_move(workload):
    import cell
    _, conf, mix, *_ = cell.resolve(manifest(), workload, ROOT)
    ref = cell.reference_of(conf)
    assert cell.flops_per_sample(ref, conf["model"], mix) == FLOPS[workload]


@pytest.mark.parametrize("workload", CELLS)
def test_kernel_widths_did_not_move(workload):
    import cell
    _, conf, mix, *_ = cell.resolve(manifest(), workload, ROOT)
    assert cell.cost_spec(conf["model"], mix) == SPECS[workload]
