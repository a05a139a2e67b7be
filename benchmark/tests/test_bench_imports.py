"""Import hygiene: a cell's set-up loads neither JAX nor the JAX package,
the reference imports nothing of either package, and no file of the
benchmark imports JAX, the JAX package, chip_smoke.py or tools/.  Module
names are compared by their whole top-level name (the part before the
first dot): the port's name begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "cmpc_refseg_tpu"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_neither_package():
    for path in sorted((BENCH / "reference").glob("*.py")):
        bad = imported_tops(path) & (JAX | {"cmpc_refseg_torch"})
        assert not bad, f"{path.name} imports {bad}"


def test_no_benchmark_file_imports_jax_or_tools():
    for path in sorted(BENCH.rglob("*.py")):
        bad = imported_tops(path) & (JAX | {"chip_smoke", "tools"})
        if path.parent.name == "tests":
            bad -= {"chip_smoke"}     # the cost test compares with it
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


SETUP = """
import sys, torch
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import cell
from conftest import tiny
res = tiny({cell!r}, batch=2)
out = cell.run_cell(None, {cell!r}, 7, 0.2, False, torch.device('cpu'), 0.0,
                    root=None, resolved=res, log=lambda m: None)
assert out['correct'], out['check']
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("cell", ["cmpc-infer-bs32", "cmpc-train-bs32"])
def test_set_up_loads_no_jax(cell):
    code = SETUP.format(bench=str(BENCH), root=str(ROOT),
                        tests=str(BENCH / "tests"), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cmpc_refseg_torch" in loaded
    assert not loaded & JAX, loaded & JAX
