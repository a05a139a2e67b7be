"""Import hygiene: a cell's set-up loads neither JAX nor the JAX package;
a plain reference (benchmark/reference/, and every file a configuration
names as its reference) imports only `reference.*`, torch, numpy and the
standard library, and loading it loads neither package, the program nor
another module of the harness; the harness reaches a reference only
through its configuration; and no file of the benchmark imports JAX, the
JAX package, chip_smoke.py or tools/.  Module names are compared by their
whole top-level name (the part before the first dot): the port's name
begins with the JAX package's."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, manifest

JAX = {"jax", "jaxlib", "flax", "cmpc_refseg_tpu"}


def imported(path):
    """The whole names of the modules `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    return names


def imported_tops(path):
    return {name.split(".")[0] for name in imported(path)}


def references():
    """benchmark/reference/*.py and every file that a configuration of
    BENCHMARK.json names as its reference."""
    import cell
    paths = set((BENCH / "reference").glob("*.py"))
    for c in manifest()["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        named = ROOT / conf.get("reference", cell.DEFAULT_REFERENCE)
        assert named.is_file(), (c["name"], named)
        paths.add(named.resolve())
    return sorted(paths)


def test_reference_imports_neither_package():
    for path in references():
        bad = imported_tops(path) & (JAX | {"cmpc_refseg_torch"})
        assert not bad, f"{path.name} imports {bad}"


# what a plain reference may import, by top-level name; a relative import
# has the top-level name ''
REFERENCE_MAY_IMPORT = set(sys.stdlib_module_names) | {"torch", "numpy",
                                                       "reference"}


def test_reference_imports_only_torch_numpy_and_the_standard_library():
    """No other module of the benchmark: `program`, `cell`, `check`, ...
    reach the program, and a helper outside reference/ might."""
    for path in references():
        bad = imported_tops(path) - REFERENCE_MAY_IMPORT
        assert not bad, f"{path} imports {bad}"


LOAD = """
import importlib.util, sys
from pathlib import Path
sys.path[:0] = [{bench!r}, {root!r}]
path = Path({path!r})
spec = importlib.util.spec_from_file_location("bench_" + path.stem, path)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_loading_a_reference_loads_no_program():
    """Each reference loaded alone, as `cell.load_module` loads it, with
    the program importable: neither package nor a harness module outside
    reference/ is in `sys.modules` after."""
    harness = {p.stem for p in BENCH.glob("*.py")}
    for path in references():
        out = subprocess.run(
            [sys.executable, "-c", LOAD.format(bench=str(BENCH),
                                               root=str(ROOT),
                                               path=str(path))],
            capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        loaded = set(eval(out.stdout.strip().splitlines()[-1]))
        bad = loaded & (JAX | {"cmpc_refseg_torch"} | harness)
        assert not bad, f"loading {path} loads {bad}"


def test_harness_names_no_reference_module():
    """The harness takes a configuration's reference from `cell.reference_of`;
    only generate.py imports `reference.model`, for the images' conversion
    (`image_of_u8`), which defines the inputs that both sides get."""
    for path in sorted(BENCH.rglob("*.py")):
        if path.parent.name in ("reference", "tests"):
            continue
        names = {n for n in imported(path)
                 if n == "reference" or n.startswith("reference.")}
        allowed = {"reference.model"} if path.name == "generate.py" else set()
        assert names <= allowed, f"{path.relative_to(ROOT)} imports {names}"


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
