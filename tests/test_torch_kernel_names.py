"""The kernel names chip_smoke.py attributes device time by against the
kernels the port's CUDA sources define.

chip_smoke.py sums a profiler trace's device time by kernel name: phase 7's
device split counts the names in PORT_KERNELS as the port's kernels, and
phase 17 the names in WIDE_KERNELS as the wide forms'.  A kernel renamed or
deleted in `cmpc_refseg_torch/csrc/` while its name stays in those tuples
(or a new kernel missing from them) silently drops out of that split.
These tests parse every `__global__` kernel in the sources and hold the
tuples to them.  chip_smoke.py's module level imports only numpy, so it
imports here without a card.
"""

import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "cmpc_refseg_torch" / "csrc"
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _skip_parens(text: str, i: int) -> int:
    """The index just past the balanced parenthesis group that starts at
    text[i] == '('."""
    depth = 0
    for j in range(i, len(text)):
        depth += {"(": 1, ")": -1}.get(text[j], 0)
        if depth == 0:
            return j + 1
    raise ValueError("unbalanced parentheses")


def kernel_names(text: str) -> list:
    """The names of the `__global__` functions defined in a CUDA source:
    the first identifier after `__global__ void` that is not an attribute
    such as `__launch_bounds__(...)` or `__cluster_dims__(...)`."""
    text = re.sub(r"//[^\n]*", "", text)
    names = []
    for m in re.finditer(r"\b__global__\s+void\b", text):
        i = m.end()
        while True:
            w = re.compile(r"\s*(\w+)\s*").match(text, i)
            if w is None:
                raise ValueError(f"no kernel name after {m.group(0)!r}")
            word, i = w.group(1), w.end()
            if not (word.startswith("__") and word.endswith("__")):
                names.append(word)
                break
            if i < len(text) and text[i] == "(":
                i = _skip_parens(text, i)
    return names


def defined_kernels() -> set:
    names = set()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        names.update(kernel_names(path.read_text()))
    return names


DEFINED = sorted(defined_kernels())


def test_parser_reads_attributes_and_templates():
    src = """
    // __global__ void commented_out_kernel(int x);
    template <int H, int V>
    __global__ void __launch_bounds__(32 * (kWarps + 1), 1)
    first_kernel(const float* x) {}
    __global__ void __cluster_dims__(2, 2, 1) __launch_bounds__(256, 1)
    second_kernel(int n) {}
    __global__ void third_kernel(int n) {}
    """
    assert kernel_names(src) == ["first_kernel", "second_kernel",
                                 "third_kernel"]


def test_sources_define_kernels():
    assert len(DEFINED) >= len(chip_smoke.WIDE_KERNELS)


@pytest.mark.parametrize("name", chip_smoke.PORT_KERNELS)
def test_listed_kernel_is_defined(name):
    """Every name PORT_KERNELS (WIDE_KERNELS among them) counts is a kernel
    of the sources."""
    assert name in DEFINED


@pytest.mark.parametrize("name", DEFINED)
def test_defined_kernel_is_listed(name):
    """Every kernel of the sources is counted among the port's kernels."""
    assert name in chip_smoke.PORT_KERNELS


@pytest.mark.parametrize("name", chip_smoke.WIDE_KERNELS)
def test_wide_kernel_is_a_port_kernel(name):
    assert name in chip_smoke.PORT_KERNELS
