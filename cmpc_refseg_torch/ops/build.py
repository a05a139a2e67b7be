"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface under ``build/torch_kernels/`` beside the package.
The file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  All missing libraries are
compiled at once, one ``nvcc`` process each, started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("mutan", "mutan_bwd", "spa_affinity", "graph_conv", "se_sum",
           "convlstm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)   # a host array of device pointers
# C signatures: name -> (argtypes, restype)
SIGNATURES = {
    "mutan": {
        "cmpc_mutan_fused": ([_P] * 8 + [_I] * 5 + [_P], _I),
        "cmpc_mutan_col_tiles": ([_I], _I),
    },
    "mutan_bwd": {
        "cmpc_mutan_bwd_dz": ([_P] * 7 + [_I] * 4 + [_P], _I),
        "cmpc_mutan_dz_blocks": ([_I] * 3, _I),
        "cmpc_mutan_bwd_dz_wide": ([_P] * 7 + [_I] * 4 + [_P], _I),
        "cmpc_mutan_dz_wide_shares": ([_I] * 3, _I),
        "cmpc_mutan_dw": ([_P] * 4 + [_I] * 3 + [_P], _I),
        "cmpc_mutan_dw_splits": ([_I], _I),
    },
    "spa_affinity": {
        "cmpc_spa_affinity": ([_P] * 9 + [_I] * 6 + [_F, _I, _I, _P], _I),
        "cmpc_spa_affinity_row_blocks": ([_I, _I], _I),
        "cmpc_spa_affinity_wide": ([_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
                                   _I),
        "cmpc_spa_affinity_wide_row_blocks": ([_I], _I),
        "cmpc_spa_affinity_wide_scratch": ([_I] * 3, _L),
    },
    "graph_conv": {
        "cmpc_graph_msg": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "cmpc_graph_msg_parts": ([_I], _I),
        "cmpc_graph_msg_smem": ([_I, _I], _I),
        "cmpc_graph_update": ([_P] * 3 + [_I] + [_P] * 6 + [_I] * 5 + [_P], _I),
        "cmpc_graph_update_parts": ([_I, _I], _I),
        "cmpc_graph_msg_wide": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "cmpc_graph_update_wide": ([_P] * 3 + [_I] + [_P] * 6 + [_I] * 5
                                   + [_P], _I),
        "cmpc_graph_wide_parts": ([_I, _I], _I),
    },
    "se_sum": {
        "cmpc_se_sum": ([_P] + [_PP] * 4 + [_I, _P] + [_I] * 3 + [_P], _I),
        "cmpc_se_sum_wide": ([_P] + [_PP] * 4 + [_I, _P, _P] + [_I] * 3
                             + [_P], _I),
        "cmpc_se_sum_wide_scratch": ([_I, _I], _L),
    },
    "convlstm": {
        "cmpc_convlstm_gates": ([_P] * 8 + [_I] * 3 + [_P], _I),
        "cmpc_convlstm_gates_parts": ([_I, _I], _I),
        "cmpc_convlstm_raw": ([_P] * 4 + [_I] + [_P] * 5 + [_I] * 4 + [_P], _I),
        "cmpc_convlstm_raw_parts": ([_I] * 3, _I),
    },
}

_loaded: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                           "the port's kernels build on a machine with the "
                           "CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every library that is missing, in parallel; returns seconds."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")], stdout=log, stderr=subprocess.STDOUT),
            tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) for a library."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building all missing libraries first."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.cmpc_error_string.argtypes = [_I]
        lib.cmpc_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.cmpc_error_string(rc).decode()})")
