"""The port's parity rehearsal (cmpc_refseg_torch/tools/parity_rehearsal.py)
against the JAX package's (tools/parity_rehearsal.py), on the CPU in
float32 at the TINY geometry.

- The JAX rehearsal runs whole in a spawned process
  (tests/torch_rehearsal_worker.py) while this one runs the port's.  Given
  the checkpoint JAX's fabricates (tests/test_converter.py's
  `_ckpt_tensors`), on the same fabricated layout, the port's printed
  table (without and with the DenseCRF) is JAX's within 1e-5.
- `--from-tensors` gives the file route's table; with TensorFlow hidden it
  runs, and the file route raises before any step, naming the option.
- Step 5 runs on the CUDA device unless the CPU is asked for: with no
  device given and no card, the evaluation raises.
"""

import multiprocessing as mp
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import pytest

tf = pytest.importorskip("tensorflow")

import torch_rehearsal_worker as worker  # noqa: E402,I100
from test_converter import _ckpt_tensors  # noqa: E402
from cmpc_refseg_tpu.config import get_config  # noqa: E402

from cmpc_refseg_torch.tools import parity_rehearsal as pr  # noqa: E402

IOU_TOL = 1e-5           # the printout's 5 decimals, as chip phase 11 holds


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The future of the JAX package's rehearsal, in a spawned process."""
    workdir = str(tmp_path_factory.mktemp("jax_rehearsal"))
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                             initializer=worker.init) as pool:
        yield pool.submit(worker.jax_rehearsal, workdir)


@pytest.fixture(scope="module")
def file_route(tmp_path_factory, jax_run):
    """The port's rehearsal through a TF file of its fabricated tensors."""
    return pr.run(str(tmp_path_factory.mktemp("file_route")), device="cpu")


def test_from_tensors_gives_the_file_route_table(file_route, tmp_path,
                                                 monkeypatch):
    assert os.path.isfile(os.path.join(os.path.dirname(file_route.ckpt_dir),
                                       "tf", "model.ckpt.index"))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    got = pr.run(str(tmp_path), from_tensors=True, device="cpu")
    assert got.table == file_route.table
    assert "tf_checkpoint" not in got.seconds


def test_without_tensorflow_the_file_route_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(RuntimeError, match="--from-tensors"):
        pr.run(str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)       # before any step


def test_evaluation_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    """No device given: steps 1-4 run on the host, and step 5 asks for the
    CUDA device, which this machine lacks."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.run(str(tmp_path), from_tensors=True)
    assert os.path.isdir(os.path.join(tmp_path, "converted_ckpt", "0"))


def test_rehearsal_matches_jax(jax_run, tmp_path):
    got = pr.run(str(tmp_path), device="cpu", tensors=_ckpt_tensors(
        get_config(pr.MODEL, **pr.TINY)))
    jax = jax_run.result()
    want = pr.parse_table(jax["report"])
    assert set(want) == {"no_crf", "crf"} and set(got.table) == set(want)
    for section, rows in want.items():
        assert got.table[section].keys() == rows.keys(), section
        for row, v in rows.items():
            assert abs(got.table[section][row] - v) <= IOU_TOL, \
                (section, row, got.table[section][row], v)
    # JAX's run returns the last section it parses: the CRF's
    assert jax["results"] == want["crf"]
    assert len(os.listdir(os.path.join(got.batches, "unc", "val_batch"))) \
        == len(pr.TINY_SIZES)
