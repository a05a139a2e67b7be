"""The port's user tools against the JAX package's, in float32 on the CPU:

- `build_pool` of cmpc_refseg_torch/tools/convergence_proof.py is
  bit-equal to tools/convergence_proof.py's for the same seed and size;
- the port's convergence proof at --tiny, 2 steps, writes a JSON record
  with the JAX tool's keys (and runs on the CPU only when asked);
- `dump_sample` of cmpc_refseg_torch/tools/visualize.py on the port's
  TINY forward and tools/visualize.py's on JAX's, from the same weights
  and sample, write the same files; words_parse within 1e-5, the PNGs
  within 1 grey level (`colorize` floors p * 255, so a difference of
  float32 noise can cross a level);
- examples/quickstart_torch.py --device cpu runs and its loss falls.
"""

import json
import os
import runpy
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.models.model import apply_model as tapply
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.tools import convergence_proof as tcp
from cmpc_refseg_torch.tools import visualize as tvis
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import apply_model as japply
from cmpc_refseg_tpu.models.model import init_model as jinit

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import convergence_proof as jcp  # noqa: E402
from tools import visualize as jvis  # noqa: E402

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=1,
            res4_blocks=2)


@pytest.mark.parametrize("n,seed,size", [(6, 3, 64), (2, 0, 320)])
def test_build_pool_bit_equal(n, seed, size):
    got = tcp.build_pool(n, seed, size, size)
    want = jcp.build_pool(n, seed, size, size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert tcp.VOCAB == jcp.VOCAB and tcp.COLORS == jcp.COLORS


def test_convergence_proof_tiny_writes_jax_keys(tmp_path, monkeypatch):
    out = tmp_path / "conv.json"
    argv = ["--tiny", "--steps", "2", "--eval-every", "1", "--pool", "16",
            "--holdout", "8", "--out", str(out)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcp.main(argv)
    monkeypatch.undo()
    result = tcp.main(argv + ["--device", "cpu"])
    rec = json.loads(out.read_text())
    keys = {"metric", "value", "steps", "geometry", "curve",
            "wall_clock_s", "passed"}
    assert keys <= set(rec) and rec["metric"] == \
        "synthetic_grounding_holdout_iou"
    assert [c["step"] for c in rec["curve"]] == [1, 2]
    assert 0.0 <= rec["value"] <= 1.0 and rec["passed"] == (
        rec["value"] > 0.7)
    assert rec["geometry"] == "64x64 bs=8 float32"
    assert result["value"] == rec["value"]


def _sample():
    rng = np.random.default_rng(3)
    words = np.zeros((1, 6), np.int32)
    words[0, :4] = [3, 9, 4, 12]
    return {"im": (20 * rng.standard_normal((1, 32, 32, 3))).astype(
                np.float32),
            "words": words, "seq_len": np.array([4], np.int32),
            "im_native": rng.integers(0, 256, (45, 37, 3), np.uint8)}


def _jax_dump(out_dir, sample):
    cfg = jget("CMPC_model", **TINY)
    params, state = jinit(0, cfg)
    batch = {k: sample[k] for k in ("im", "words", "seq_len")}
    outputs = jax.jit(lambda p, s, b: japply(p, s, cfg, b)[0])(
        params, state, batch)
    jvis.dump_sample(out_dir, 0, sample, outputs,
                     tokens=sample["words"][0].tolist())


def test_dump_sample_matches_jax(tmp_path):
    """Both from seed 0 (the port's init draws JAX's weights bit for bit,
    tests/test_torch_model.py); JAX's side in a thread meanwhile."""
    sample = _sample()
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(_jax_dump, str(tmp_path / "jax"), sample)
        cfg = tget("CMPC_model", **TINY)
        params = tinit(0, cfg, device="cpu")
        with torch.inference_mode():
            outputs = tapply(params, cfg, {
                k: torch.from_numpy(sample[k]) for k in ("im", "words",
                                                         "seq_len")})
        tvis.dump_sample(str(tmp_path / "port"), 0, sample, outputs,
                         tokens=sample["words"][0].tolist())
        jax_side.result()
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert {"00000_sigm.png", "00000_overlay.png", "00000_parse.json",
            "00000_up_c3.png", "00000_gw_c5.png"} <= set(files)
    for name in files:
        a, b = (tmp_path / d / name for d in ("port", "jax"))
        if name.endswith(".json"):
            got, want = (json.loads(p.read_text()) for p in (a, b))
            assert got["tokens"] == want["tokens"]
            np.testing.assert_allclose(got["words_parse"],
                                       want["words_parse"], rtol=0,
                                       atol=1e-5)
            continue
        got, want = (np.asarray(Image.open(p), np.int16) for p in (a, b))
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1, name


def test_quickstart_torch_runs_on_cpu():
    ns = runpy.run_path(str(REPO / "examples" / "quickstart_torch.py"),
                        run_name="quickstart_torch")
    losses = ns["main"](["--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
