"""The port's TF-checkpoint converter
(cmpc_refseg_torch/tools/convert_tf_checkpoint.py) against the JAX
package's (tools/convert_tf_checkpoint.py), on the CPU at the TINY
geometry of tests/test_converter.py, from that file's fabricated
checkpoint (`_ckpt_tensors`, `_write_ckpt`).

- The tensor route, every image config JAX's converter takes: the port's
  `convert_tensors` gives parameters and BN moving statistics bit-equal to
  `params_from_jax` / `model_state_from_jax` of JAX's `convert_backbone` +
  `convert_head` on JAX's skeleton (`init_model(PRNGKey(0))`), the leaves
  the checkpoint does not hold (CMPCv5_plus_model's detection head)
  included.  The configs run in threads (numpy's draws release the GIL).
- The video config: JAX's converter maps the checkpoint onto the image
  model's tree, which is not its video model's (`init_video_model`), so no
  video checkpoint comes out of it; the port's raises ValueError.
- The file route (CMPC_model, CMPCv4_model, CMPCv4_BiLSTM_T_model): the
  port's `convert` of a TF file, saved as step 0, is the checkpoint
  tools/tf_checkpoint_to_torch.py writes through JAX, tensor for tensor.
- `main`: the .npz has JAX's `main`'s keys and bit-equal arrays (both
  mains at TINY through their packages' `get_config`), and --ckpt_dir
  writes the file route's checkpoint.
- `reference_tensors`: the fixture's names, shapes and dtypes for every
  image config; converted, a finite forward at TINY.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from test_converter import TINY, TINY_BERT, _ckpt_tensors, _write_ckpt  # noqa: E402,I100
from cmpc_refseg_tpu import config as jconfig  # noqa: E402
from cmpc_refseg_tpu.models.model import init_model  # noqa: E402
from cmpc_refseg_tpu.models.video import init_video_model  # noqa: E402
from tools import convert_tf_checkpoint as jctc  # noqa: E402
from tools import tf_checkpoint_to_torch as bridge  # noqa: E402

from cmpc_refseg_torch import config as tconfig  # noqa: E402
from cmpc_refseg_torch.convert import (model_state_from_jax,  # noqa: E402
                                       params_from_jax, params_from_npz)
from cmpc_refseg_torch.models.model import apply_model  # noqa: E402
from cmpc_refseg_torch.tools import convert_tf_checkpoint as ctc  # noqa: E402
from cmpc_refseg_torch.train.checkpoint import FILE  # noqa: E402
from cmpc_refseg_torch.train.optimizer import named_leaves  # noqa: E402

IMAGE_CONFIGS = [n for n in jconfig.VARIANTS
                 if not jconfig.get_config(n).video]
VIDEO_CONFIGS = [n for n in jconfig.VARIANTS if jconfig.get_config(n).video]
FILE_CONFIGS = ("CMPC_model", "CMPCv4_model", "CMPCv4_BiLSTM_T_model")


def _tiny(name):
    return TINY_BERT if "BERT" in name else TINY


def _jax_convert(name, tensors, skeleton=None):
    """JAX's converter on `tensors`: its skeleton, `convert_backbone` and
    `convert_head`, as its `convert` runs them after reading the file.
    `skeleton`, a dict, gets the skeleton's leaves by path, as the port's
    tensors."""
    cfg = jconfig.get_config(name, **_tiny(name))
    params, state = init_model(jax.random.PRNGKey(0), cfg)
    if skeleton is not None:
        skeleton.update(named_leaves(params_from_jax(
            params, tconfig.get_config(name, **_tiny(name)), device="cpu")))
    get = tensors.__getitem__
    jctc.convert_backbone(None, get, params["backbone"])
    jctc.convert_head(get, params, cfg, state=state)
    return params, state


def _differ(got, want):
    """Paths where two trees of tensors differ (a missing or extra path,
    another dtype or shape, or any bit)."""
    a, b = dict(named_leaves(got)), dict(named_leaves(want))
    return sorted(set(a) ^ set(b)) + [
        p for p in a.keys() & b.keys()
        if a[p].dtype != b[p].dtype or not torch.equal(a[p], b[p])]


def _write_and_bridge(name, root):
    """`_write_ckpt` of config `name`'s fixture under `root`/tf, and
    tools/tf_checkpoint_to_torch.py's step 0 of it under `root`/jax;
    returns the checkpoint's prefix."""
    (root / "tf").mkdir(parents=True)
    ckpt = _write_ckpt(_ckpt_tensors(jconfig.get_config(name, **TINY)),
                       str(root / "tf" / "model.ckpt"))
    bridge.convert(ckpt, name, str(root / "jax"), TINY)
    return ckpt


def _compare(name):
    """The tensor route of config `name`: the port's trees against JAX's
    through the bridge, the leaves JAX's skeleton keeps, and the
    fabricator's names and shapes against the fixture's."""
    tcfg = tconfig.get_config(name, **_tiny(name))
    tensors = _ckpt_tensors(jconfig.get_config(name, **_tiny(name)))
    params, state = _jax_convert(name, tensors, skeleton := {})
    cfg, got, got_state = ctc.convert_tensors(tensors.__getitem__, name,
                                              _tiny(name), device="cpu")
    want = params_from_jax(params, tcfg, device="cpu")
    fab = ctc.reference_tensors(tcfg)
    return {"cfg": cfg, "params": _differ(got, want),
            "state": _differ(got_state, model_state_from_jax(
                state, device="cpu")),
            "kept": [p for p, v in named_leaves(got)
                     if torch.equal(v, skeleton[p])],
            "names": sorted(set(fab) ^ set(tensors)),
            "shapes": [k for k in fab.keys() & tensors.keys()
                       if (fab[k].shape, fab[k].dtype)
                       != (tensors[k].shape, tensors[k].dtype)],
            "finite": all(np.isfinite(v).all() for v in fab.values())}


@pytest.fixture(scope="module")
def routes():
    """Each image config's `_compare`, computed in three threads."""
    with ThreadPoolExecutor(3) as ex:
        yield {n: ex.submit(_compare, n) for n in IMAGE_CONFIGS}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """Futures of a TF checkpoint of each FILE_CONFIGS config (written by
    tests/test_converter.py's helpers) and of its step 0 through
    tools/tf_checkpoint_to_torch.py beside it, made in a thread of their
    own while the tensor routes run."""
    root = tmp_path_factory.mktemp("tf_ckpts")
    with ThreadPoolExecutor(1) as ex:
        yield {n: ex.submit(_write_and_bridge, n, root / n)
               for n in FILE_CONFIGS}


def test_video_config_raises(routes, ckpt_dir):
    """JAX's converter fills the image model's tree for the video config
    (its own video model's levels are other trees), so no video
    checkpoint comes out of it; the port's raises."""
    name = VIDEO_CONFIGS[0]
    jcfg = jconfig.get_config(name, **TINY)
    tensors = _ckpt_tensors(jcfg)
    params, _ = _jax_convert(name, tensors)
    video, _ = init_video_model(jax.random.PRNGKey(0), jcfg)
    assert set(params["levels"]["c3"]) != set(video["levels"]["c3"])
    with pytest.raises(ValueError, match="video"):
        ctc.convert_tensors(tensors.__getitem__, name, TINY, device="cpu")
    with pytest.raises(ValueError, match="video"):
        ctc.reference_tensors(tconfig.get_config(name, **TINY))


@pytest.mark.parametrize("name", FILE_CONFIGS)
def test_file_route_matches_the_jax_bridge(name, ckpt_dir, tmp_path):
    """`convert(ckpt)` saved as step 0 is the checkpoint
    tools/tf_checkpoint_to_torch.py writes through JAX's converter."""
    ckpt = ckpt_dir[name].result()
    cfg, params, state = ctc.convert(ckpt, name, TINY, device="cpu")
    ctc.save_train_state(str(tmp_path), cfg, params, state)
    got, want = (torch.load(Path(d) / "0" / FILE, map_location="cpu",
                            weights_only=True)
                 for d in (tmp_path, Path(ckpt).parent.parent / "jax"))
    assert got.keys() == want.keys()
    for key in got:
        if key == "config" or not isinstance(got[key], dict):
            assert got[key] == want[key], key
            continue
        assert got[key].keys() == want[key].keys(), key
        for k, v in got[key].items():
            w = want[key][k]
            assert v.dtype == w.dtype and torch.equal(v, w), (key, k)
    # the ASPP decoder's statistics are the file's moving ones
    if cfg.decoder == "aspp_v3plus":
        mean = ctc.checkpoint_getter(ckpt)(
            "text_objseg/aspp/conv_1x1/BatchNorm/moving_mean")
        np.testing.assert_array_equal(
            got["model_state"][("aspp", "conv_1x1", "mean")], mean)


def test_reference_tensors_convert_to_a_finite_model():
    """The fabricated checkpoint of the flagship and of CMPCv4_model (its
    live-BN decoder) converts into a model whose forward is finite."""
    rng = np.random.default_rng(0)
    for name in ("CMPC_model", "CMPCv4_model"):
        cfg = tconfig.get_config(name, **TINY)
        tensors = ctc.reference_tensors(cfg, seed=3)
        cfg, params, state = ctc.convert_tensors(tensors.__getitem__, name,
                                                 TINY, device="cpu")
        batch = {"im": torch.as_tensor(50 * rng.standard_normal(
                     (2, cfg.H, cfg.W, 3)), dtype=torch.float32),
                 "words": torch.as_tensor([[5, 6, 7, 0, 0, 0],
                                           [8, 9, 0, 0, 0, 0]]),
                 "seq_len": torch.as_tensor([3, 2])}
        out = apply_model(params, cfg, batch, model_state=state)
        assert torch.isfinite(out.up).all() and torch.isfinite(out.sigm).all()
        assert 0 < out.sigm.std() and out.sigm.std() < 0.5


@pytest.mark.parametrize("name", IMAGE_CONFIGS)
def test_tensor_route_matches_jax(name, routes):
    r = routes[name].result()
    assert not r["params"], r["params"][:5]
    assert not r["state"], r["state"][:5]
    # the checkpoint fills every leaf but the detection head's, which keeps
    # the value JAX's skeleton gives it
    want = [("bbox", "conv", "DW"), ("bbox", "conv", "biases")] \
        if r["cfg"].bbox_head else []
    assert r["kept"] == want


@pytest.mark.parametrize("name", IMAGE_CONFIGS)
def test_reference_tensors_match_the_fixture(name, routes):
    r = routes[name].result()
    assert not r["names"], r["names"][:5]
    assert not r["shapes"], r["shapes"][:5]
    assert r["finite"]


def test_main_writes_the_jax_npz(routes, ckpt_dir, tmp_path, monkeypatch):
    """Both mains on CMPC_model's TINY file (their packages' get_config
    giving TINY): the same keys, bit-equal arrays, which
    `params_from_npz` reads back; --ckpt_dir writes `convert`'s
    checkpoint."""
    for f in routes.values():     # the threads call get_config
        f.result()
    jget, tget = jconfig.get_config, tconfig.get_config
    monkeypatch.setattr(jconfig, "get_config",
                        lambda name, **kw: jget(name, **{**TINY, **kw}))
    monkeypatch.setattr(tconfig, "get_config",
                        lambda name, **kw: tget(name, **{**TINY, **kw}))
    ckpt = ckpt_dir["CMPC_model"].result()
    monkeypatch.setattr(sys, "argv", [
        "convert_tf_checkpoint.py", "--ckpt", ckpt, "--model", "CMPC_model",
        "--out", str(tmp_path / "jax.npz")])
    jctc.main()
    ctc.main(["--ckpt", ckpt, "--model", "CMPC_model",
              "--out", str(tmp_path / "port.npz"),
              "--ckpt_dir", str(tmp_path / "port_ckpt")])
    with np.load(tmp_path / "jax.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = tget("CMPC_model", **TINY)
    _, params, _ = ctc.convert(ckpt, "CMPC_model", TINY, device="cpu")
    assert not _differ(params_from_npz(tmp_path / "port.npz", cfg,
                                       device="cpu"), params)
    saved = torch.load(tmp_path / "port_ckpt" / "0" / FILE,
                       map_location="cpu", weights_only=True)
    trainable = dict(named_leaves(params))
    assert saved["trainable"].keys() <= trainable.keys()
    for path, v in saved["trainable"].items():
        assert torch.equal(v, trainable[path]), path
