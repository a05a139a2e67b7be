"""The port's VOC pretraining pipeline (cmpc_refseg_torch/tools/
pretrain_backbone.py, voc.py, kaffe.py) against the JAX package's
tools/pretrain_backbone.py and tools/convert_tf_checkpoint.py, in float32
on the CPU, at res4_blocks 2, crop 64 and 4 classes on a fabricated VOC
list (tests/test_pretrain_backbone.py's `_fake_voc`).

- The host helpers are bit-equal for the same seed: the palette,
  `augment_pair` with scale, mirror and crop on (and the generator's state
  after it), `downsample_labels` with and without `out_size` (numpy and
  tensor), `pad_to_bucket`, `read_data_list`, `load_pair` of a grey-level
  mask (a palette PNG gives its indices, where JAX reads its colours'
  grey levels).  So is the kaffe ``.npy`` ingestion after layout, on
  test_pretrain_backbone.py's fabricator.
- `voc_logits` and `eval_forward` (msc off and on): within 1e-4 of the
  largest entry (float32 sums in other orders through the backbone);
  `voc_ce_loss` with labels 255 and >= num_classes within rtol 1e-5.
- One and two steps of SGD over the whole trainable set, head-only Adam and
  the multi-scale loss from the same weights and one-image batches
  (tests/torch_pretrain_worker.py::batches): losses within
  rtol 1e-5; weights by the step rule, on each leaf's error over its
  largest update |w_j - w_0| (plus 2^-23 of its largest |w_j|, the rounding
  of the addition).  The head's leaves within 1e-4, test_torch_train.py's
  gradient rule carried to the update.  A backbone gradient passes through
  the ReLUs of every block above it, and in float32 a ReLU input within
  rounding of 0 takes the other branch in one package at about half the
  draws of the weights; that moves a backbone leaf's update by up to
  1.6e-2 of its largest (measured over 6 draws of both SGD cases at crop
  64).  So backbone leaves are held within 5e-2 at every draw, and
  within 1e-3 at their best of 3 draws (the weights and 2 draws of them
  times (1 + 1e-3 N(0, 1))), which an error of the port fails at every
  draw.  Head-only Adam by test_torch_train.py's Adam rule (1e-3 lr where
  |g| >= 1e-6, 2 lr elsewhere).
- The command lines, at batch 2: 3 train steps from one --restore npz and
  seed in each package, snapshots with the same keys agreeing by the step
  rule's bounds for one run; a --start-step run without --restore-opt
  (the LR count starts at 0 in both); eval of either snapshot in either package prints the same mIoU,
  equal, because the argmax of logits that agree to 1e-4 is equal where
  no two classes tie closer than that; inference gives an equal
  prediction and PNG.
- Resume: 2 steps, a snapshot, then 1 step through --restore /
  --restore-opt is bit-equal to 3 unbroken steps (the port's opt file
  carries the data stream).

The step checks, the forwards and JAX's command lines run in four spawned
processes (tests/torch_pretrain_worker.py) while this one runs the port's
command lines; each returns only what is held here.
"""

import multiprocessing as mp
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pretrain_worker as worker
from test_pretrain_backbone import _fake_voc
from cmpc_refseg_torch.tools import kaffe as tkaffe
from cmpc_refseg_torch.tools import pretrain_backbone as tpb
from cmpc_refseg_torch.tools import voc as tvoc
from cmpc_refseg_torch.train.optimizer import named_leaves
from torch_pretrain_worker import COMMON, NC, SIZE

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import convert_tf_checkpoint as ctc  # noqa: E402
from tools import pretrain_backbone as pb  # noqa: E402

torch.set_num_threads(2)

HEAD_TOL = 1e-4        # test_torch_train.py's gradient rule
RELU_FLIP_TOL = 5e-2   # a ReLU input within rounding of 0 (module docstring)
DRAW_TOL = 1e-3        # the best draw of each backbone leaf


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _check_step_rule(errors, what):
    """The step rule on one run (module docstring): head leaves within
    HEAD_TOL, backbone leaves within RELU_FLIP_TOL."""
    for name, e in errors.items():
        tol = HEAD_TOL if name.startswith("['head']") else RELU_FLIP_TOL
        assert e <= tol, (what, name, e)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The fabricated list, the init npz, and the futures of four worker
    processes: JAX's command lines, each SGD case's steps, and the Adam
    steps with the forwards."""
    root = tmp_path_factory.mktemp("voc")
    data_dir, data_list = _fake_voc(root)
    init = str(root / "init.npz")
    np.savez(init, **{tpb.keystr(p): v
                      for p, v in named_leaves(worker.tree())})
    ws = {"root": root, "data_dir": data_dir, "data_list": data_list,
          "init": init, "image": os.path.join(data_dir, "im0.jpg")}
    with ProcessPoolExecutor(4, mp_context=mp.get_context("spawn"),
                             initializer=worker.init) as pool:
        ws["jax_cli"] = pool.submit(worker.jax_cli, data_dir, data_list,
                                    init, str(root), ws["image"])
        ws["steps"] = {c: pool.submit(worker.sgd_case, c, data_dir,
                                      data_list)
                       for c in ("sgd_all", "sgd_msc")}
        ws["adam_fwd"] = pool.submit(worker.adam_forwards, data_dir,
                                     data_list)
        yield ws


# ------------------------------------------------------------ host side ---

def test_colormap_equal():
    assert np.array_equal(tvoc.make_voc_colormap(), pb.make_voc_colormap())
    assert tvoc.IGNORE_LABEL == pb.IGNORE_LABEL
    assert np.array_equal(tvoc.IMG_MEAN, pb.IMG_MEAN)


@pytest.mark.parametrize("seed", range(4))
def test_augment_pair_bit_equal(seed):
    src = np.random.default_rng(100 + seed)
    h, w = src.integers(20, 90, 2)
    im = src.standard_normal((h, w, 3)).astype(np.float32) * 50
    lb = src.integers(0, 5, (h, w)).astype(np.uint8)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        a = tvoc.augment_pair(r1, im, lb, 48, 40)
        b = pb.augment_pair(r2, im, lb, 48, 40)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("out_size", [None, (5, 7)])
def test_downsample_labels_bit_equal(out_size):
    lb = np.random.default_rng(1).integers(0, 256, (2, 33, 41)).astype(
        np.int32)
    want = pb.downsample_labels(lb, out_size=out_size)
    assert np.array_equal(tvoc.downsample_labels(lb, out_size=out_size),
                          want)
    assert np.array_equal(tvoc.downsample_labels(lb[0], out_size=out_size),
                          want[0])
    got = tvoc.downsample_labels(torch.from_numpy(lb), out_size=out_size)
    assert np.array_equal(got.numpy(), want)


def test_pad_to_bucket_and_data_list_equal(tmp_path):
    src = np.random.default_rng(3)
    im = src.standard_normal((70, 130, 3)).astype(np.float32)
    lb = src.integers(0, 21, (70, 130)).astype(np.uint8)
    for got, want in ((tvoc.pad_to_bucket(im, lb), pb.pad_to_bucket(im, lb)),
                      (tvoc.pad_to_bucket(im), pb.pad_to_bucket(im))):
        for x, y in zip(got[:-1], want[:-1]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert got[-1] == want[-1] == (70, 130)
    lst = tmp_path / "l.txt"
    lst.write_text("/JPEG/a.jpg /Seg/a.png\n\nb.jpg c.png\n")
    assert tvoc.read_data_list("/d", str(lst)) == \
        pb.read_data_list("/d", str(lst))


def test_load_pair_reads_grey_labels_as_jax_and_palette_indices(tmp_path):
    """A grey-level mask loads as JAX's `_load_pair` loads it; a palette
    PNG (VOC's SegmentationClass) gives its indices, where JAX's cv2 read
    gives the colours' grey levels."""
    from PIL import Image
    src = np.random.default_rng(4)
    im = src.integers(0, 256, (30, 40, 3), np.uint8)
    lb = src.integers(0, 21, (30, 40)).astype(np.uint8)
    lb[:3] = 255
    cv2.imwrite(str(tmp_path / "im.jpg"), im)
    cv2.imwrite(str(tmp_path / "grey.png"), lb)
    pal = Image.fromarray(lb, mode="P")
    pal.putpalette(tvoc.make_voc_colormap().reshape(-1).tolist())
    pal.save(tmp_path / "pal.png")
    got = tvoc.load_pair(str(tmp_path / "im.jpg"), str(tmp_path / "grey.png"))
    want = pb._load_pair(str(tmp_path / "im.jpg"), str(tmp_path / "grey.png"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(tvoc.load_label(str(tmp_path / "pal.png")), lb)
    assert not np.array_equal(
        pb._load_pair(str(tmp_path / "im.jpg"), str(tmp_path / "pal.png"))[1],
        lb)


def _fabricate_kaffe(path):
    """tests/test_pretrain_backbone.py's kaffe fabricator (its
    test_kaffe_npy_ingestion)."""
    from cmpc_refseg_tpu.models.backbone import resnet_stages
    rng = np.random.default_rng(0)
    data = {}

    def add_conv(name, k, cin, cout):
        data[name] = {"weights": rng.standard_normal(
            (k, k, cin, cout)).astype(np.float32)}

    def add_bn(name, c):
        data[name] = {
            "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "beta": rng.standard_normal(c).astype(np.float32),
            "moving_mean": rng.standard_normal(c).astype(np.float32),
            "moving_variance": rng.uniform(0.5, 2.0, c).astype(np.float32)}

    add_conv("conv1", 7, 3, 64)
    add_bn("bn_conv1", 64)
    cin = 64
    for stage, blocks, mid, cout, _, _ in resnet_stages(2):
        for bi, b in enumerate(blocks):
            suffix = f"{stage[len('res'):]}{b}"
            if bi == 0:
                add_conv(f"res{suffix}_branch1", 1, cin, cout)
                add_bn(f"bn{suffix}_branch1", cout)
            add_conv(f"res{suffix}_branch2a", 1, cin if bi == 0 else cout, mid)
            add_bn(f"bn{suffix}_branch2a", mid)
            add_conv(f"res{suffix}_branch2b", 3, mid, mid)
            add_bn(f"bn{suffix}_branch2b", mid)
            add_conv(f"res{suffix}_branch2c", 1, mid, cout)
            add_bn(f"bn{suffix}_branch2c", cout)
        cin = cout
    for i in range(4):
        data[f"fc1_voc12_c{i}"] = {
            "weights": rng.standard_normal((3, 3, 2048, 21)).astype(
                np.float32),
            "biases": rng.standard_normal(21).astype(np.float32)}
    np.save(path, np.asarray(data, dtype=object))


def test_kaffe_ingestion_bit_equal(tmp_path):
    npy = str(tmp_path / "net.npy")
    _fabricate_kaffe(npy)
    want = {"backbone": pb.init_backbone(jax.random.PRNGKey(0), 2),
            "head": pb.init_voc_head(jax.random.PRNGKey(1), 21)}
    ctc.convert_backbone_from_kaffe_npy(npy, want["backbone"], want["head"])
    want = worker.flat_jax(want)
    got = worker.flat_port(tkaffe.voc_params_from_kaffe_npy(
        npy, res4_blocks=2, num_classes=21, device="cpu"))
    assert set(got) == set(want) and len(want) > 100
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), \
            name
    assert tkaffe.BN_EPS == ctc.BN_EPS
    assert tkaffe.bn_name_for("res4b3_branch2a") == \
        ctc.bn_name_for("res4b3_branch2a") == "bn4b3_branch2a"


def test_split_trainable_equal():
    tree = worker.tree()
    params = tpb.params_to_torch(tree, device="cpu")
    for scope in ("all", "head"):
        got = [set(worker.flat_port(t)) for t in tpb.split_trainable(params,
                                                               scope)]
        want = [set(worker.flat_jax(t)) for t in pb.split_trainable(tree,
                                                              scope)]
        assert got == want, scope
        assert got[0] and got[1]


# ---------------------------------------------- the port's command lines ---

def _port_main(ws, *argv):
    data = ["--data-dir", ws["data_dir"], "--data-list", ws["data_list"]]
    return tpb.main([*argv[:2], *data, *COMMON, *argv[2:],
                     "--device", "cpu"])


@pytest.fixture(scope="module")
def port_cli(ws):
    """The port's command lines: 3 steps from the init npz (snapshots at 2
    and 3), the resumed third step, the --start-step run, and eval of its
    snapshot."""
    root = ws["root"]
    snap = str(root / "port")
    out = {"loss": _port_main(ws, "--mode", "train", "--restore", ws["init"],
                              "--num-steps", "3", "--snapshot-dir", snap,
                              "--save-every", "2"), "snap": snap}
    _port_main(ws, "--mode", "train",
               "--restore", os.path.join(snap, "model_step2.npz"),
               "--restore-opt", os.path.join(snap, "opt_step2.npz"),
               "--num-steps", "3", "--snapshot-dir", str(root / "resumed"),
               "--save-every", "100")
    _port_main(ws, "--mode", "train", "--restore", ws["init"],
               "--num-steps", "3", "--start-step", "2",
               "--snapshot-dir", str(root / "ps"), "--save-every", "100")
    out["miou"] = _port_main(ws, "--mode", "eval", "--restore",
                             os.path.join(snap, "model_step3.npz"))
    return out


def test_resume_is_bit_equal(ws, port_cli):
    got = _npz(str(ws["root"] / "resumed" / "model_step3.npz"))
    want = _npz(os.path.join(port_cli["snap"], "model_step3.npz"))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    opt_got = _npz(str(ws["root"] / "resumed" / "opt_step3.npz"))
    opt_want = _npz(os.path.join(port_cli["snap"], "opt_step3.npz"))
    assert set(opt_got) == set(opt_want)
    for k in opt_want:
        assert np.array_equal(opt_got[k], opt_want[k]), k
    assert int(opt_want["count"]) == int(opt_want["step"]) == 3


def test_cli_train_matches_jax(ws, port_cli):
    jax_cli = ws["jax_cli"].result()
    np.testing.assert_allclose(port_cli["loss"], jax_cli["loss"], rtol=1e-5)
    init = _npz(ws["init"])
    for port_dir, jax_dir in (("port", "jax"), ("ps", "js")):
        got = _npz(str(ws["root"] / port_dir / "model_step3.npz"))
        want = _npz(str(ws["root"] / jax_dir / "model_step3.npz"))
        assert set(got) == set(want) == set(init)
        _check_step_rule(worker.step_errors(got, want, init), port_dir)


def test_cli_eval_and_infer_match_jax(ws, port_cli):
    """Each package's snapshot evaluated in the other prints the same mIoU;
    inference of JAX's snapshot gives JAX's prediction and PNG."""
    jax_cli = ws["jax_cli"].result()
    data = ["--data-dir", ws["data_dir"], "--data-list", ws["data_list"]]
    port_snap = os.path.join(port_cli["snap"], "model_step3.npz")
    assert pb.main(["--mode", "eval", *data, *COMMON,
                    "--restore", port_snap]) == port_cli["miou"]
    snap = str(ws["root"] / "jax" / "model_step3.npz")
    assert _port_main(ws, "--mode", "eval", "--restore", snap) == \
        jax_cli["miou"]
    assert 0.0 <= port_cli["miou"] <= 1.0
    png = str(ws["root"] / "port.png")
    pred = _port_main(ws, "--mode", "infer", "--restore", snap,
                      "--image", ws["image"], "--out", png)
    assert pred.shape == (SIZE, SIZE)
    assert np.array_equal(pred, jax_cli["pred"])
    got = cv2.imread(png)
    assert got is not None and np.array_equal(
        got, cv2.imread(str(ws["root"] / "jax.png")))


# ------------------------------------------------------------ the steps ---

def test_adam_head_steps_match_jax(ws):
    """Head-only Adam by test_torch_train.py's Adam rule (over lr: 1e-3
    where JAX's gradient is resolved, 2 elsewhere), its second step from
    JAX's state after the first, as there; losses within rtol 1e-5."""
    steps = ws["adam_fwd"].result()["adam_head"]
    assert len(steps) == 2
    for k, st in enumerate(steps, start=1):
        np.testing.assert_allclose(*st["loss"], rtol=1e-5,
                                   err_msg=f"step {k}")
        assert st["ce"] == st["loss"][0]
        assert st["rule"] and all(a[0] <= 1e-3 and a[1] <= 2
                                  for a in st["rule"].values()), (k, st)


@pytest.mark.parametrize("case", ["sgd_msc", "sgd_all"])
def test_sgd_steps_match_jax(ws, case):
    """Losses within rtol 1e-5 at every draw and step; the weights by the
    step rule at every draw and, for each backbone leaf, within DRAW_TOL at
    its best draw."""
    runs = ws["steps"][case].result()
    assert len(runs) == worker.N_DRAWS
    best = {}
    for d, run in enumerate(runs):
        for k, st in enumerate(run, start=1):
            what = f"{case} draw {d} step {k}"
            for key in ("loss", "ce"):
                np.testing.assert_allclose(*st[key], rtol=1e-5, err_msg=what)
            _check_step_rule(st["errors"], what)
            for name, e in st["errors"].items():
                best[name, k] = min(best.get((name, k), np.inf), e)
    assert len(best) == 2 * len(runs[0][0]["errors"]) > 80
    worst = max(best.items(), key=lambda kv: kv[1])
    assert worst[1] <= DRAW_TOL, (case, worst)


# ------------------------------------------------------------ the model ---

def test_logits_and_eval_forward_match_jax(ws):
    """Within 1e-4 of the largest entry; msc moves the logits."""
    fwd = ws["adam_fwd"].result()["forwards"]
    crop = worker.CROP
    shapes = [(2, crop // 8, crop // 8, NC)] + [(2, crop, crop, NC)] * 2
    for (got_shape, want_shape, err, top), shape in zip(fwd["outputs"],
                                                        shapes):
        assert tuple(got_shape) == tuple(want_shape) == shape
        assert err <= 1e-4 * top, (shape, err, top)
    assert fwd["msc_moved"]


def test_ce_loss_matches_jax():
    src = np.random.default_rng(5)
    logits = (3 * src.standard_normal((2, 5, 6, NC))).astype(np.float32)
    labels = src.integers(0, NC, (2, 5, 6)).astype(np.int32)
    labels[0, :2] = 255
    labels[1, 3] = NC + 3
    want = float(pb.voc_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                NC))
    got = float(tpb.voc_ce_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), NC))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ignored = np.full_like(labels, 255)
    assert float(tpb.voc_ce_loss(torch.from_numpy(logits),
                                 torch.from_numpy(ignored), NC)) == 0.0


def test_entry_points_need_cuda_unless_cpu(ws, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpb.main(["--mode", "eval", "--data-dir", ws["data_dir"],
                  "--data-list", ws["data_list"], *COMMON])
