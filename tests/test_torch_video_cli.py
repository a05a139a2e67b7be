"""The port's video command line, RefVOS inference driver and A2D builder
against the JAX package's, in float32 on the CPU, at TINY geometries.

- `cli_video -m train` (2 steps, a snapshot each) and `-m test` on
  tests/test_cli_e2e.py:77-106's fake A2D batches (plus an empty-mask
  test sample): the logged metrics within rtol 1e-5 with JAX's keys; JAX's
  snapshots converted by tools/jax_checkpoint_to_torch.py (its video
  target) against the port's, by tests/test_torch_cli.py's snapshot
  bounds; the port's test printout from the converted step within 1e-5 of
  JAX's, n counting the non-empty samples.
- `infer_video.run_inference` (CMPC_model, frame_batch 2, a padded tail)
  on tests/test_cli_e2e.py:178-260's fixtures: the PNGs equal JAX's but
  where a pixel's sigm lies within 1e-4 of the threshold; the
  inconsistency report equal.
- `data.a2d.build_a2d_batches` on tests/test_a2d.py's kind of tree: the
  same npz files (h5py needed).
- Without a CUDA device and without `-device cpu` both drivers raise.
"""

import contextlib
import csv
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cmpc_refseg_torch import cli_video as tcv
from cmpc_refseg_torch import infer_video as tinfer
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import params_from_jax
from cmpc_refseg_torch.train import checkpoint as tck
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_torch.train.optimizer import named_leaves
from cmpc_refseg_tpu import cli_video as jcv
from cmpc_refseg_tpu import infer_video as jinfer
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import init_model as jinit
from tools.jax_checkpoint_to_torch import convert

torch.set_num_threads(2)

NAME = "CMPC_video_mm_tgraph_allvec"
# tests/test_cli_e2e.py:77-106
CLI_ARGS = ["-H", "32", "-W", "32", "-num_steps", "6", "-rnn_size", "16",
            "-v_emb_dim", "16", "-mlp_dim", "12", "-glove_dim", "8",
            "-res4_blocks", "2", "-vocab_size", "30", "-num_frames", "4",
            "-sampled_frames", "0,1,3"]
CLI_CFG = dict(H=32, W=32, num_steps=6, rnn_size=16, v_emb_dim=16,
               mlp_dim=12, glove_dim=8, res4_blocks=2, vocab_size=30,
               num_frames=4, sampled_frames=(0, 1, 3))
PORT = ["-device", "cpu"]
# conv biases whose exact gradient is 0 (tests/test_torch_video_train.py)
ZERO_GRAD = ("tg_vtrans", "tg_key", "ctx_trans", "spa_graph_key")


def _exact_zero(path) -> bool:
    return path[-1] == "biases" and path[-2] in ZERO_GRAD


def _fake_a2d(root):
    """tests/test_cli_e2e.py:77-106's A2D batches, and a third test sample
    whose mask is empty."""
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        d = os.path.join(root, f"{split}_batch")
        os.makedirs(d)
        for i in range(2 if split == "train" else 3):
            text = np.zeros((6,), np.int32)
            text[:2] = [3, 4]
            mask = np.zeros((32, 32), bool)
            if i < 2:
                mask[8:20, 8:24] = True
            np.savez(os.path.join(d, f"a2d_{split}_{i}.npz"),
                     text_batch=text, seq_length=np.asarray(2),
                     mask_batch=mask,
                     frames=rng.integers(0, 255, (4, 32, 32, 3),
                                         dtype=np.uint8))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _printed(text):
    return {k: float(v) for k, v in
            re.findall(r"^(\S+) = ([-\d.e]+)$", text, re.M)}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both video command lines train 2 steps (a snapshot each); JAX's
    snapshots are converted; JAX tests its step 2, the port the
    converted step 2."""
    root = str(tmp_path_factory.mktemp("a2d"))
    _fake_a2d(root)
    out = {"root": root}
    for name, main, extra in (("jax", jcv.main, []),
                              ("port", tcv.main, PORT)):
        out[f"{name}_train"] = _run(main, [
            "-m", "train", "-f", root, "-i", "2", "-s", "1",
            "-ckpt_dir", os.path.join(root, f"ckpt_{name}"),
            "-log_dir", os.path.join(root, f"logs_{name}"),
            "-emb_dir", root] + CLI_ARGS + extra)
    out["converted"] = os.path.join(root, "ckpt_conv")
    for step in (1, 2):
        assert convert(os.path.join(root, "ckpt_jax"), NAME,
                       out["converted"], step=step,
                       overrides=CLI_CFG) == step
    out["jax_test"] = _run(jcv.main, [
        "-m", "test", "-f", root, "-ckpt_dir",
        os.path.join(root, "ckpt_jax"), "-emb_dir", root] + CLI_ARGS)
    out["port_test"] = _run(tcv.main, [
        "-m", "test", "-f", root, "-ckpt_dir", out["converted"],
        "-emb_dir", root] + CLI_ARGS + PORT)
    return out


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_logs_jax_metrics(cli_runs):
    root = cli_runs["root"]
    got = _records(os.path.join(root, "logs_port"))
    want = _records(os.path.join(root, "logs_jax"))
    assert len(got) == len(want) == 1 and set(got[0]) == set(want[0])
    for k in sorted(set(want[0]) - {"step", "ts"}):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   err_msg=k)
    assert "iter 0: loss" in cli_runs["port_train"]


def test_cli_test_prints_jax_results(cli_runs):
    got, want = _printed(cli_runs["port_test"]), _printed(
        cli_runs["jax_test"])
    assert set(got) == set(want) and len(want) == 13
    assert got["n"] == want["n"] == 2
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5, (k, got[k], v)


def test_cli_snapshots_match_converted_jax(cli_runs):
    """The port's step-1 and step-2 snapshots against JAX's, converted by
    tools/jax_checkpoint_to_torch.py: tests/test_torch_cli.py's bounds
    (Adam's first moment 1e-4 of the leaf's largest entry + 1e-11 of the
    largest, per step; weights 1e-3 lr per step where every step's
    gradient is resolved, 2 lr per step elsewhere); the frozen backbone
    bit-equal."""
    cfg = tget(NAME, **CLI_CFG, batch_size=1)
    lr = cfg.start_lr

    def state(directory, step):
        return tck.restore_checkpoint(
            directory, ttrain.create_train_state(0, cfg, device="cpu"), step)
    port = [state(os.path.join(cli_runs["root"], "ckpt_port"), s)
            for s in (1, 2)]
    jax_ = [state(cli_runs["converted"], s) for s in (1, 2)]

    def moments(st):
        return {p: st.optimizer.state[leaf]["exp_avg"].numpy()
                for p, leaf in named_leaves(st.trainable)}
    mu_p, mu_j = [moments(s) for s in port], [moments(s) for s in jax_]
    floor = 1e-11 * max(np.abs(m).max() for m in mu_j[0].values())
    for step in (0, 1):
        assert port[step].step == jax_[step].step == step + 1
        for path, want in mu_j[step].items():
            if _exact_zero(path):
                assert max(np.abs(mu_p[step][path]).max(),
                           np.abs(want).max()) <= 1e-10 * floor / 1e-11, path
                continue
            np.testing.assert_allclose(
                mu_p[step][path], want, rtol=0,
                atol=(step + 1) * (1e-4 * np.abs(want).max() + floor),
                err_msg=str(path))
        grads = [mu_j[0][p] / 0.1 for p in mu_j[0]], \
            [(mu_j[1][p] - 0.9 * mu_j[0][p]) / 0.1 for p in mu_j[0]]
        moved = 0
        for i, ((path, a), (_, b)) in enumerate(zip(
                named_leaves(port[step].trainable),
                named_leaves(jax_[step].trainable))):
            resolved = np.all([(np.abs(g[i]) >= 1e-6)
                               & (np.abs(g[i]) >= 1e-3 * np.abs(g[i]).max())
                               for g in grads[:step + 1]], axis=0)
            err = np.abs(a.detach().numpy() - b.detach().numpy())
            assert err[resolved].max(initial=0) <= \
                (step + 1) * 1e-3 * lr, path
            assert err.max() <= (step + 1) * 2 * lr, path
            moved += int(resolved.sum())
        assert moved > 1000
    for (path, a), (_, b) in zip(named_leaves(port[1].frozen_f32),
                                 named_leaves(jax_[1].frozen_f32)):
        assert torch.equal(a, b), path


def _ytvos_tree(root, frames, expressions, words):
    """tests/test_cli_e2e.py:178-260's fake RefVOS video: 48x64 JPEG
    frames, meta_expressions.json and a vocabulary."""
    im_dir = os.path.join(root, "JPEGImages")
    os.makedirs(os.path.join(im_dir, "video1"))
    rng = np.random.default_rng(0)
    for f in frames:
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                        ).save(os.path.join(im_dir, "video1", f"{f}.jpg"))
    meta = {"videos": {"video1": {
        "expressions": {str(i): {"exp": e} for i, e in
                        enumerate(expressions)}, "frames": frames}}}
    meta_path = os.path.join(root, "meta_expressions.json")
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    vocab_path = os.path.join(root, "vocab.txt")
    with open(vocab_path, "w") as fh:
        fh.write("\n".join(["<pad>", "<go>", "<eos>"] + words + ["<unk>"]))
    return dict(meta_path=meta_path, im_dir=im_dir, vocab_path=vocab_path)


@pytest.mark.parametrize("report", [False, True])
def test_run_inference_matches_jax(tmp_path, monkeypatch, report):
    """Three frames at frame_batch 2 (a padded tail), two expressions:
    every PNG equal to JAX's but where a pixel's sigm lies within 1e-4 of
    the threshold (JAX's mask lies between the port's masks of the
    thresholds 0.5 +- 1e-4); with the report, the same
    inconsitent_frames.json."""
    frames = ["00000", "00005", "00010"]
    tree = _ytvos_tree(str(tmp_path), frames, ["the red box", "a blue dog"],
                       ["the", "red", "box", "a", "blue", "dog"])
    geo = dict(H=32, W=32, num_steps=8, vocab_size=10, glove_dim=8,
               rnn_size=16, v_emb_dim=16, mlp_dim=12, res4_blocks=2)
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    jp, js = jinit(jax.random.PRNGKey(0), jcfg)
    sigms = []
    real = tinfer.make_forward

    def recording(cfg, inconsistency_report, use_kernels=True):
        fwd = real(cfg, inconsistency_report, use_kernels)

        def run(params, model_state, batch):
            out = fwd(params, model_state, batch)
            sigms.extend(out[0][..., 0].numpy())
            return out
        return run
    monkeypatch.setattr(tinfer, "make_forward", recording)
    kw = dict(frame_batch=2, inconsistency_report=report, **tree)
    n_j = jinfer.run_inference(jcfg, jp, js, out_dir=str(tmp_path / "j"),
                               **kw)
    n_t = tinfer.run_inference(tcfg, params_from_jax(jp, tcfg, device="cpu"),
                               {}, out_dir=str(tmp_path / "t"),
                               device="cpu", **kw)
    assert n_j == n_t == 2
    order = [(e, f) for e in ("0", "1") for f in frames + [None]]
    checked = 0
    for (eid, frame), sigm in zip(order, sigms):
        if frame is None:           # the padded tail of each expression
            continue
        name = os.path.join("video1", eid, f"{frame}.png")
        got = np.asarray(Image.open(str(tmp_path / "t" / name)))
        want = np.asarray(Image.open(str(tmp_path / "j" / name)))
        assert got.shape == want.shape == (24, 32)
        np.testing.assert_array_equal(got, tinfer.video_output_mask(
            (sigm >= 0.5).astype(np.float32), 24, 32))
        lo, hi = (tinfer.video_output_mask((sigm >= t).astype(np.float32),
                                           24, 32)
                  for t in (0.5 + 1e-4, 0.5 - 1e-4))
        assert np.all((lo <= want) & (want <= hi)), name
        checked += 1
    assert checked == 6
    if report:
        reports = [json.load(open(tmp_path / d / "inconsitent_frames.json"))
                   for d in ("t", "j")]
        assert reports[0] == reports[1]


def test_build_a2d_batches_matches_jax(tmp_path):
    """tests/test_a2d.py's kind of tree (20 frames of one video, two
    instances in one h5 annotation, one train sentence): the same npz
    files, key for key."""
    h5py = pytest.importorskip("h5py")
    from cmpc_refseg_torch.data import a2d as ta2d
    from cmpc_refseg_tpu.data import a2d as ja2d
    root = str(tmp_path / "a2d")
    vid = "vid00001"
    frame_dir = os.path.join(root, "Release", "frames", vid)
    os.makedirs(frame_dir)
    rng = np.random.default_rng(0)
    for i in range(1, 21):
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
                        ).save(os.path.join(frame_dir, f"{i:0>5d}.png"))
    with open(os.path.join(root, "Release", "videoset.csv"), "w") as f:
        f.write(f"{vid},x,x,x,x,x,x,x,0\n")
    inst_dir = os.path.join(root, "a2d_annotation_with_instances", vid)
    os.makedirs(inst_dir)
    m0 = np.zeros((24, 32), np.uint8)
    m0[4:12, 6:20] = 1
    m1 = np.zeros((24, 32), np.uint8)
    m1[14:20, 10:28] = 1
    with h5py.File(os.path.join(inst_dir, "00010.h5"), "w") as f:
        f["instance"] = np.asarray([3, 7])
        f["reMask"] = np.stack([m0.T, m1.T])
    with open(os.path.join(root, "a2d_annotation.txt"), "w") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "instance_id", "query"])
        w.writerow([vid, "7", "the lower thing"])
        w.writerow([vid, "3", "the upper thing"])
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["<pad>", "<go>", "<eos>", "the", "lower",
                           "thing", "<unk>"]))
    counts = [mod.build_a2d_batches(root, str(tmp_path / name), vocab, T=6,
                                    input_H=16, input_W=16)
              for mod, name in ((ta2d, "t"), (ja2d, "j"))]
    assert counts[0] == counts[1] and counts[0]["train"] == 2
    for i in range(2):
        files = [np.load(str(tmp_path / d / "train_batch"
                             / f"a2d_train_{i}.npz"), allow_pickle=True)
                 for d in ("t", "j")]
        assert files[0].files == files[1].files
        for k in files[1].files:
            np.testing.assert_array_equal(files[0][k], files[1][k], k)
    assert ta2d.frame_range(2, frame_dir) == ja2d.frame_range(2, frame_dir)


def test_drivers_need_cuda_unless_cpu(monkeypatch, tmp_path):
    """Both video drivers run on CUDA by default and raise without it
    unless given `-device cpu`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcv.main(["-m", "test", "-f", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinfer.main(["-meta", "m.json", "-im_dir", "j", "-out", "o",
                     "-vocab", "v.txt"])
