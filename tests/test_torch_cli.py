"""The port's command lines against the JAX package's, in float32 on
the CPU, at the TINY geometry of tests/test_cli_e2e.py.

- `-m train`, 2 steps on the same fake RefVOS tree (one prefetch thread,
  so both read the same samples in the same order; the flagship has no
  augmentation, so the batches and the weights from seed 0 are the
  same): the logged iteration-0 metrics within rtol 1e-5 and with JAX's
  keys; the snapshots of steps 1 and 2, JAX's brought across by
  tools/jax_checkpoint_to_torch.py, within PERF.md section 2's train-step
  bounds, summed over the steps (weights 1e-3 lr where the gradient is
  resolved, |g| >= 1e-6 and >= 1e-3 of the leaf's largest, as for v4 and
  v6; Adam's first moment 1e-4 of the leaf's largest entry plus 1e-11 of
  the largest).  `-resume` continues at step 2 and
  ends with a snapshot at 4.
- `-m test` on fake npz batches from the converted checkpoint: overall
  IoU, mean IoU and prec@X printed within 1e-5 of JAX's printout; `-v`
  writes the same file names.
- The flags of the ported items pass (`-c`), or raise where their run
  cannot start (`-mesh 2` without a world of 2, `-distributed` without
  torchrun's environment), and without a CUDA device and without
  `-device cpu` the command lines raise (`-quantize` too).
- `serving.server.main` answers a POST /predict as a `PredictService` on
  the same weights does (masks equal).
- `serving.export`: the exported program within 1e-5 of the plain route,
  and within 1e-4 of the JAX package's `make_predict_fn`.
"""

import base64
import contextlib
import io
import json
import os
import re
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch import cli as tcli
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.models.model import apply_model, init_model
from cmpc_refseg_torch.models.model import init_model_state
from cmpc_refseg_torch.serving import export as texport
from cmpc_refseg_torch.serving import server as tserver
from cmpc_refseg_torch.train.checkpoint import latest_step, restore_checkpoint
from cmpc_refseg_torch.train.optimizer import named_leaves
from cmpc_refseg_torch.train.trainer import create_train_state
from cmpc_refseg_tpu import cli as jcli
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.serving import export as jexport
from tools.jax_checkpoint_to_torch import convert

torch.set_num_threads(2)

TINY_ARGS = ["-H", "32", "-W", "32", "-T", "8", "-rnn_size", "16",
             "-v_emb_dim", "16", "-mlp_dim", "12", "-glove_dim", "8",
             "-res4_blocks", "2", "-vocab_size", "7"]
TINY = dict(H=32, W=32, num_steps=8, rnn_size=16, v_emb_dim=16, mlp_dim=12,
            glove_dim=8, res4_blocks=2, vocab_size=7, batch_size=1,
            compute_dtype="float32")
PORT = ["-device", "cpu"]
COMMON = ["-dtype", "float32", "-workers", "1", "-mesh", "1"]


def _fake_refvos(root):
    """tests/test_cli_e2e.py's fake RefVOS tree: two 48x64 frames, one
    object, a 7-word vocabulary."""
    from PIL import Image
    from cmpc_refseg_torch.data.refvos import OBJECT_COLOR
    im_dir = os.path.join(root, "JPEGImages")
    mask_dir = os.path.join(root, "Annotations")
    os.makedirs(os.path.join(im_dir, "v0"))
    os.makedirs(os.path.join(mask_dir, "v0"))
    rng = np.random.default_rng(0)
    meta = []
    for i in range(2):
        im = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(im).save(os.path.join(im_dir, "v0", f"f{i}.jpg"))
        mask = np.zeros((48, 64, 3), np.uint8)
        mask[10:30, 20:50] = OBJECT_COLOR["1"]
        Image.fromarray(mask).save(os.path.join(mask_dir, "v0", f"f{i}.png"))
        meta.append([f"v0/f{i}.jpg", f"v0/f{i}.png", "the red box", "1"])
    meta_path = os.path.join(root, "meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    vocab_path = os.path.join(root, "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(["<pad>", "<go>", "<eos>", "the", "red", "box",
                           "<unk>"]))
    return dict(im_dir=im_dir, mask_dir=mask_dir, meta=meta_path,
                vocab=vocab_path, root=root)


def _fake_npz_val(root):
    """Four native-size eval samples of tests/test_cli_e2e.py's kind."""
    eval_dir = os.path.join(root, "unc", "val_batch")
    os.makedirs(eval_dir)
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(40, 56), (30, 30), (50, 36), (40, 56)]):
        text = np.zeros((8,), np.int32)
        words = [3, 4, 5][:3 - i % 2]
        text[:len(words)] = words
        mask = np.zeros((h, w), bool)
        mask[h // 4:3 * h // 4, w // 5:(3 + i % 2) * w // 5] = True
        np.savez(os.path.join(eval_dir, f"unc_val_{i}.npz"), text_batch=text,
                 im_batch=rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                 mask_batch=mask)


def _train_args(data, root, name, steps, extra=()):
    return ["-m", "train", "-d", "refvos", "-t", "train", "-n", "CMPC_model",
            "-im_dir", data["im_dir"], "-mask_dir", data["mask_dir"],
            "-meta", data["meta"], "-vocab", data["vocab"],
            "-emb_dir", data["root"], "-bs", "1", "-st", str(steps),
            "-s", "1", "-ckpt_dir", os.path.join(root, f"ckpt_{name}"),
            "-log_dir", os.path.join(root, f"logs_{name}")] \
        + COMMON + TINY_ARGS + list(extra)


def _test_args(root, ckpt_dir, log_dir):
    return ["-m", "test", "-d", "unc", "-t", "val", "-n", "CMPC_model",
            "-f", root, "-ckpt_dir", ckpt_dir, "-emb_dir", root,
            "-log_dir", log_dir, "-v"] + COMMON + TINY_ARGS


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _printed(text):
    """{'overall IoU': x, 'mean IoU': y, 'precision@t': p} of a printout."""
    return {k: float(v) for k, v in
            re.findall(r"^(overall IoU|mean IoU|precision@[\d.]+) = "
                       r"([-\d.]+)", text, re.M)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both command lines train 2 steps, JAX's snapshot is converted, the port
    resumes to step 4, and both test from the step-2 weights."""
    root = str(tmp_path_factory.mktemp("cli"))
    data = _fake_refvos(root)
    _fake_npz_val(root)
    out = {"root": root}
    out["jax_train"] = _run(jcli.main, _train_args(data, root, "jax", 2))
    out["port_train"] = _run(tcli.main, _train_args(data, root, "port", 2)
                             + PORT)
    out["converted"] = os.path.join(root, "ckpt_conv")
    for step in (1, 2):
        convert(os.path.join(root, "ckpt_jax"), "CMPC_model",
                out["converted"], step=step, overrides=TINY)
    out["jax_test"] = _run(jcli.main, _test_args(
        root, os.path.join(root, "ckpt_jax"), os.path.join(root, "vis_jax")))
    out["port_test"] = _run(tcli.main, _test_args(
        root, out["converted"], os.path.join(root, "vis_port")) + PORT)
    out["resumed"] = _run(tcli.main, _train_args(
        data, root, "port", 4, ["-resume"]) + PORT)
    return out


def _state(cfg, directory, step):
    state = create_train_state(0, cfg, device="cpu")
    return restore_checkpoint(directory, state, step)


def test_train_logs_jax_metrics(runs):
    """The iteration-0 record: JAX's keys, and its losses, train mIoU and
    learning rate within rtol 1e-5 (step_time_s is a wall time)."""
    got = _records(os.path.join(runs["root"], "logs_port"))[0]
    want = _records(os.path.join(runs["root"], "logs_jax"))[0]
    assert set(got) == set(want)
    assert got["step"] == want["step"] == 0
    for k in sorted(set(want) - {"step", "ts", "step_time_s"}):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert "iter 0: loss" in runs["port_train"]


def test_train_snapshots_match_jax(runs):
    """Steps 1 and 2 of the port's run against JAX's, converted: Adam's
    first moment (mu = b1 mu_prev + 0.1 g) within 1e-4 of the leaf's
    largest entry + 1e-11 of the largest, per step; the weights within
    1e-3 lr per step where every step's gradient is resolved (|g| >= 1e-6
    and >= 1e-3 of the leaf's largest: the second step starts from each
    side's own first), 2 lr per step elsewhere; the frozen backbone
    bit-equal."""
    cfg = tget("CMPC_model", **TINY)
    lr = cfg.start_lr
    root = runs["root"]
    port = [_state(cfg, os.path.join(root, "ckpt_port"), s) for s in (1, 2)]
    jax_ = [_state(cfg, runs["converted"], s) for s in (1, 2)]

    def moments(state):
        return {path: state.optimizer.state[p]["exp_avg"].numpy()
                for path, p in named_leaves(state.trainable)}
    mu_p, mu_j = [moments(s) for s in port], [moments(s) for s in jax_]
    floor = 1e-11 * max(np.abs(m).max() for m in mu_j[0].values())
    for step in (0, 1):
        assert port[step].step == jax_[step].step == step + 1
        for path, want in mu_j[step].items():
            np.testing.assert_allclose(
                mu_p[step][path], want, rtol=0,
                atol=(step + 1) * (1e-4 * np.abs(want).max() + floor),
                err_msg=str(path))
        resolved = {path: np.all([
            (np.abs(g) >= 1e-6) & (np.abs(g) >= 1e-3 * np.abs(g).max())
            for g in (mu_j[0][path] / 0.1,
                      (mu_j[1][path] - 0.9 * mu_j[0][path]) / 0.1)
        ][:step + 1], axis=0) for path in mu_j[0]}
        moved = 0
        for (path, a), (_, b) in zip(named_leaves(port[step].trainable),
                                     named_leaves(jax_[step].trainable)):
            err = np.abs(a.detach().numpy() - b.detach().numpy())
            assert err[resolved[path]].max(initial=0) <= \
                (step + 1) * 1e-3 * lr, path
            assert err.max() <= (step + 1) * 2 * lr, path
            moved += int(resolved[path].sum())
        assert moved > 1000
    for (path, a), (_, b) in zip(named_leaves(port[1].frozen_f32),
                                 named_leaves(jax_[1].frozen_f32)):
        assert torch.equal(a, b), path


def test_resume_continues_at_step_2(runs):
    assert "resumed from" in runs["resumed"] and "at step 2" in \
        runs["resumed"]
    assert latest_step(os.path.join(runs["root"], "ckpt_port")) == 4
    records = _records(os.path.join(runs["root"], "logs_port"))
    assert [r["step"] for r in records] == [0]


def test_test_prints_jax_results(runs):
    """overall IoU, mean IoU and prec@X within 1e-5 of JAX's printout."""
    got, want = _printed(runs["port_test"]), _printed(runs["jax_test"])
    assert len(want) == 7 and set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5, (k, got[k], v)
    assert "(4 samples)" in runs["port_test"]


def test_visualize_writes_jax_file_names(runs):
    names = [sorted(os.listdir(os.path.join(runs["root"], d, "visualize")))
             for d in ("vis_port", "vis_jax")]
    assert names[0] == names[1] and len(names[0]) == 12


@pytest.mark.parametrize("flag, item", [
    (["-c"], "item 9"), (["-mesh", "2"], "item 11"),
    (["-distributed"], "item 11")])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_unported_flags_raise(flag, item, mode, monkeypatch):
    """The flags of ported items pass the gate and reach their code.  `-c`
    (item 9) reaches `evaluate` as use_crf (its run against JAX's:
    tests/test_torch_postproc.py).  The data-parallel flags (item 11):
    `-mesh 2` without a world of 2 raises the ValueError that says how to
    launch one, and `-distributed` without torchrun's environment raises
    from `initialize_distributed` (their runs: tests/test_torch_parallel.py)."""
    argv = ["-m", mode, "-device", "cpu"] + flag
    if item == "item 9":
        args = tcli.build_argparser().parse_args(argv)
        tcli.check_mesh(args, 1)
        assert args.use_crf
        return
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    if flag == ["-mesh", "2"]:
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            tcli.main(argv)
    else:
        with pytest.raises(RuntimeError, match="RANK.*not set.*torchrun"):
            tcli.main(argv)


def test_no_cuda_without_device_cpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-m", "test", "-f", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.main(["-vocab", "v.txt", "-ckpt_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.main(["-vocab", "v.txt", "-quantize"])


def test_metric_logger_record_format(tmp_path):
    """The port's MetricLogger writes the JAX package's records."""
    from cmpc_refseg_torch.utils.logging import MetricLogger as TLogger
    from cmpc_refseg_tpu.utils.logging import MetricLogger as JLogger
    recs = []
    for cls, name in ((TLogger, "t"), (JLogger, "j")):
        logger = cls(str(tmp_path / name), use_tensorboard=False)
        logger.log(3, {"loss": np.float32(1.5), "lr": torch.tensor(2.0)})
        logger.close()
        (rec,) = _records(str(tmp_path / name))
        recs.append(rec)
    assert set(recs[0]) == set(recs[1]) == {"step", "ts", "loss", "lr"}
    assert {k: v for k, v in recs[0].items() if k != "ts"} == \
        {k: v for k, v in recs[1].items() if k != "ts"}


def test_server_main_answers_as_predict_service(runs, monkeypatch):
    """`serving.server.main` on the step-4 snapshot in a thread (its
    `serve` wrapped to hand the server over for the shutdown): a POST
    /predict gives the mask of a PredictService on the restored state."""
    from PIL import Image
    root = runs["root"]
    ckpt = os.path.join(root, "ckpt_port")
    held, real_serve = [], tserver.serve

    def serve(service, **kw):
        held.append(real_serve(service, **kw))
        return held[-1]
    monkeypatch.setattr(tserver, "serve", serve)
    thread = threading.Thread(target=tserver.main, daemon=True, args=([
        "-ckpt_dir", ckpt, "-vocab", os.path.join(root, "vocab.txt"),
        "-emb_dir", root, "-port", "0", "-device", "cpu"],))
    thread.start()
    deadline = time.monotonic() + 120
    while not held and thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert held, "the server did not start"
    image = np.random.default_rng(5).integers(0, 256, (40, 52, 3),
                                              dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{held[0].server_address[1]}/predict",
            data=json.dumps({"image": base64.b64encode(
                buf.getvalue()).decode(), "expression": "the red box"
            }).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
    finally:
        held[0].shutdown()
        thread.join(30)
    assert not thread.is_alive()
    mask = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        reply["mask"])))) > 0
    cfg = tget("CMPC_model", **TINY)
    state = _state(cfg, ckpt, 4)
    vocab = {w: i for i, w in enumerate(
        ["<pad>", "<go>", "<eos>", "the", "red", "box", "<unk>"])}
    service = tserver.PredictService(cfg, state.params(), vocab,
                                     model_state=state.model_state,
                                     device="cpu")
    prob, want = service.predict(image, "the red box")
    assert mask.shape == (40, 52)
    np.testing.assert_array_equal(mask, want)
    np.testing.assert_allclose(reply["prob_max"], prob.max(), rtol=1e-5)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = tget("CMPC_model", **TINY)
    params = init_model(0, cfg, device="cpu")
    state = init_model_state(cfg, device="cpu")
    path = str(tmp_path_factory.mktemp("export") / "predict.pt2")
    texport.export_program(cfg, params, state, path, batch_size=2)
    rng = np.random.default_rng(6)
    feed = (torch.tensor(50 * rng.standard_normal((2, 32, 32, 3)),
                         dtype=torch.float32),
            torch.tensor([[3, 4, 5, 0, 0, 0, 0, 0], [5, 3, 0, 0, 0, 0, 0,
                                                     0]]),
            torch.tensor([3, 2]))
    return {"cfg": cfg, "params": params, "state": state, "feed": feed,
            "masks": texport.load_program(path)(*feed)}


def test_exported_program_matches_plain_route(exported):
    cfg, feed = exported["cfg"], exported["feed"]
    with torch.inference_mode():
        want = apply_model(exported["params"], cfg,
                           {"im": feed[0], "words": feed[1],
                            "seq_len": feed[2]},
                           model_state=exported["state"],
                           use_kernels=False).sigm[..., 0]
    assert exported["masks"].shape == (2, 32, 32)
    torch.testing.assert_close(exported["masks"], want, rtol=0, atol=1e-5)


def test_exported_program_matches_jax_predict_fn(exported):
    jcfg = jget("CMPC_model", **TINY)
    params, state = jinit(jax.random.PRNGKey(0), jcfg)
    feed = exported["feed"]
    want = jexport.make_predict_fn(jcfg, params, state)(
        jnp.asarray(feed[0].numpy()), jnp.asarray(feed[1].numpy(), jnp.int32),
        jnp.asarray(feed[2].numpy(), jnp.int32))
    np.testing.assert_allclose(exported["masks"].numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
