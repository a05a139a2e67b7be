"""Data-parallel training and sharded evaluation of the port over 2 gloo
ranks on the CPU (``parallel/mesh.py``), against the JAX package's
global-batch step and the port's own single process, in float32 at TINY.

The ranks are spawned processes (``tests/torch_parallel_worker.py``: torch
and the port only) sharing one world through a file:// rendezvous in a
temporary directory, for the whole module; the JAX references run here.
Each result is awaited with a timeout, so a hung rank fails its test.

- One and two DP steps of the flagship and of CMPCv4_model (the ASPP
  decoder's BN on the global batch's moments) at global batch 4 (2 a
  rank), the second from the JAX state after the first, against JAX
  `make_train_step(grad_mode="tree")` at the global batch, under
  tests/test_torch_variants_train.py's bounds: losses rtol 1e-5;
  gradients (Adam's first moment) 1e-4 of the leaf's largest entry +
  1e-11 of the largest (the exchanges' key biases, exactly 0, at 1e-10 of
  the largest); weights 1e-3 lr where resolved, 2 lr elsewhere; BN
  moving statistics atol 1e-6.  After every step both ranks hold
  bit-equal weights and statistics.
- The same steps against the port's single-process step on the whole
  batch (CMPCv4_model with its brightness augmentation on: every rank
  draws the step's one delta), and grad_accum=2 under DP against
  grad_accum=2 in one process.
- `evaluate_sharded` over the 2 ranks: I, U, prec@X and n equal to one
  device's over the same global batches, the IoU sum within 1e-6; over a
  group of one rank, each rank's results equal one device's.
- `cli.main -m train -distributed` with 2 ranks started as torchrun starts
  them: only rank 0 logs and writes snapshots, and its logged step-0
  metrics match the single-process command line's within rtol 1e-5.
- SIGTERM to one rank during a `train_loop`: both ranks stop at the same
  iteration (agreed by an all-reduce), no hang.
"""

import contextlib
import io
import multiprocessing as mp
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from cmpc_refseg_torch import cli as tcli
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.models.model import init_model, init_model_state
from cmpc_refseg_torch.train import evaluator as tev
from cmpc_refseg_torch.train import optimizer as topt
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.train import trainer as jtrain
from test_torch_cli import COMMON, TINY_ARGS, _fake_refvos, _records
from test_torch_train import _check_grads, _leaves, _snapshot
from test_torch_variants_train import GEO, _batch

torch.set_num_threads(2)

WORLD = 2
TIMEOUT = 120            # seconds to wait for one command's results
CONFIGS = ("CMPC_model", "CMPCv4_model")
METRICS = ("loss_main", "loss_c5", "loss_c4", "loss_cls_all", "loss_reg",
           "loss_total", "train_mIoU", "learning_rate")


class World:
    """n spawned ranks (`worker.serve`) in one gloo world through a file://
    rendezvous under `root`: world(command, **kw) -> the ranks' results,
    or `submit` now and `collect` later, so that this process works
    meanwhile.  Several commands may be in flight: each rank answers its
    commands in order, so `collect` returns the oldest one's results."""

    def __init__(self, root, n):
        ctx = mp.get_context("spawn")
        self.n = n
        self.queues = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self.answers = [[] for _ in range(n)]
        self.procs = [ctx.Process(target=worker.serve,
                                  args=(r, n, str(root / "init"),
                                        self.queues[r], self.results))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def submit(self, command, **kw):
        for q in self.queues:
            q.put((command, kw))

    def collect(self):
        """The ranks' results of the oldest command not collected, by rank,
        each awaited within TIMEOUT; a rank's error fails the test."""
        while not all(self.answers):
            rank, out = self.results.get(timeout=TIMEOUT)
            if isinstance(out, tuple) and out[0] == "error":
                pytest.fail(f"rank {rank}:\n{out[1]}")
            self.answers[rank].append(out)
        return [a.pop(0) for a in self.answers]

    def __call__(self, command, **kw):
        self.submit(command, **kw)
        return self.collect()

    def close(self):
        for q in self.queues:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 2-rank gloo world for the module."""
    ranks = World(tmp_path_factory.mktemp("rdzv"), WORLD)
    try:
        yield ranks
    finally:
        ranks.close()


def _jax_steps(name, geo, batches):
    """JAX's global-batch steps from seed 0: snapshots (with the model
    state) before and after each, and each step's metrics."""
    jcfg = jget(name, **geo)
    step_j = jtrain.make_train_step(jcfg, grad_mode="tree")
    jstate = jtrain.create_train_state(0, jcfg)

    def snap(st):
        return {**_snapshot(st),
                "model_state": jax.tree.map(np.asarray, st.model_state)}
    snaps, metrics = [snap(jstate)], []
    for batch in batches:
        jstate, m = step_j(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(snap(jstate))
    return snaps, metrics


@pytest.fixture(scope="module")
def dp_runs(world):
    """For each config, two JAX steps at the global batch; the DP first
    step from seed 0 and second from the JAX state after the first.  The
    ranks take both first steps while JAX compiles both configs' steps
    here, one run per config, each in a thread (XLA compiles without the
    GIL)."""
    batches, refs = {}, {}
    for name in CONFIGS:
        rng = np.random.default_rng(4)
        batches[name] = [_batch(tget(name, **GEO), rng) for _ in range(2)]
        world.submit("train", name=name, geo=GEO, batches=batches[name][:1])

    def reference(name):
        refs[name] = _jax_steps(name, GEO, batches[name])
    threads = [threading.Thread(target=reference, args=(name,))
               for name in CONFIGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = {name: world.collect() for name in CONFIGS}
    for name in CONFIGS:
        world.submit("train", name=name, geo=GEO,
                     batches=batches[name][1:], start=refs[name][0][1])
    return {name: {"snaps": refs[name][0], "jmetrics": refs[name][1],
                   "cfg": tget(name, **GEO),
                   "ranks": [tuple(r[0] for r in run)
                             for run in (first[name], world.collect())]}
            for name in CONFIGS}


@pytest.fixture(params=CONFIGS)
def dp_steps(request, dp_runs):
    return dp_runs[request.param]


def _assert_ranks_equal(ranks):
    for key in ("leaves", "model_state"):
        a, b = ranks[0][key], ranks[1][key]
        assert a.keys() == b.keys()
        for p in a:
            assert np.array_equal(a[p], b[p]), (key, p)


def _check_gradients(got, want):
    """Gradients by tests/test_torch_variants_train.py's rule."""
    got, want = dict(got), dict(want)
    largest = max(np.abs(w).max() for w in want.values())
    for p in [p for p in want if p[-2:] == ("spa_graph_key", "biases")]:
        for g in (got.pop(p), want.pop(p)):
            assert np.abs(g).max() <= 1e-10 * largest, p
    _check_grads(got, want)


def _check_weights(got, before_mu, after_mu, want, lr):
    for path, w in want.items():
        err = np.abs(got[path] - w)
        g = np.abs(after_mu[path] - 0.9 * before_mu[path]) / 0.1
        resolved = g >= max(1e-6, 1e-3 * g.max())
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path


@pytest.mark.parametrize("step", [0, 1])
def test_dp_step_matches_jax(dp_steps, step):
    """Metrics, gradients, weights and BN statistics of the DP step at the
    global batch against JAX's; the ranks bit-equal."""
    ranks = dp_steps["ranks"][step]
    _assert_ranks_equal(ranks)
    got = ranks[0]
    want_m = dp_steps["jmetrics"][step]
    for k in METRICS:
        if k in want_m:
            np.testing.assert_allclose(got["metrics"][k], want_m[k],
                                       rtol=1e-5, err_msg=k)
    before, after = dp_steps["snaps"][step], dp_steps["snaps"][step + 1]
    mu_prev, mu = _leaves(before["mu"]), _leaves(after["mu"])
    # Adam's first moment after the step: mu = 0.9 mu_prev + 0.1 g, with
    # mu_prev equal on both sides
    _check_gradients({p: (m - 0.9 * mu_prev[p]) / 0.1
                      for p, m in got["exp_avg"].items()},
                     {p: (m - 0.9 * mu_prev[p]) / 0.1 for p, m in mu.items()})
    _check_weights(got["leaves"], mu_prev, mu, _leaves(after["trainable"]),
                   want_m["learning_rate"])
    want_s = _leaves(after["model_state"])
    assert got["model_state"].keys() == want_s.keys()
    for path, w in want_s.items():
        np.testing.assert_allclose(got["model_state"][path], w, rtol=0,
                                   atol=1e-6, err_msg=str(path))
    assert (len(want_s) == 18) == (dp_steps["cfg"].decoder != "multiscore")


def _single_process(cfg, batches):
    """The port's own steps on the whole batches, in this process."""
    state = ttrain.create_train_state(0, cfg, device="cpu")
    step = ttrain.make_train_step(cfg)
    out = []
    for batch in batches:
        before = {p: state.optimizer.state[leaf]["exp_avg"].numpy().copy()
                  if leaf in state.optimizer.state else np.zeros(leaf.shape)
                  for p, leaf in topt.named_leaves(state.trainable)}
        m = step(state, batch)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "mu_prev": before,
                    "exp_avg": {p: state.optimizer.state[leaf]["exp_avg"]
                                .numpy().copy() for p, leaf in
                                topt.named_leaves(state.trainable)
                                if leaf in state.optimizer.state},
                    "leaves": {p: leaf.detach().numpy().copy() for p, leaf
                               in topt.named_leaves(state.trainable)},
                    "model_state": {p: v.numpy().copy() for p, v in
                                    topt.named_leaves(state.model_state)}})
    return out


@pytest.mark.parametrize("name, overrides", [
    ("CMPC_model", {}), ("CMPCv4_model", {"is_aug": True}),
    ("CMPC_model", {"grad_accum": 2})])
def test_dp_steps_match_single_process(world, name, overrides):
    """Two DP steps from seed 0 against two single-process steps on the
    whole batches, each side's second step from its own first (as
    tests/test_torch_cli.py holds two steps of a run): metrics rtol 1e-5;
    each step's gradients by the JAX bound; the weights within 1e-3 lr
    per step where every step's gradient is resolved, 2 lr per step
    elsewhere; BN statistics atol 1e-6 per step.  With grad_accum=2 the
    first step updates nothing and the second updates from the mean of
    both."""
    geo = {**GEO, **overrides}
    cfg = tget(name, **geo)
    rng = np.random.default_rng(6)
    batches = [_batch(cfg, rng) for _ in range(2)]
    world.submit("train", name=name, geo=geo, batches=batches)
    want = _single_process(cfg, batches)
    ranks = world.collect()
    lr = cfg.start_lr
    got_prev = {p: np.zeros_like(w) for p, w in want[0]["leaves"].items()}
    resolved = {p: np.ones(w.shape, bool) for p, w in
                want[0]["leaves"].items()}
    for step in range(2):
        _assert_ranks_equal([r[step] for r in ranks])
        got, ref = ranks[0][step], want[step]
        for k in METRICS:
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, err_msg=k)
        assert got["exp_avg"].keys() == ref["exp_avg"].keys()
        if ref["exp_avg"]:
            _check_gradients({p: (got["exp_avg"][p] - 0.9 * got_prev[p])
                              / 0.1 for p in got_prev},
                             {p: (ref["exp_avg"][p] - 0.9 * ref["mu_prev"][p])
                              / 0.1 for p in got_prev})
            got_prev = got["exp_avg"]
            for p, r in resolved.items():
                g = np.abs(ref["exp_avg"][p] - 0.9 * ref["mu_prev"][p]) / 0.1
                r &= g >= max(1e-6, 1e-3 * g.max())
        for path, w in ref["leaves"].items():
            err = np.abs(got["leaves"][path] - w)
            assert err[resolved[path]].max(initial=0) \
                <= (step + 1) * 1e-3 * lr, path
            assert err.max() <= (step + 1) * 2 * lr, path
        for path, w in ref["model_state"].items():
            np.testing.assert_allclose(got["model_state"][path], w, rtol=0,
                                       atol=(step + 1) * 1e-6,
                                       err_msg=str(path))
    if cfg.grad_accum == 2:
        assert not ranks[0][0]["exp_avg"] and ranks[0][1]["exp_avg"]


def _eval_batches(cfg):
    """3 global batches of 4 with box targets."""
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        b = _batch(cfg, rng)
        h, w = cfg.H, cfg.W
        target = np.zeros((4, h, w, 1), np.float32)
        for j in range(4):
            y0, x0 = rng.integers(0, h // 2, 2)
            target[j, y0:y0 + h // 2, x0:x0 + w // 2] = 1
        batches.append({"im_u8": b["im_u8"], "words": b["words"],
                        "seq_len": b["seq_len"], "target": target})
    return batches


def test_evaluate_sharded_equals_one_device(world):
    """Two ranks over 3 global batches of 4: (I, U) sums, prec@X and n
    equal to one device's, mean IoU within 1e-6 (its sum's order)."""
    geo = {**GEO, "batch_size": 4}
    cfg = tget("CMPC_model", **geo)
    batches = _eval_batches(cfg)
    world.submit("evaluate", name="CMPC_model", geo=geo, batches=batches)
    params = init_model(0, cfg, device="cpu")
    state = init_model_state(cfg, device="cpu")
    want = tev.evaluate_sharded(cfg, params, state, iter(batches),
                                device="cpu")
    # the logits stay clear of the 1e-9 threshold by 10x what the other
    # batch split moves them (float32 sums in another order), so the
    # thresholded counts must be equal
    step = tev.make_eval_step(cfg)
    margin = moved = 0.0
    for i, b in enumerate(batches):
        up = step(params, state, b)[0]
        halves = torch.cat([step(params, state, {k: v[s] for k, v in
                                                 b.items()})[0]
                            for s in (slice(0, 2), slice(2, 4))])
        moved = max(moved, float((up - halves).abs().max()))
        near = float((up - tev.SCORE_THRESHOLD).abs().min())
        margin = near if i == 0 else min(margin, near)
    assert margin > 10 * moved
    for got in world.collect():
        assert got["n"] == want["n"] == 12
        for k in ("overall_iou",) + tuple(k for k in want
                                          if k.startswith("prec@")):
            assert got[k] == want[k], k
        assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-6


def test_evaluate_sharded_over_a_group_of_one(world):
    """`mesh` a group of one rank (each rank its own): each rank scores
    every row by its rank in that group and sums over it alone, so each
    returns one device's results, bit for bit."""
    geo = {**GEO, "batch_size": 4}
    cfg = tget("CMPC_model", **geo)
    batches = _eval_batches(cfg)
    world.submit("evaluate", name="CMPC_model", geo=geo, batches=batches,
                 own_group=True)
    want = tev.evaluate_sharded(cfg, init_model(0, cfg, device="cpu"),
                                init_model_state(cfg, device="cpu"),
                                iter(batches), device="cpu")
    assert world.collect() == [want, want]


def test_preemption_agreed_across_ranks(world):
    """Rank 1 is sent SIGTERM during its 2nd read: both ranks finish that
    step and stop before the next (no rank waits alone in an
    all-reduce)."""
    ranks = world("preempt", name="CMPC_model", geo=GEO, max_iter=5,
                  victim=1, at=2)
    assert ranks[0] == ranks[1] == (2, 2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_distributed_two_ranks(world, tmp_path):
    """`cli.main -m train -distributed -mesh 2 -bs 2` as torchrun starts 2
    ranks (each reads 1 of the 2 samples): rank 0 alone logs and writes
    the snapshots, and its step-0 record matches the single-process
    command line's at -bs 2 within rtol 1e-5."""
    root = str(tmp_path)
    data = _fake_refvos(root)

    def argv(tag, extra=()):
        return ["-m", "train", "-d", "refvos", "-n", "CMPC_model",
                "-im_dir", data["im_dir"], "-mask_dir", data["mask_dir"],
                "-meta", data["meta"], "-vocab", data["vocab"],
                "-emb_dir", root, "-bs", "2", "-st", "2", "-s", "1",
                "-ckpt_dir", os.path.join(root, f"ckpt_{tag}"),
                "-log_dir", os.path.join(root, f"logs_{tag}"),
                "-device", "cpu"] + COMMON[:-2] + TINY_ARGS + list(extra)
    world.submit("cli", argvs=[argv(f"dp{r}", ["-distributed", "-mesh",
                                               "2"]) for r in range(WORLD)],
                 port=_free_port(), init_file=os.path.join(root, "init"))
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(argv("one"))
    assert world.collect() == [2, 2]
    assert sorted(os.listdir(os.path.join(root, "ckpt_dp0"))) == ["1", "2"]
    assert not os.path.exists(os.path.join(root, "ckpt_dp1"))
    assert not os.path.exists(os.path.join(root, "logs_dp1"))
    got = _records(os.path.join(root, "logs_dp0"))
    want = _records(os.path.join(root, "logs_one"))
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0]
    for k in sorted(set(want[0]) - {"step", "ts", "step_time_s"}):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   err_msg=k)
