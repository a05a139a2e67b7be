"""Tensor parallelism and ZeRO-sharded Adam over a (data x model) layout
of the port (``parallel/mesh.py``, ``train/optimizer.py::ZeroAdam``,
``train/trainer.py``, ``train/checkpoint.py``) against the JAX package's
rule and global-batch step and the port's own single process, in float32
at TINY on the CPU.

Four spawned gloo ranks (``tests/torch_parallel_worker.py``) make one
world for the module, laid out as data = 2 x model = 2 at `min_dim` 16;
each result is awaited with a timeout, so a hung rank fails its test.

- The rule: the leaves the port's `tp_shardings` engages equal, by path,
  those JAX's `tp_leaf_rule` engages on a (4, 2) mesh of the 8 virtual
  CPU devices: at TINY and `min_dim` 16 for the flagship (53),
  CMPCv4_model (64) and CMPCv4_model with conv5 (94, the port's OIHW
  backbone kernels split on dim 0); at full width and `min_dim` 512, read
  from shapes (JAX's `jax.eval_shape`, the port's meta tensors), the
  flagship's 51, 49,962,000 of its 76,055,608 parameters.
- Two steps of the flagship and of CMPCv4_model at global batch 4, the
  first from seed 0 and the second from JAX's state after the first,
  against JAX's `make_train_step(grad_mode="tree")` under
  tests/test_torch_variants_train.py's bounds: losses rtol 1e-5,
  gradients (Adam's first moment) 1e-4 of the leaf's largest entry,
  weights 1e-3 lr where resolved and 2 lr elsewhere, BN statistics atol
  1e-6.  The replay: one process's Adam fed the ranks' reduced gradient
  gives their weights and moments bit for bit.  The storage: each rank
  holds one segment of ceil(N / 4) entries (CMPCv4_model's N pads by 1,
  and the pad stays 0), its moments the same size, each engaged leaf as
  1/2 of it along its dim, the rest whole; the 2 ranks of a model index
  hold bit-equal shards.
- grad_accum=2 under the layout against grad_accum=2 in one process.
- Checkpoints: one saved under the layout restores in one process with
  every leaf equal, and one saved between grad_accum=2's micro-steps
  with the world's mean accumulator; restored onto the layout, the next
  step is bit-equal to the unbroken run's; one process's checkpoint
  restores onto the layout.
- `train_loop` of a laid-out state: rank 0 alone writes the snapshot,
  which restores in one process bit-equal.
- `compute_gradients` of a laid-out state needs the gathered tree.
- `evaluate_sharded` raises over the layout's world and, over the
  layout, equals one device.
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import train_state_from_jax
from cmpc_refseg_torch.models.model import (init_model, init_model_state)
from cmpc_refseg_torch.parallel.mesh import Mesh, tp_shardings
from cmpc_refseg_torch.train import checkpoint as tckpt
from cmpc_refseg_torch.train import evaluator as tev
from cmpc_refseg_torch.train import optimizer as topt
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.parallel import mesh as jmesh
from cmpc_refseg_tpu.train import trainer as jtrain
from test_torch_parallel import (METRICS, World, _check_gradients,
                                 _check_weights, _eval_batches, _jax_steps)
from test_torch_train import TINY, _leaves
from test_torch_variants_train import GEO, _batch

torch.set_num_threads(2)

WORLD, SHAPE, MIN_DIM = 4, (2, 2), 16
CONFIGS = ("CMPC_model", "CMPCv4_model")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ranks = World(tmp_path_factory.mktemp("rdzv"), WORLD)
    try:
        yield ranks
    finally:
        ranks.close()


def _jax_engaged(tree, min_dim):
    mesh = jmesh.make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    rule = jmesh.tp_leaf_rule(mesh, min_dim=min_dim)
    return {p for p, leaf in topt.named_leaves(tree) if rule(leaf).spec != P()}


def _port_engaged(trainable, min_dim):
    dims = tp_shardings(trainable, Mesh(SHAPE), min_dim=min_dim)
    return {p for p, d in topt.named_leaves(dims) if d is not None}


def _unravelled(jstate):
    return jstate.unravel(jstate.trainable)


@pytest.mark.parametrize("name, conv5, count", [
    ("CMPC_model", False, 53), ("CMPCv4_model", False, 64),
    ("CMPCv4_model", True, 94)])
def test_rule_engages_jax_leaves(name, conv5, count):
    geo = {**TINY, "conv5": conv5}
    want = _jax_engaged(jax.eval_shape(lambda: _unravelled(
        jtrain.create_train_state(0, jget(name, **geo)))), MIN_DIM)
    cfg = tget(name, **geo)
    trainable, _ = topt.partition_params(init_model(0, cfg, device="meta"),
                                         cfg)
    got = _port_engaged(trainable, MIN_DIM)
    assert got == want and len(got) == count
    dims = dict(topt.named_leaves(tp_shardings(trainable, Mesh(SHAPE),
                                               min_dim=MIN_DIM)))
    for path, leaf in topt.named_leaves(trainable):
        if path in got and path[0] == "backbone":
            assert dims[path] == 0 and leaf.dim() == 4


def test_rule_engages_51_leaves_at_full_width():
    """The production rule on the flagship's widths, from shapes alone."""
    want = _jax_engaged(jax.eval_shape(lambda: _unravelled(
        jtrain.create_train_state(0, jget("CMPC_model")))), 512)
    cfg = tget("CMPC_model")
    trainable, _ = topt.partition_params(init_model(0, cfg, device="meta"),
                                         cfg)
    got = _port_engaged(trainable, 512)
    assert got == want and len(got) == 51
    sizes = {p: leaf.numel() for p, leaf in topt.named_leaves(trainable)}
    assert sum(sizes.values()) == 76_055_608
    assert sum(sizes[p] for p in got) == 49_962_000


@pytest.fixture(scope="module")
def tp_runs(world):
    """For each config, two JAX steps at the global batch; the layout's
    first step from seed 0 and its second from JAX's state after the
    first.  The ranks take both first steps while JAX compiles both
    configs' steps here, each in a thread (XLA compiles without the
    GIL)."""
    batches, refs = {}, {}
    for name in CONFIGS:
        rng = np.random.default_rng(4)
        cfg = tget(name, **GEO)
        batches[name] = [_batch(cfg, rng) for _ in range(2)]
        world.submit("tp_train", name=name, geo=GEO,
                     batches=batches[name][:1])

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
        world.submit("tp_train", name=name, geo=GEO,
                     batches=batches[name][1:], start=refs[name][0][1])
    return {name: {"snaps": refs[name][0], "jmetrics": refs[name][1],
                   "cfg": tget(name, **GEO),
                   "ranks": [[r[0] for r in run]
                             for run in (first[name], world.collect())]}
            for name in CONFIGS}


@pytest.fixture(params=CONFIGS)
def tp_steps(request, tp_runs):
    return tp_runs[request.param]


@pytest.mark.parametrize("step", [0, 1])
def test_tp_step_matches_jax(tp_steps, step):
    """Metrics (every rank's the same), gradients, weights and BN
    statistics of the layout's step at the global batch against JAX's."""
    ranks = tp_steps["ranks"][step]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    got = ranks[0]
    want_m = tp_steps["jmetrics"][step]
    for k in METRICS:
        if k in want_m:
            np.testing.assert_allclose(got["metrics"][k], want_m[k],
                                       rtol=1e-5, err_msg=k)
    before, after = tp_steps["snaps"][step], tp_steps["snaps"][step + 1]
    mu_prev, mu = _leaves(before["mu"]), _leaves(after["mu"])
    _check_gradients({p: (m - 0.9 * mu_prev[p]) / 0.1
                      for p, m in got["exp_avg"].items()},
                     {p: (m - 0.9 * mu_prev[p]) / 0.1 for p, m in mu.items()})
    _check_weights(got["leaves"], mu_prev, mu, _leaves(after["trainable"]),
                   want_m["learning_rate"])
    want_s = _leaves(after["model_state"])
    for r in ranks:
        assert r["model_state"].keys() == want_s.keys()
        for path, w in want_s.items():
            np.testing.assert_allclose(r["model_state"][path], w, rtol=0,
                                       atol=1e-6, err_msg=str(path))


def _start_state(tp_steps, step):
    cfg = tp_steps["cfg"]
    if step == 0:
        return ttrain.create_train_state(0, cfg, device="cpu")
    s = tp_steps["snaps"][1]
    return train_state_from_jax(s["trainable"], s["frozen"], s["mu"],
                                s["nu"], s["count"], cfg,
                                model_state=s["model_state"], device="cpu")


@pytest.mark.parametrize("step", [0, 1])
def test_tp_replay_is_bit_equal(tp_steps, step):
    """One process's Adam, from the step's starting state and fed the
    gradient the ranks reduced, gives their weights, moments and count."""
    got = tp_steps["ranks"][step][0]
    state = _start_state(tp_steps, step)
    leaves = list(topt.named_leaves(state.trainable))
    for path, leaf in leaves:
        leaf.grad = torch.from_numpy(got["grad"][path])
    for group in state.optimizer.param_groups:
        group["lr"] = got["metrics"]["learning_rate"]
    state.optimizer.step()
    for path, leaf in leaves:
        adam = state.optimizer.state[leaf]
        assert np.array_equal(leaf.detach().numpy(), got["leaves"][path]), \
            path
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(adam[key].numpy(), got[key][path]), \
                (key, path)
        assert float(adam["step"]) == got["adam_step"] == step + 1


def test_tp_storage(tp_steps):
    """Each rank's storage after each step: its segment, its moments, its
    shards (the slices of the full weights at its model index) and the
    groups it sits in; the ranks of a model index bit-equal."""
    cfg = tp_steps["cfg"]
    trainable, _ = topt.partition_params(init_model(0, cfg, device="meta"),
                                         cfg)
    numel = sum(t.numel() for _, t in topt.named_leaves(trainable))
    dims = dict(topt.named_leaves(tp_shardings(trainable, Mesh(SHAPE),
                                               min_dim=MIN_DIM)))
    segment = -(-numel // WORLD)
    assert (segment * WORLD - numel > 0) == (cfg.variant == "CMPCv4_model")
    for ranks in tp_steps["ranks"]:
        weights = ranks[0]["leaves"]
        for r, rec in enumerate(ranks):
            assert rec["groups"] == {"data": [r % 2, r % 2 + 2],
                                     "model": [r - r % 2, r - r % 2 + 1]}
            assert rec["segment"] == segment
            assert rec["moment_sizes"] == [segment, segment]
            assert rec["pad"] == [0, 0, 0]
            for path, stored in rec["stored"].items():
                dim, w = dims[path], weights[path]
                if dim is None:
                    assert np.array_equal(stored, w), path
                    continue
                n = w.shape[dim] // 2
                want = np.take(w, range((r % 2) * n, (r % 2 + 1) * n),
                               axis=dim)
                assert stored.shape[dim] * 2 == w.shape[dim], path
                assert np.array_equal(stored, want), path
            other = ranks[(r + 2) % WORLD]["stored"]
            assert all(np.array_equal(v, other[p])
                       for p, v in rec["stored"].items())


def test_grad_accum_matches_one_process(world):
    """Two micro-steps of grad_accum=2 under the layout against two in one
    process: the first updates nothing, the second from the mean of both;
    metrics rtol 1e-5, the update's gradient by the JAX bound, weights
    1e-3 lr where resolved and 2 lr elsewhere."""
    geo = {**GEO, "grad_accum": 2}
    cfg = tget("CMPC_model", **geo)
    rng = np.random.default_rng(6)
    batches = [_batch(cfg, rng) for _ in range(2)]
    ranks = world("tp_train", name="CMPC_model", geo=geo, batches=batches)
    state = ttrain.create_train_state(0, cfg, device="cpu")
    step = ttrain.make_train_step(cfg)
    first, second = ranks[0]
    assert first["grad"] is None and first["adam_step"] == 0
    for got, batch in zip(ranks[0], batches):
        metrics = step(state, batch)
        for k in METRICS:
            np.testing.assert_allclose(got["metrics"][k], float(metrics[k]),
                                       rtol=1e-5, err_msg=k)
    want_mu = {p: state.optimizer.state[leaf]["exp_avg"].numpy()
               for p, leaf in topt.named_leaves(state.trainable)}
    _check_gradients({p: m / 0.1 for p, m in second["exp_avg"].items()},
                     {p: m / 0.1 for p, m in want_mu.items()})
    zero = {p: np.zeros_like(m) for p, m in want_mu.items()}
    _check_weights(second["leaves"], zero, want_mu,
                   {p: leaf.detach().numpy() for p, leaf in
                    topt.named_leaves(state.trainable)}, cfg.start_lr)


def test_layout_checkpoint_holds_the_accumulator(world, tmp_path):
    """A checkpoint saved under the layout between the two micro-steps of
    grad_accum=2 holds the world's mean of the ranks' accumulators:
    restored in one process, one process's accumulator after the same
    micro-step, by the gradient bound."""
    geo = {**GEO, "grad_accum": 2}
    cfg = tget("CMPC_model", **geo)
    batch = _batch(cfg, np.random.default_rng(9))
    world("tp_train", name="CMPC_model", geo=geo, batches=[batch],
          save=str(tmp_path))
    state = ttrain.create_train_state(0, cfg, device="cpu")
    ttrain.make_train_step(cfg)(state, batch)
    got = tckpt.restore_checkpoint(
        str(tmp_path), ttrain.create_train_state(0, cfg, device="cpu"))
    assert got.step == 1
    paths = [p for p, _ in topt.named_leaves(state.trainable)]
    _check_gradients(
        {p: a.numpy() / 0.1 for p, a in zip(paths, got.accum)},
        {p: a.numpy() / 0.1 for p, a in zip(paths, state.accum)})


def test_compute_gradients_needs_the_gathered_tree():
    """A state under a layout stores shards, so `compute_gradients` of it
    without the gathered tree raises; with it, the loss is one process's
    bit for bit (a layout of one process gathers nothing)."""
    cfg = tget("CMPC_model", **GEO)
    batch = _batch(cfg, np.random.default_rng(10))
    state = ttrain.shard_train_state(
        ttrain.create_train_state(0, cfg, device="cpu"), Mesh((1, 1)))
    with pytest.raises(ValueError, match="stores shards"):
        ttrain.compute_gradients(state, cfg, batch)
    loss, _ = ttrain.compute_gradients(
        state, cfg, batch, trainable=state.zero.gather(state.trainable))
    want, _ = ttrain.compute_gradients(
        ttrain.create_train_state(0, cfg, device="cpu"), cfg, batch)
    assert torch.equal(loss, want)


@pytest.fixture(scope="module")
def tp_checkpoints(world, tmp_path_factory):
    """Two flagship steps under the layout unbroken; the first again,
    saved, and the second from that checkpoint restored onto the layout;
    one process's first step saved and restored onto the layout."""
    root = tmp_path_factory.mktemp("tp_ckpt")
    cfg = tget("CMPC_model", **GEO)
    rng = np.random.default_rng(8)
    batches = [_batch(cfg, rng) for _ in range(2)]
    kw = {"name": "CMPC_model", "geo": GEO}
    unbroken = world("tp_train", batches=batches, **kw)
    saved = world("tp_train", batches=batches[:1], save=str(root / "tp"),
                  **kw)
    resumed = world("tp_train", batches=batches[1:], restore=str(root / "tp"),
                    **kw)
    single = ttrain.create_train_state(0, cfg, device="cpu")
    ttrain.make_train_step(cfg)(single, batches[0])
    tckpt.save_checkpoint(str(root / "one"), single, single.step)
    onto = world("tp_train", batches=[], restore=str(root / "one"),
                 report_start=True, **kw)
    return {"cfg": cfg, "root": root, "unbroken": unbroken, "saved": saved,
            "resumed": resumed, "single": single, "onto": onto}


def _assert_records_equal(got, want):
    for key in ("leaves", "exp_avg", "exp_avg_sq", "model_state", "stored"):
        assert got[key].keys() == want[key].keys(), key
        for p, w in want[key].items():
            assert np.array_equal(got[key][p], w), (key, p)
    assert got["adam_step"] == want["adam_step"]


def test_layout_checkpoint_restores_in_one_process(tp_checkpoints):
    cfg = tp_checkpoints["cfg"]
    want = tp_checkpoints["saved"][0][0]
    state = tckpt.restore_checkpoint(
        str(tp_checkpoints["root"] / "tp"),
        ttrain.create_train_state(0, cfg, device="cpu"))
    assert state.step == 1
    for path, leaf in topt.named_leaves(state.trainable):
        adam = state.optimizer.state[leaf]
        assert np.array_equal(leaf.detach().numpy(), want["leaves"][path])
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(adam[key].numpy(), want[key][path])
        assert float(adam["step"]) == want["adam_step"] == 1
    for path, v in topt.named_leaves(state.model_state):
        assert np.array_equal(v.numpy(), want["model_state"][path])
    fresh = ttrain.create_train_state(0, cfg, device="cpu")
    for (p, a), (_, b) in zip(topt.named_leaves(state.frozen_f32),
                              topt.named_leaves(fresh.frozen_f32)):
        assert torch.equal(a, b), p


def test_restored_layout_step_equals_the_unbroken_run(tp_checkpoints):
    """The step after a restore onto the layout, bit for bit the unbroken
    run's second step on every rank (its storage included)."""
    for r in range(WORLD):
        got = tp_checkpoints["resumed"][r][0]
        want = tp_checkpoints["unbroken"][r][1]
        assert got["metrics"] == want["metrics"]
        if r == 0:
            _assert_records_equal(got, want)
        else:
            for p, w in want["stored"].items():
                assert np.array_equal(got["stored"][p], w), (r, p)


def test_one_process_checkpoint_restores_onto_the_layout(tp_checkpoints):
    single = tp_checkpoints["single"]
    got = tp_checkpoints["onto"][0][0]
    assert got["step"] == 1 and got["adam_step"] == 1
    for path, leaf in topt.named_leaves(single.trainable):
        adam = single.optimizer.state[leaf]
        assert np.array_equal(got["leaves"][path], leaf.detach().numpy())
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(got[key][path], adam[key].numpy())
    for path, v in topt.named_leaves(single.model_state):
        assert np.array_equal(got["model_state"][path], v.numpy())
    assert tp_checkpoints["onto"][3][0]["stored"].keys() \
        == got["leaves"].keys()


def test_train_loop_under_the_layout(world, tmp_path):
    """`train_loop` of a laid-out state, 2 iterations at global batch 4:
    rank 0 alone writes the snapshot, the one-process file, which restores
    in one process bit-equal to the ranks' consolidated state."""
    cfg = tget("CMPC_model", **GEO)
    ranks = world("tp_loop", name="CMPC_model", geo=GEO, max_iter=2,
                  checkpoint_dir=str(tmp_path))
    assert [r["step"] for r in ranks] == [2] * WORLD
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2"]
    state = tckpt.restore_checkpoint(
        str(tmp_path), ttrain.create_train_state(0, cfg, device="cpu"))
    want = ranks[0]
    for path, leaf in topt.named_leaves(state.trainable):
        adam = state.optimizer.state[leaf]
        assert np.array_equal(leaf.detach().numpy(), want["leaves"][path])
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(adam[key].numpy(), want[key][path])
    assert state.step == 2 and want["adam_step"] == 2


def test_evaluate_sharded_needs_the_data_group(world):
    """Over the world of a (2, 2) layout `evaluate_sharded` raises; over
    the layout (its data group) every rank returns one device's results:
    I, U, prec@X and n equal, mean IoU within 1e-6."""
    geo = {**GEO, "batch_size": 4}
    cfg = tget("CMPC_model", **geo)
    batches = _eval_batches(cfg)
    want = tev.evaluate_sharded(cfg, init_model(0, cfg, device="cpu"),
                                init_model_state(cfg, device="cpu"),
                                iter(batches), device="cpu")
    for raised, got in world("tp_evaluate", name="CMPC_model", geo=geo,
                             batches=batches):
        assert raised is not None and "holds rows twice" in raised
        assert got["n"] == want["n"] == 12
        for k in ("overall_iou",) + tuple(k for k in want
                                          if k.startswith("prec@")):
            assert got[k] == want[k], k
        assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-6
