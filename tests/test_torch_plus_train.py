"""Train steps of CMPCv6_plus_model and CMPCv5_plus_model, and the conv5 and
grad_accum options, against the JAX package's
`make_train_step(grad_mode="tree")`, in float32 on the CPU at TINY.

- Both configs: the port's first step from seed 0 and its second from the
  JAX state after the first (`train_state_from_jax`), at batch 4 with
  is_aug=False, held by tests/test_torch_variants_train.py's checks
  (losses rtol 1e-5, gradients from Adam's first moment, weights after
  Adam, the BN moving statistics; v5+'s gradients also within 4x the
  port's own float32 noise per entry, `NOISE_HELD`); v5+ with
  `preprocess_true_boxes` labels of seeded boxes, its 'loss_bbox' too.
- conv5=True (CMPC_model, batch 2): the res3-5 conv kernels train.  One
  and two steps: every gradient leaf by leaf under
  tests/test_torch_train.py's `_check_grads` (the backbone's HWIO kernels
  transposed to the port's OIHW; the key biases, whose exact gradient is
  0, at 1e-10 of the largest gradient on each side), the weights after
  Adam as tests/test_torch_variants_train.py holds them (within 1e-3 lr
  where the gradient is resolved: |g| >= 1e-6 and >= 1e-3 of its leaf's
  largest entry, as Adam's second step moves a weight by lr times a ratio
  of gradients; 2 lr elsewhere).
- grad_accum=2 (optax MultiSteps): the update equals the one Adam update
  on the mean gradient; the lr advances once per update; a save and
  resume mid-accumulation takes the same next micro-step bit for bit;
  CMPC_model's update from two batch-2 micro-batches equals the batch-4
  update at the gradient (no op couples the samples in that config); and
  two micro-steps against JAX's, the second also from JAX's state after
  the first (its accumulator converted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_variants_train as vtrain
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import train_state_from_jax
from cmpc_refseg_torch.data.anchors import (DEFAULT_ANCHORS,
                                            preprocess_true_boxes)
from cmpc_refseg_torch.train import checkpoint as tck
from cmpc_refseg_torch.train import optimizer as topt
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.train import trainer as jtrain
from test_torch_checkpoint import _assert_bit_equal
from test_torch_train import TINY, _batch, _check_grads, _leaves, _snapshot
from tools.jax_checkpoint_to_torch import _jax_train_trees

torch.set_num_threads(2)

PLUS = ("CMPCv6_plus_model", "CMPCv5_plus_model")
# held also within 4x the port's own float32 noise per gradient entry, as
# tests/test_torch_variants_train.py holds the HSV config: the v5 configs'
# 'softmax_mask' graph reaches `spa_graph_trans2/biases` only through the
# word softmax (a shift of every node cancels in the node softmax).  At
# this file's batches (seed 4) one entry of levels/c5's reads 1.49e-7 from
# JAX's at the second step, in every run, against the file's bound of
# 1.19e-7 and 1.67x the port's noise there; batches from seeds 0-3 and 5-7
# keep every entry within 0.17-0.98 of the file's bound at both steps
NOISE_HELD = {"CMPCv5_plus_model"}


def _box_labels(cfg, rng):
    """The v5+ train script's labels of one seeded corner-format box per
    sample: 'label_bbox' [B, S, S, A, 5] and 'true_bbox' [B, 1, 4]
    (float32)."""
    labels = []
    for _ in range(cfg.batch_size):
        x1, y1 = rng.uniform(0, cfg.W / 2), rng.uniform(0, cfg.H / 2)
        box = [x1, y1, x1 + rng.uniform(4, cfg.W / 2),
               y1 + rng.uniform(4, cfg.H / 2)]
        labels.append(preprocess_true_boxes(
            [box], cfg.H, DEFAULT_ANCHORS[:cfg.num_anchors]))
    return {"label_bbox": np.stack([a for a, _ in labels]).astype(np.float32),
            "true_bbox": np.stack([b for _, b in labels]).astype(np.float32)}


def _check_grads_keys_zero(got, want):
    """`_check_grads`, with the gated exchanges' key biases, whose exact
    gradient is 0, held as tests/test_torch_variants_train.py holds them:
    each side's at most 1e-10 of the largest gradient."""
    got, want = dict(got), dict(want)
    largest = max(np.abs(w).max() for w in want.values())
    zero = [p for p in want if p[-2:] == ("spa_graph_key", "biases")]
    assert zero
    for p in zero:
        for g in (got.pop(p), want.pop(p)):
            assert np.abs(g).max() <= 1e-10 * largest, p
    _check_grads(got, want)


def _jax_snap(st):
    return {**_snapshot(st),
            "model_state": jax.tree.map(np.asarray, st.model_state)}


@pytest.fixture(scope="module", params=PLUS)
def plus_steps(request):
    """tests/test_torch_variants_train.py's `two_steps` for the two configs
    (batches with box labels for v5+)."""
    return _plus_steps(request.param)


def _plus_steps(name, seed=4):
    """Both sides' two steps of config `name` on batches drawn from
    `seed`."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = jget(name, **vtrain.GEO), tget(name, **vtrain.GEO)
    batches = []
    for _ in range(2):
        batch = vtrain._batch(tcfg, rng)
        if tcfg.bbox_head:
            batch.update(_box_labels(tcfg, rng))
        batches.append(batch)
    step_j = jtrain.make_train_step(jcfg, grad_mode="tree")
    jstate = jtrain.create_train_state(0, jcfg)
    snaps, jmetrics = [_jax_snap(jstate)], []
    for batch in batches:
        jstate, m = step_j(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
        snaps.append(_jax_snap(jstate))
    step_t = ttrain.make_train_step(tcfg)
    s = snaps[1]
    makers = (lambda: ttrain.create_train_state(0, tcfg, device="cpu"),
              lambda: train_state_from_jax(
                  s["trainable"], s["frozen"], s["mu"], s["nu"], s["count"],
                  tcfg, model_state=s["model_state"], device="cpu"))
    states = tuple(make() for make in makers)
    tmetrics = [step_t(state, batch) for state, batch in zip(states, batches)]
    noise = [vtrain._gradient_noise(tcfg, make, batch, state)
             for make, batch, state in zip(makers, batches, states)
             ] if name in NOISE_HELD else None
    return {"snaps": snaps, "jmetrics": jmetrics, "states": states,
            "tmetrics": tmetrics, "cfg": tcfg, "noise": noise}


@pytest.mark.parametrize("step", [0, 1])
def test_plus_train_step_metrics_match_jax(plus_steps, step):
    got, want = plus_steps["tmetrics"][step], plus_steps["jmetrics"][step]
    keys = vtrain.METRICS + (("loss_bbox",) if plus_steps["cfg"].bbox_head
                             else ())
    assert set(got) == set(want) and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
def test_plus_train_step_gradients_match_jax(plus_steps, step):
    vtrain.test_train_step_gradients_match_jax(plus_steps, step)
    leaves = dict(topt.named_leaves(plus_steps["states"][step].trainable))
    cfg = plus_steps["cfg"]
    assert (("bbox", "conv", "DW") in leaves) == cfg.bbox_head
    assert (("levels", "c5", "sent_mutan", "lang_trans", "DW") in leaves) \
        == cfg.sent_fusion


@pytest.mark.parametrize("step", [0, 1])
def test_plus_train_step_params_match_jax(plus_steps, step):
    vtrain.test_train_step_params_match_jax(plus_steps, step)


@pytest.mark.parametrize("step", [0, 1])
def test_plus_train_step_bn_statistics_match_jax(plus_steps, step):
    vtrain.test_train_step_bn_statistics_match_jax(plus_steps, step)


# ---------------------------------------------------------------------------
# conv5
# ---------------------------------------------------------------------------

def _oihw(tree):
    """A JAX snapshot tree's leaves by path, the backbone's HWIO kernels
    transposed to the port's OIHW."""
    return {p: np.transpose(v, (3, 2, 0, 1)) if p[0] == "backbone" else v
            for p, v in _leaves(tree).items()}


@pytest.fixture(scope="module")
def conv5_steps():
    geo = {**TINY, "conv5": True}
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    rng = np.random.default_rng(4)
    batches = [_batch(tcfg, rng) for _ in range(2)]
    step_j = jtrain.make_train_step(jcfg, grad_mode="tree")
    jstate = jtrain.create_train_state(0, jcfg)
    snaps, jmetrics = [_snapshot(jstate)], []
    for batch in batches:
        jstate, m = step_j(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
        snaps.append(_snapshot(jstate))
    s = snaps[1]
    states = (ttrain.create_train_state(0, tcfg, device="cpu"),
              train_state_from_jax(s["trainable"], s["frozen"], s["mu"],
                                   s["nu"], s["count"], tcfg, device="cpu"))
    step_t = ttrain.make_train_step(tcfg)
    tmetrics = [step_t(st, b) for st, b in zip(states, batches)]
    return snaps, jmetrics, states, tmetrics


@pytest.mark.parametrize("step", [0, 1])
def test_conv5_train_step_matches_jax(conv5_steps, step):
    snaps, jmetrics, states, tmetrics = conv5_steps
    for k in ("loss_main", "loss_cls_all", "loss_reg", "loss_total",
              "learning_rate"):
        np.testing.assert_allclose(float(tmetrics[step][k]),
                                   jmetrics[step][k], rtol=1e-5, err_msg=k)
    state = states[step]
    mu_prev, mu = _oihw(snaps[step]["mu"]), _oihw(snaps[step + 1]["mu"])
    got = {p: (state.optimizer.state[leaf]["exp_avg"].numpy()
               - 0.9 * mu_prev[p]) / 0.1
           for p, leaf in topt.named_leaves(state.trainable)}
    backbone = [p for p in got if p[0] == "backbone"]
    assert backbone and all(p[1][:4] in ("res3", "res4", "res5")
                            and p[-1] == "w" for p in backbone)
    _check_grads_keys_zero(got, {p: (mu[p] - 0.9 * mu_prev[p]) / 0.1
                                 for p in mu})
    lr = jmetrics[step]["learning_rate"]
    want = _oihw(snaps[step + 1]["trainable"])
    for path, leaf in topt.named_leaves(state.trainable):
        err = np.abs(leaf.detach().numpy() - want[path])
        g = np.abs(mu[path] - 0.9 * mu_prev[path]) / 0.1
        resolved = g >= max(1e-6, 1e-3 * g.max())
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path
    # the forward reads the trained kernels: no frozen copy of them
    params = state.params()
    for path, leaf in topt.named_leaves(state.trainable["backbone"]):
        node = params["backbone"]
        for k in path:
            node = node[k]
        assert node is leaf
    assert all("w" not in unit for name, block in
               state.frozen["backbone"].items() if name[:4] in
               ("res3", "res4", "res5") for unit in block.values())


def test_conv5_checkpoint_saves_the_trained_kernels(conv5_steps, tmp_path):
    state = conv5_steps[2][0]
    tck.save_checkpoint(str(tmp_path), state, 1)
    restored = tck.restore_checkpoint(str(tmp_path), ttrain.create_train_state(
        1, state.cfg, device="cpu"))
    _assert_bit_equal(restored, state)
    saved = tck.torch.load(str(tmp_path / "1" / tck.FILE), weights_only=True)
    key = ("backbone", "res4a", "branch2b", "w")
    assert key in saved["trainable"] and not any(
        k[:2] == ("backbone", "res4a") and k[-1] == "w"
        for k in saved["frozen"])
    assert torch.equal(saved["trainable"][key],
                       state.trainable["backbone"]["res4a"]["branch2b"]["w"])


# ---------------------------------------------------------------------------
# grad_accum
# ---------------------------------------------------------------------------

def _accum_cfg(**kw):
    return tget("CMPC_model", **{**TINY, "grad_accum": 2, **kw})


def _weights(state):
    return {p: v.detach().clone() for p, v in topt.named_leaves(
        state.trainable)}


def test_grad_accum_update_equals_mean_gradient_update():
    """Two micro-steps: no update after the first; after the second, the
    one Adam update that the mean of their gradients makes (computed here
    with grad_accum=1 from the same weights)."""
    cfg = _accum_cfg()
    rng = np.random.default_rng(7)
    b1, b2 = _batch(cfg, rng), _batch(cfg, rng)
    state = ttrain.create_train_state(0, cfg, device="cpu")
    step = ttrain.make_train_step(cfg)
    w0 = _weights(state)
    step(state, b1)
    assert all(torch.equal(v, w0[p]) for p, v in _weights(state).items())
    assert not state.optimizer.state
    step(state, b2)
    one = cfg.replace(grad_accum=1)
    ref = ttrain.create_train_state(0, one, device="cpu")
    grads = []
    for b in (b1, b2):
        ttrain.compute_gradients(ref, one, b)
        grads.append([p.grad.clone() for _, p in
                      topt.named_leaves(ref.trainable)])
    for (_, p), g1, g2 in zip(topt.named_leaves(ref.trainable), *grads):
        p.grad = g1 + (g2 - g1) / 2
    for group in ref.optimizer.param_groups:
        group["lr"] = topt.polynomial_lr(cfg)(0)
    ref.optimizer.step()
    for (path, got), (_, want) in zip(topt.named_leaves(state.trainable),
                                      topt.named_leaves(ref.trainable)):
        assert torch.equal(got, want), path
    assert all(a.eq(0).all() for a in state.accum)


def test_grad_accum_lr_advances_per_update():
    """Five micro-steps at grad_accum=2: the logged lr is the schedule at
    the update count (step // 2), Adam's count advances once per update,
    and the weights move only on the second micro-step of each pair."""
    cfg = _accum_cfg(lr_decay_step=4)
    rng = np.random.default_rng(8)
    state = ttrain.create_train_state(0, cfg, device="cpu")
    step = ttrain.make_train_step(cfg)
    sched = topt.polynomial_lr(cfg)
    lrs = []
    for it in range(5):
        before = _weights(state)
        metrics = step(state, _batch(cfg, rng))
        lrs.append(metrics["learning_rate"])
        moved = any(not torch.equal(v, before[p])
                    for p, v in _weights(state).items())
        assert moved == (it % 2 == 1) and state.step == it + 1
        counts = {float(st["step"]) for st in state.optimizer.state.values()}
        assert counts == ({float((it + 1) // 2)} if it else set())
    assert lrs == [sched(it // 2) for it in range(5)]
    assert lrs[0] == lrs[1] > lrs[2] == lrs[3] > lrs[4]


def test_grad_accum_resume_mid_accumulation(tmp_path):
    """A checkpoint after the first micro-step holds the accumulator; the
    state restored from it (into a state from another seed) takes the
    second micro-step as the saved state does, bit for bit."""
    cfg = _accum_cfg()
    rng = np.random.default_rng(9)
    b1, b2 = _batch(cfg, rng), _batch(cfg, rng)
    step = ttrain.make_train_step(cfg)
    state = ttrain.create_train_state(0, cfg, device="cpu")
    step(state, b1)
    tck.save_checkpoint(str(tmp_path), state, 1)
    restored = tck.restore_checkpoint(str(tmp_path), ttrain.create_train_state(
        1, cfg, device="cpu"))
    assert restored.step == 1 and len(restored.accum) == len(state.accum)
    assert all(torch.equal(a, b) for a, b in zip(restored.accum, state.accum))
    assert any(a.abs().max() > 0 for a in restored.accum)
    for st in (state, restored):
        step(st, b2)
    _assert_bit_equal(restored, state)
    assert restored.step == 2


def test_grad_accum_micro_batches_equal_the_full_batch():
    """CMPC_model's mean gradient over two batch-2 micro-batches equals
    the batch-4 gradient (float32 sums over other batch splits: within
    1e-4 of each leaf's largest entry plus 1e-11 of the largest gradient;
    the key biases, exactly 0, held at 1e-10 of the largest)."""
    cfg4 = tget("CMPC_model", **{**TINY, "batch_size": 4})
    batch = vtrain._batch(cfg4, np.random.default_rng(10))
    cfg = _accum_cfg()
    state = ttrain.create_train_state(0, cfg, device="cpu")
    step = ttrain.make_train_step(cfg)
    for half in (slice(0, 2), slice(2, 4)):
        step(state, {k: v[half] for k, v in batch.items()})
    got = {p: v.grad.numpy() for p, v in topt.named_leaves(state.trainable)}
    full = ttrain.create_train_state(0, cfg4, device="cpu")
    ttrain.compute_gradients(full, cfg4, batch)
    want = {p: v.grad.numpy() for p, v in topt.named_leaves(full.trainable)}
    _check_grads_keys_zero(got, want)


@pytest.fixture(scope="module")
def accum_jax():
    """Two JAX micro-steps at grad_accum=2 and the JAX state between them;
    the port's two micro-steps from seed 0, and its second from the JAX
    state after the first (accumulator and micro-step count converted as
    tools/jax_checkpoint_to_torch.py converts them)."""
    jcfg, tcfg = jget("CMPC_model", **TINY, grad_accum=2), _accum_cfg()
    rng = np.random.default_rng(11)
    batches = [_batch(tcfg, rng) for _ in range(2)]
    step_j = jtrain.make_train_step(jcfg, grad_mode="tree")
    jstate = jtrain.create_train_state(0, jcfg)
    jmetrics, mids = [], []
    for batch in batches:
        jstate, m = step_j(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
        if not mids:
            trees, extra = _jax_train_trees(
                jstate, lambda f: jax.tree.map(np.asarray,
                                               jstate.unravel(f)))
            mids.append(train_state_from_jax(*trees, tcfg, device="cpu",
                                             **extra))
    adam = jstate.opt_state.inner_opt_state[0]
    want = {"mu": _leaves(jax.tree.map(np.asarray, jstate.unravel(adam.mu))),
            "trainable": _leaves(jax.tree.map(
                np.asarray, jstate.unravel(jstate.trainable))),
            "count": int(adam.count), "step": int(jstate.step)}
    step_t = ttrain.make_train_step(tcfg)
    state = ttrain.create_train_state(0, tcfg, device="cpu")
    tmetrics = [step_t(state, b) for b in batches]
    resumed = mids[0]
    assert resumed.step == 1 and resumed.accum is not None
    step_t(resumed, batches[1])
    return want, jmetrics, tmetrics, (state, resumed)


@pytest.mark.parametrize("route", ["from_seed", "from_jax_mid_accumulation"])
def test_grad_accum_matches_jax(accum_jax, route):
    """After JAX's second micro-step (its MultiSteps update): the port's
    metrics (rtol 1e-5), its Adam count and step, the mean gradient from
    Adam's first moment (mu = 0.1 g after one update) under `_check_grads`,
    and the weights within 1e-3 lr where the gradient is resolved."""
    want, jmetrics, tmetrics, states = accum_jax
    state = states[route == "from_jax_mid_accumulation"]
    if route == "from_seed":
        for got, ref in zip(tmetrics, jmetrics):
            for k in ("loss_total", "learning_rate"):
                np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-5,
                                           err_msg=k)
    assert state.step == want["step"] == 2 and want["count"] == 1
    assert {float(st["step"]) for st in state.optimizer.state.values()} \
        == {1.0}
    got = {p: state.optimizer.state[leaf]["exp_avg"].numpy() / 0.1
           for p, leaf in topt.named_leaves(state.trainable)}
    _check_grads_keys_zero(got, {p: m / 0.1 for p, m in want["mu"].items()})
    lr = jmetrics[1]["learning_rate"]
    for path, leaf in topt.named_leaves(state.trainable):
        err = np.abs(leaf.detach().numpy() - want["trainable"][path])
        resolved = np.abs(want["mu"][path]) / 0.1 >= 1e-6
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path


def _v5plus_readings(seeds=range(8)):
    """Per batch seed and step of CMPCv5_plus_model: the largest gradient
    error against JAX over the file's bound (the key biases aside) and,
    for entries beyond it, (leaf, count, largest error, bound, largest
    error over the port's own float32 noise).  The readings behind
    `NOISE_HELD`: `PYTHONPATH=. python tests/test_torch_plus_train.py`."""
    for seed in seeds:
        d = _plus_steps("CMPCv5_plus_model", seed)
        for step, state in enumerate(d["states"]):
            before, after = d["snaps"][step], d["snaps"][step + 1]
            mu_prev, mu = _leaves(before["mu"]), _leaves(after["mu"])
            want = {p: (mu[p] - 0.9 * mu_prev[p]) / 0.1 for p in mu}
            largest = max(np.abs(w).max() for w in want.values())
            worst, beyond = 0.0, []
            for path, leaf in topt.named_leaves(state.trainable):
                if path[-2:] == ("spa_graph_key", "biases"):
                    continue
                w = want[path]
                got = (state.optimizer.state[leaf]["exp_avg"].numpy()
                       - 0.9 * mu_prev[path]) / 0.1
                bound = 1e-4 * np.abs(w).max() + 1e-11 * largest
                err = np.abs(got - w)
                worst = max(worst, float((err / bound).max()))
                out = err > bound
                if out.any():
                    beyond.append(("/".join(path), int(out.sum()),
                                   float(err[out].max()), float(bound),
                                   float((err[out] / d["noise"][step][path][
                                       out]).max())))
            print(f"seed {seed} step {step}: largest error / bound "
                  f"{worst:.3f}; beyond it: {beyond}", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _v5plus_readings()
