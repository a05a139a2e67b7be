"""The port's video train step, its checkpoint and the A2D evaluation
against the JAX package's, in float32 on the CPU, at tests/test_video.py's
TINY geometry (8-frame clips, frames (0, 2, 4, 6, 7) sampled).

- One train step of CMPC_video_mm_tgraph_allvec from seed 0 against
  `cli_video.make_video_train_step`, and a second from the JAX state after
  its first, by tests/test_torch_train.py's bounds: metrics (JAX's keys:
  the losses and the learning rate, no train_mIoU) rtol 1e-5; gradients
  (Adam's first moment) within 1e-4 of the leaf's largest entry + 1e-11
  of the largest gradient (the conv biases whose exact gradient is 0,
  `ZERO_GRAD`: each side's noise at most 1e-10 of it); weights within
  1e-3 lr where |g| >= 1e-6 and >= 1e-3 of the leaf's largest (the v4 /
  v6 rule of tests/test_torch_variants_train.py: at step 2, an entry whose
  gradient is a small share of its leaf's moves by Adam's ratio of two
  noisy moments), 2 lr elsewhere.  The port's batch is uint8
  (`prepare_video_batch_u8`, its sampled frames gathered on the device),
  JAX's the float32 `prepare_video_batch`.  A checkpoint of the stepped
  state restores bit-equal.
- `evaluate_a2d` on the same weights and samples (one with an empty
  mask): IoUs within 1e-5, prec@X and n equal.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch import cli_video as tcv
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import params_from_jax, train_state_from_jax
from cmpc_refseg_torch.train import checkpoint as tck
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_torch.train.optimizer import named_leaves
from cmpc_refseg_tpu import cli_video as jcv
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.video import init_video_model

torch.set_num_threads(2)

NAME = "CMPC_video_mm_tgraph_allvec"
TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=2,
            res4_blocks=2, num_frames=8, sampled_frames=(0, 2, 4, 6, 7),
            lr_decay_step=1000)
# conv biases whose exact gradient is 0: each shifts every logit of a
# softmax by the same amount (the action attention over the pixels, the
# frame adjacency's keys, the temporal context's frame keys, the gated
# exchanges' pixel keys), so each side
# leaves float32 noise there, held at 1e-10 of the largest gradient
# (tests/test_torch_checkpoint.py's key biases)
ZERO_GRAD = ("tg_vtrans", "tg_key", "ctx_trans", "spa_graph_key")


def _exact_zero(path) -> bool:
    return path[-1] == "biases" and path[-2] in ZERO_GRAD


def _collated(cfg, rng, lens=(2, 5)):
    """Seeded A2D samples as the reader collates them: uint8 RGB frames
    [B, num_frames, H, W, 3], the center frame's mask, back-padded words
    and their lengths."""
    b = len(lens)
    words = np.zeros((b, cfg.num_steps), np.int32)
    for i, n in enumerate(lens):
        words[i, :n] = rng.integers(3, cfg.vocab_size, n)
    return {"frames": rng.integers(0, 256, (b, cfg.num_frames, cfg.H, cfg.W,
                                            3), dtype=np.uint8),
            "mask_batch": rng.random((b, cfg.H, cfg.W)) > 0.7,
            "text_batch": words, "seq_length": np.asarray(lens, np.int32)}


def _snapshot(jstate):
    tree = jax.tree.map(np.asarray, jstate.unravel(jstate.trainable))
    adam = jstate.opt_state[0]
    return {"trainable": tree,
            "frozen": jax.tree.map(np.asarray, jstate.frozen),
            "mu": jax.tree.map(np.asarray, jstate.unravel(adam.mu)),
            "nu": jax.tree.map(np.asarray, jstate.unravel(adam.nu)),
            "count": int(adam.count)}


@pytest.fixture(scope="module")
def two_steps():
    """Two JAX video steps from seed 0; the port's first step from seed 0,
    its second from the JAX state after the first."""
    rng = np.random.default_rng(4)
    jcfg, tcfg = jget(NAME, **TINY), tget(NAME, **TINY)
    collated = [_collated(tcfg, rng) for _ in range(2)]
    step_j = jcv.make_video_train_step(jcfg)
    jstate = jcv.create_video_train_state(0, jcfg)
    snaps, jmetrics = [_snapshot(jstate)], []
    for c in collated:
        jstate, m = step_j(jstate, {k: jnp.asarray(v) for k, v in
                                    jcv.prepare_video_batch(c, jcfg).items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
        snaps.append(_snapshot(jstate))
    step_t = ttrain.make_train_step(tcfg)
    first = ttrain.create_train_state(0, tcfg, device="cpu")
    s = snaps[1]
    second = train_state_from_jax(s["trainable"], s["frozen"], s["mu"],
                                  s["nu"], s["count"], tcfg, device="cpu")
    tmetrics = [step_t(state, tcv.prepare_video_batch_u8(c))
                for state, c in zip((first, second), collated)]
    return {"snaps": snaps, "jmetrics": jmetrics, "states": (first, second),
            "tmetrics": tmetrics, "cfg": tcfg}


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_metrics_match_jax(two_steps, step):
    got, want = two_steps["tmetrics"][step], two_steps["jmetrics"][step]
    assert set(got) == set(want) and "train_mIoU" not in got
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_gradients_match_jax(two_steps, step):
    """Adam's first moment: (mu - 0.9 mu_prev) / 0.1 is the gradient each
    side used (conv biases doubled)."""
    state = two_steps["states"][step]
    mu_prev = dict(named_leaves(two_steps["snaps"][step]["mu"]))
    mu = dict(named_leaves(two_steps["snaps"][step + 1]["mu"]))
    want = {p: (mu[p] - 0.9 * mu_prev[p]) / 0.1 for p in mu}
    floor = 1e-11 * max(np.abs(w).max() for w in want.values())
    got = {p: (state.optimizer.state[leaf]["exp_avg"].numpy()
               - 0.9 * mu_prev[p]) / 0.1
           for p, leaf in named_leaves(state.trainable)}
    assert set(got) == set(want) and len(want) > 200
    assert sum(map(_exact_zero, want)) == 15
    for path, w in want.items():
        if _exact_zero(path):
            assert max(np.abs(got[path]).max(), np.abs(w).max()) \
                <= 1e-10 * floor / 1e-11, path
            continue
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + floor,
                                   err_msg=str(path))


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_params_match_jax(two_steps, step):
    lr = two_steps["jmetrics"][step]["learning_rate"]
    snaps = two_steps["snaps"]
    before = dict(named_leaves(snaps[step]["trainable"]))
    want = dict(named_leaves(snaps[step + 1]["trainable"]))
    mu_prev = dict(named_leaves(snaps[step]["mu"]))
    mu = dict(named_leaves(snaps[step + 1]["mu"]))
    moved = 0
    for path, leaf in named_leaves(two_steps["states"][step].trainable):
        err = np.abs(leaf.detach().numpy() - want[path])
        g = np.abs(mu[path] - 0.9 * mu_prev[path]) / 0.1
        resolved = (g >= 1e-6) & (g >= 1e-3 * g.max())
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path
        moved += int((np.abs(want[path] - before[path]) > 0.5 * lr).sum())
    assert moved > 1000
    assert two_steps["states"][step].step == step + 1


def test_video_checkpoint_round_trip(two_steps, tmp_path):
    """The stepped video state saved and restored into a state from
    another seed: weights, Adam's moments and count, the frozen backbone
    and the step bit-equal."""
    state, cfg = two_steps["states"][0], two_steps["cfg"]
    tck.save_checkpoint(str(tmp_path), state, 1)
    other = tck.restore_checkpoint(str(tmp_path), ttrain.create_train_state(
        5, cfg, device="cpu"))
    assert other.step == 1 and other.model_state == {}
    for (path, a), (_, b) in zip(named_leaves(state.trainable),
                                 named_leaves(other.trainable)):
        assert torch.equal(a, b), path
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[a][k],
                               other.optimizer.state[b][k]), (path, k)
    for (path, a), (_, b) in zip(named_leaves(state.frozen_f32),
                                 named_leaves(other.frozen_f32)):
        assert torch.equal(a, b), path


def test_evaluate_a2d_matches_jax():
    """Four batch-1 samples, the third with an empty mask (skipped before
    the forward); the final score's bias raised on both sides so that the
    masks cover part of the frame."""
    jcfg, tcfg = jget(NAME, **TINY), tget(NAME, **TINY)
    jp, js = init_video_model(0, jcfg)
    jp["scores"]["score"]["biases"] = np.full((1,), 1.5, np.float32)
    rng = np.random.default_rng(6)
    samples = []
    for i in range(4):
        c = _collated(tcfg, rng, lens=(3 + i,))
        if i == 2:
            c["mask_batch"][:] = False
        samples.append(tcv.prepare_video_batch(c))
    want = jcv.evaluate_a2d(jcfg, jp, js, [
        {k: jnp.asarray(v) for k, v in s.items()} for s in samples])
    got = tcv.evaluate_a2d(tcfg, params_from_jax(jp, tcfg, device="cpu"), {},
                           samples, device="cpu")
    assert set(got) == set(want) and got["n"] == want["n"] == 3
    assert 0.05 < want["mean_iou"] < 0.95
    for k in ("mean_iou", "overall_iou"):
        assert abs(got[k] - want[k]) <= 1e-5, k
    for k in want:
        if k.startswith("prec@"):
            assert got[k] == want[k], k
