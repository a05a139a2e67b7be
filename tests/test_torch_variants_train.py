"""One and two train steps of CMPCv4_model (the ASPP decoder with live BN),
CMPCv6_model (the decoder and the self-gated exchange),
CMPCv5_BiLSTM_HSV_model (the BiLSTM encoder, tanh laterals and the HSV
channels, whose mutan K = v_emb_dim + 11 is padded) and CMPCv4_BERT_model
(BERT features in the batch, bert_dim=16, vw_emb_dim=8) against the JAX
package's `make_train_step(grad_mode="tree")`, in float32 on the CPU.

As tests/test_torch_train.py does for the flagship: the port's first step
from seed 0, its second from the JAX state after the first (loaded with
`train_state_from_jax`, the BN moving statistics included), both against
JAX's steps on the same batches, under that file's bounds (PERF.md §2):
losses rtol 1e-5; gradients (Adam's first moment) within 1e-4 of each
leaf's largest entry plus 1e-11 of the largest gradient; weights within 2
lr everywhere and within 1e-3 lr where the gradient is resolved; the BN
moving statistics after each step within atol 1e-6.  Both packages run
with is_aug=False: the port's brightness draw comes from a torch
generator and cannot match JAX's PRNG (its law is tested in
tests/test_torch_train.py).

Where the live BN makes this model less well conditioned than the
flagship, the file says so and holds the stronger or the fitting check:

- The batch is 4.  The image-level BN normalizes [B, 1, 1, 256] values
  from a 12-channel pooled vector over the batch alone: at batch 2 a few
  of its channels have a batch variance of 1e-11 to 1e-13, so the sign of
  x - mean, which decides the ReLU after it, is float32 noise there (the
  two packages' features differ by ~1e-6), and with it up to 11% of every
  gradient upstream.
- The gated exchanges' key biases (`spa_graph_key/biases`) have the exact
  gradient 0 (a shift of every key cancels in the softmax over the nodes):
  each side's is held at most 1e-10 of the largest gradient, rather than
  matched to the other side's noise (6e-8 for CMPCv6_model at batch 2).
- A gradient is resolved at |g| >= 1e-6, as there, and at |g| >= 1e-3 of
  its leaf's largest entry: the BN leaves agree to ~2e-6 of their largest
  entry, and Adam's second step moves a weight by lr times a ratio of
  gradients, which an error of that size shifts by 1e-3 only where |g| is
  1e-3 of the largest.
- The largest gradient is a text-encoder leaf's; the BERT config has none
  (~175 against ~1e4), so its key biases are held at 1e-4 of their unit
  kernel's largest gradient instead (float32 leaves them at ~1e-6 of it
  in every config).
- HSV's V channel (0-255) dominates the spatial features of
  CMPCv5_BiLSTM_HSV_model: four noise images of one law have nearly the
  same V, which the image-level BN pools over the batch alone, and the
  port's own gradients then move by up to 2.5% of a leaf under a 1e-7
  relative change of the weights.  Its images differ in brightness, as
  real ones do (x0.3 to x1), and each gradient entry is held within the
  file's bound or within 4x the port's own float32 noise there
  (`_gradient_noise`: the change under two draws of a 1e-7 relative
  weight perturbation; ~3e-6 of a leaf's largest entry outside a few
  near-cancelling biases, so the file's bound holds nearly every entry);
  a weight is resolved where |g| is also 1e3 times that noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import train_state_from_jax
from cmpc_refseg_torch.train import optimizer as topt
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.train import trainer as jtrain
from test_torch_train import TINY, _check_grads, _leaves, _snapshot

torch.set_num_threads(2)

GEO = {**TINY, "is_aug": False, "batch_size": 4, "bert_dim": 16}
OVERRIDES = {"CMPCv4_BERT_model": {"vw_emb_dim": 8}}
# configs whose gradients are also held against the port's own float32
# noise (`_gradient_noise`)
NOISE_HELD = {"CMPCv5_BiLSTM_HSV_model"}
HSV_BRIGHTNESS = np.array([0.3, 0.55, 0.8, 1.0])
METRICS = ("loss_main", "loss_c5", "loss_c4", "loss_cls_all", "loss_reg",
           "loss_total", "train_mIoU", "learning_rate")


def _batch(cfg, rng):
    """tests/test_torch_train.py's batch at batch 4: expressions of 2, 5, 6
    and 1 words; for the 'bert' encoder, N(0, 1) features [4, T, bert_dim]
    with those lengths' masks in place of the tokens."""
    b = cfg.batch_size
    lens = np.array([2, 5, 6, 1], np.int32)
    if cfg.text_encoder == "bert":
        text = {"words_feat": rng.standard_normal(
                    (b, cfg.num_steps, cfg.bert_dim)).astype(np.float32),
                "sequence_mask": (np.arange(cfg.num_steps)[None]
                                  < lens[:, None]).astype(np.float32)}
    else:
        words = np.zeros((b, cfg.num_steps), np.int32)
        for i, n in enumerate(lens):
            words[i, :n] = rng.integers(3, cfg.vocab_size, n)
        text = {"words": words, "seq_len": lens}
    im = rng.integers(0, 256, (b, cfg.H, cfg.W, 3), dtype=np.uint8)
    if cfg.hsv:
        # samples of different brightness, as real images are: four noise
        # images of one law have nearly the same V channel (~191 on
        # average), which the image-level BN pools over the batch alone
        im = (im * HSV_BRIGHTNESS[:, None, None, None]).astype(np.uint8)
    return {"im_u8": im,
            "target_u8": (rng.random((b, cfg.H, cfg.W, 1)) > 0.7
                          ).astype(np.uint8), **text}


@pytest.fixture(scope="module", params=["CMPCv4_model", "CMPCv6_model",
                                        "CMPCv5_BiLSTM_HSV_model",
                                        "CMPCv4_BERT_model"])
def two_steps(request):
    """Two JAX steps from seed 0 (snapshots with the model state before and
    after each), the port's first step from seed 0 and its second from the
    JAX state after the first."""
    name = request.param
    rng = np.random.default_rng(4)
    geo = {**GEO, **OVERRIDES.get(name, {})}
    jcfg, tcfg = jget(name, **geo), tget(name, **geo)
    batches = [_batch(tcfg, rng) for _ in range(2)]
    step_j = jtrain.make_train_step(jcfg, grad_mode="tree")
    jstate = jtrain.create_train_state(0, jcfg)

    def snap(st):
        return {**_snapshot(st),
                "model_state": jax.tree.map(np.asarray, st.model_state)}

    snaps, jmetrics = [snap(jstate)], []
    for batch in batches:
        jstate, m = step_j(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
        snaps.append(snap(jstate))
    step_t = ttrain.make_train_step(tcfg)
    first = ttrain.create_train_state(0, tcfg, device="cpu")
    s = snaps[1]
    second = train_state_from_jax(s["trainable"], s["frozen"], s["mu"],
                                  s["nu"], s["count"], tcfg,
                                  model_state=s["model_state"], device="cpu")
    states = (lambda: ttrain.create_train_state(0, tcfg, device="cpu"),
              lambda: train_state_from_jax(
                  s["trainable"], s["frozen"], s["mu"], s["nu"], s["count"],
                  tcfg, model_state=s["model_state"], device="cpu"))
    tmetrics = [step_t(state, batch)
                for state, batch in zip((first, second), batches)]
    noise = [_gradient_noise(tcfg, make, batch, state)
             for make, batch, state in zip(states, batches, (first, second))
             ] if name in NOISE_HELD else None
    return {"snaps": snaps, "jmetrics": jmetrics, "states": (first, second),
            "tmetrics": tmetrics, "cfg": tcfg, "noise": noise}


def _gradient_noise(cfg, make_state, batch, stepped):
    """The port's float32 noise in each gradient entry at a state: the
    largest change over two draws of the weights times (1 + 1e-7 N(0, 1)),
    a perturbation at float32's rounding, which moves no gradient that
    the float32 sums resolve.  `stepped` is the state after its step from
    those weights, whose .grad holds the unperturbed gradient."""
    def grads(seed):
        st = make_state()
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for _, leaf in topt.named_leaves(st.trainable):
                leaf.mul_(1 + 1e-7 * torch.randn(leaf.shape, generator=gen))
        ttrain.compute_gradients(st, cfg, batch)
        return {p: leaf.grad.numpy() for p, leaf in
                topt.named_leaves(st.trainable)}
    base = {p: leaf.grad.numpy() for p, leaf in
            topt.named_leaves(stepped.trainable)}
    others = [grads(seed) for seed in (1, 2)]
    return {p: np.maximum(*(np.abs(o[p] - g) for o in others))
            for p, g in base.items()}


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_metrics_match_jax(two_steps, step):
    got, want = two_steps["tmetrics"][step], two_steps["jmetrics"][step]
    assert set(METRICS) <= set(got)
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_gradients_match_jax(two_steps, step):
    """Adam's first moment after the step gives the gradient each side
    used (mu = b1 mu_prev + 0.1 g); the ASPP's and decoder's kernels, BN's
    gamma and beta and the logits conv's doubled bias among them."""
    state = two_steps["states"][step]
    before, after = two_steps["snaps"][step], two_steps["snaps"][step + 1]
    mu_prev, mu = _leaves(before["mu"]), _leaves(after["mu"])
    got = {path: (state.optimizer.state[leaf]["exp_avg"].numpy()
                  - 0.9 * mu_prev[path]) / 0.1
           for path, leaf in topt.named_leaves(state.trainable)}
    assert {("aspp", "conv_3x3_1", "gamma"),
            ("decoder", "conv_1x1", "biases")} <= set(got)
    assert ("scores", "score", "DW") not in got
    want = {p: (mu[p] - 0.9 * mu_prev[p]) / 0.1 for p in mu}
    zero = {p for p in want if p[-2:] == ("spa_graph_key", "biases")}
    cfg = two_steps["cfg"]
    assert len(zero) == 4 * (2 if cfg.exchange_self_gate else 1)
    largest = max(np.abs(w).max() for w in want.values())
    for p in zero:
        # the text encoder's leaves set the largest gradient; without them
        # (BERT) the unit's kernel sets the scale, at the per-leaf 1e-4
        bound = 1e-4 * np.abs(want[p[:-1] + ("DW",)]).max() \
            if cfg.text_encoder == "bert" else 1e-10 * largest
        for g in (got.pop(p), want.pop(p)):
            assert np.abs(g).max() <= bound, p
    noise = two_steps["noise"]
    if noise is None:
        _check_grads(got, want)
        return
    # the file's bound, or 4x the port's own float32 noise in the entry
    floor = 1e-11 * largest
    for path, w in want.items():
        atol = np.maximum(1e-4 * np.abs(w).max() + floor,
                          4 * noise[step][path])
        assert (np.abs(got[path] - w) <= atol).all(), path


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_params_match_jax(two_steps, step):
    """The updated weights: within 1e-3 of lr of JAX's where the gradient
    is resolved (|g| >= 1e-6 and >= 1e-3 of the leaf's largest gradient),
    within 2 lr elsewhere."""
    lr = two_steps["jmetrics"][step]["learning_rate"]
    snaps = two_steps["snaps"]
    want = _leaves(snaps[step + 1]["trainable"])
    mu_prev, mu = _leaves(snaps[step]["mu"]), _leaves(snaps[step + 1]["mu"])
    for path, leaf in topt.named_leaves(two_steps["states"][step].trainable):
        err = np.abs(leaf.detach().numpy() - want[path])
        g = np.abs(mu[path] - 0.9 * mu_prev[path]) / 0.1
        resolved = g >= max(1e-6, 1e-3 * g.max())
        if two_steps["noise"] is not None:
            # and the entry 1e3 times above the port's float32 noise there
            resolved &= g >= 1e3 * two_steps["noise"][step][path]
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_bn_statistics_match_jax(two_steps, step):
    """The BN moving statistics the step leaves in the state, against the
    JAX state's, and moved from the ones before the step."""
    got = _leaves(two_steps["states"][step].model_state)
    want = _leaves(two_steps["snaps"][step + 1]["model_state"])
    before = _leaves(two_steps["snaps"][step]["model_state"])
    assert got.keys() == want.keys() and len(want) == 18
    for path, w in want.items():
        assert not got[path].requires_grad, path
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=str(path))
        assert not np.array_equal(w, before[path]), path
