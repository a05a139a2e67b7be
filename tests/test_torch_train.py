"""The port's train step against the JAX package's, in float32 on the CPU.

- The mutan autograd function against the JAX training kernels in
  interpret mode (`_mutan_fwd_with_residual`, `mutan_bwd_fused`,
  `_mutan_dw_call`) at the shapes of tests/test_pallas.py's
  TestFusedMutanBackward: rtol and atol 3e-5 in float32, where the
  residual is f32 (both sides compute the same f32 sums in other orders),
  0.05 in bf16, where it is bf16 (the documented precision of the bf16 v);
  a float64 gradcheck.
- The recompute functions of ``ops/autograd.py`` against autograd of the
  plain route on the same inputs (1e-5 relative: the forward runs the
  kernels' plain versions, the backward recomputes the plain route).
- The optimizer pieces and losses against JAX's.
- One train step at TINY (tests/test_train.py's geometry) from the same
  seed against `make_train_step(cfg, grad_mode="tree")`, and a second step
  from the JAX state after its first, loaded with `train_state_from_jax`.
  Losses, train_mIoU and the learning rate within rtol 1e-5; gradients,
  read through Adam's first moment (mu = 0.1 g), within 1e-4 of the leaf's
  largest entry plus a float32 noise floor of 1e-11 of the largest gradient
  of all leaves; updated params within 1e-3 of lr where the gradient is
  resolved (|g| >= 1e-6, a hundred times Adam's eps) and within Adam's
  bound of 2 lr elsewhere.  Adam moves a weight by lr * g / (|g| + 1e-8),
  so a gradient near 1e-8, where float32 noise decides, is the sensitive
  case: the gated exchange's key bias has the exact gradient 0 (a shift of
  every key cancels in the softmax over the nodes), and both sides leave
  noise of ~1e-8 there.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.api import build_trainer
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import train_state_from_jax
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.ops import autograd, kernels
from cmpc_refseg_torch.ops import losses as tlosses
from cmpc_refseg_torch.train import optimizer as topt
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_torch.train.checkpoint import latest_step
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.ops import losses as jlosses
from cmpc_refseg_tpu.ops import pallas_kernels as pk
from cmpc_refseg_tpu.train import optimizer as jopt
from cmpc_refseg_tpu.train import trainer as jtrain

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=2,
            res4_blocks=2, lr_decay_step=1000)
REPO = Path(__file__).resolve().parent.parent
METRICS = ("loss_main", "loss_c5", "loss_c4", "loss_c3", "loss_cls_all",
           "loss_reg", "loss_total", "train_mIoU", "learning_rate")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _leaves(tree):
    return dict(topt.named_leaves(tree))


# ---------------------------------------------------------------------------
# mutan: forward with residual, dz backward, dW
# ---------------------------------------------------------------------------

def _mutan_case(rng, b, n, k=24, c=16, nh=5):
    x = rng.standard_normal((b, n, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, nh * c))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((nh * c,))).astype(np.float32)
    lang = rng.standard_normal((b, nh * c)).astype(np.float32)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    return x, w, bias, lang, g, nh


def _jax_mutan(x, w, bias, lang, g, nh, res_dtype):
    """JAX's training forward and fused backward in interpret mode; v with
    each head's lane padding cut away -> (out, v, (dx, dw, db, dlang))."""
    args = [jnp.asarray(a) for a in (x, w, bias, lang)]
    out, v_res = pk._mutan_fwd_with_residual(*args, num_heads=nh,
                                             interpret=True,
                                             res_dtype=res_dtype)
    grads = pk.mutan_bwd_fused(*args, jnp.asarray(g), v_res, num_heads=nh,
                               interpret=True)
    c = w.shape[1] // nh
    v = np.asarray(v_res.astype(jnp.float32))
    v = v.reshape(v.shape[0], nh, -1)[:, :, :c].reshape(v.shape[0], nh * c)
    return np.asarray(out), v, [np.asarray(a) for a in grads]


@pytest.mark.parametrize("b,n", [(2, 64), (3, 128), (3, 25), (1, 41)])
def test_mutan_function_matches_jax_f32_residual(rng, b, n):
    """MutanFunction forward (out, the residual v) and backward (dx, dW, db,
    dlang) on the CPU, where v is f32, against the JAX kernels with an f32
    residual; B=3/N=128 spans several of the JAX kernel's row tiles, and at
    N = 25 and 41 (no multiple of 8 divides them) its tile is the whole
    sample, as the CUDA dz kernel's rows cross samples there."""
    _check_mutan_f32_residual(*_mutan_case(rng, b, n))


def test_mutan_backward_zero_lang_sample_matches_jax(rng):
    """A sample whose lang row is zero: its rows' y = tanh(0) = 0, so sq = 0
    <= 1e-12 and the l2norm's vjp takes its g * r branch, in the port's
    dz pass and in JAX's fused backward alike."""
    x, w, bias, lang, g, nh = _mutan_case(rng, 3, 25)
    lang[1] = 0.0
    _check_mutan_f32_residual(x, w, bias, lang, g, nh)


def _check_mutan_f32_residual(x, w, bias, lang, g, nh):
    b, n = x.shape[:2]
    want_out, want_v, want = _jax_mutan(x, w, bias, lang, g, nh, jnp.float32)
    k, c = x.shape[2], g.shape[2]
    xt, wt, bt, lt = (_t(a).requires_grad_() for a in
                      (x.reshape(b * n, k), w, bias, lang))
    out = autograd.mutan(xt, wt, bt, lt, heads=nh, rows_per_sample=n)
    _, v = kernels.mutan_fwd_residual(xt.detach(), wt.detach(), bt.detach(),
                                      lt.detach(), heads=nh,
                                      rows_per_sample=n)
    tol = dict(rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(out.detach().numpy().reshape(b, n, c),
                               want_out, **tol)
    np.testing.assert_allclose(v.numpy(), want_v, **tol)
    out.backward(_t(g.reshape(b * n, c)))
    got = (xt.grad.numpy().reshape(b, n, k), wt.grad.numpy(), bt.grad.numpy(),
           lt.grad.numpy())
    for a, w_, name in zip(got, want, ("dx", "dw", "db", "dlang")):
        np.testing.assert_allclose(a, w_, err_msg=name, **tol)


def test_mutan_function_bf16_matches_jax(rng):
    """bf16 inputs, so a bf16 residual (the card's dtype): MutanFunction
    against JAX's bf16 training kernels within 0.05; v within one bf16 ulp
    (2^-8 below 1), both sides rounding the same f32 tanh."""
    b, n = 2, 64
    x, w, bias, lang, g, nh = _mutan_case(rng, b, n)
    x = _t(x).to(torch.bfloat16).float().numpy()
    g = _t(g).to(torch.bfloat16).float().numpy()
    args = [jnp.asarray(x, jnp.bfloat16)] + [jnp.asarray(a) for a in
                                             (w, bias, lang)]
    _, v_res = pk._mutan_fwd_with_residual(*args, num_heads=nh,
                                           interpret=True)
    want = pk.mutan_bwd_fused(*args, jnp.asarray(g, jnp.bfloat16), v_res,
                              num_heads=nh, interpret=True)
    k, c = x.shape[2], g.shape[2]
    xt = _t(x.reshape(b * n, k), torch.bfloat16).requires_grad_()
    wt, bt, lt = (_t(a).requires_grad_() for a in (w, bias, lang))
    out = autograd.mutan(xt, wt, bt, lt, heads=nh, rows_per_sample=n)
    _, v = kernels.mutan_fwd_residual(xt.detach(), wt.detach().to(
        torch.bfloat16), bt.detach(), lt.detach(), heads=nh,
        rows_per_sample=n)
    assert out.dtype == v.dtype == torch.bfloat16
    want_v = np.asarray(v_res.astype(jnp.float32)).reshape(b * n, nh, -1)
    np.testing.assert_allclose(v.float().numpy(),
                               want_v[:, :, :c].reshape(b * n, nh * c),
                               rtol=0, atol=2 ** -8)
    out.backward(_t(g.reshape(b * n, c), torch.bfloat16))
    got = (xt.grad.float().numpy().reshape(b, n, k), wt.grad.numpy(),
           bt.grad.numpy(), lt.grad.numpy())
    for a, w_, name in zip(got, want, ("dx", "dw", "db", "dlang")):
        np.testing.assert_allclose(a, np.asarray(w_.astype(jnp.float32)),
                                   rtol=0.05, atol=0.05, err_msg=name)


@pytest.mark.parametrize("k,c", [(24, 16), (40, 8)])
def test_mutan_dw_matches_pallas_interpret(rng, k, c):
    """dW = x^T @ dz against `_mutan_dw_call` (interpret), which takes x and
    dz lane-padded to 128 and returns [heads, Kp, Cp]."""
    m, nh = 128, 5
    x = rng.standard_normal((m, k)).astype(np.float32)
    dz = rng.standard_normal((m, nh * c)).astype(np.float32)
    kp, cp = 128, 128
    x_p = np.zeros((m, kp), np.float32)
    x_p[:, :k] = x
    dz_p = np.zeros((m, nh, cp), np.float32)
    dz_p[:, :, :c] = dz.reshape(m, nh, c)
    want = np.asarray(pk._mutan_dw_call(
        jnp.asarray(x_p), jnp.asarray(dz_p.reshape(m, nh * cp)), kp=kp, cp=cp,
        num_heads=nh, bsz_n=m, interpret=True))
    want = want.transpose(1, 0, 2)[:k, :, :c].reshape(k, nh * c)
    got = kernels.mutan_dw(_t(x), _t(dz)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_mutan_function_gradcheck():
    """torch.autograd.gradcheck of MutanFunction in float64 on a few rows
    (two samples of three rows)."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, dtype=torch.float64)
                * scale).requires_grad_()

    x, w = rnd(6, 8), rnd(8, 5 * 4, scale=0.3)
    bias, lang = rnd(5 * 4, scale=0.1), rnd(2, 5 * 4)
    assert torch.autograd.gradcheck(
        lambda *a: autograd.mutan(*a, heads=5, rows_per_sample=3),
        (x, w, bias, lang))


# ---------------------------------------------------------------------------
# recompute functions: kernel forward, plain-route vjp
# ---------------------------------------------------------------------------

def _grads(fn, inputs):
    """Outputs of fn(*inputs) and the gradients of a fixed random
    projection of them with respect to `inputs`."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    g = torch.Generator().manual_seed(1)
    loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs)
    return outs, torch.autograd.grad(loss, inputs)


def _op_case(name):
    """(recompute function, its plain route, inputs) of one head op."""
    g = torch.Generator().manual_seed(2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).requires_grad_()

    b, n, c, t, groups = 2, 12, 8, 5, 3
    mask = torch.ones(groups * b, 1, t)
    mask[:, :, 3:] = 0
    if name == "spa_affinity_grouped":
        kw = dict(scale=3.0, l2n=False, masked=True)
        inputs = [rnd(groups * b, n, c), *[rnd(c, c, scale=0.3)
                                           for _ in range(groups)],
                  *[rnd(c, scale=0.1) for _ in range(groups)],
                  rnd(groups * b, t, c), rnd(groups * b, 1, t)]
        return ((lambda x, *r: autograd.spa_affinity_grouped(
                    x, r[:groups], r[groups:2 * groups], *r[2 * groups:],
                    mask, **kw)),
                (lambda x, *r: kernels.spa_affinity_grouped_plain(
                    x, torch.stack(r[:groups]),
                    torch.stack(r[groups:2 * groups]), *r[2 * groups:], mask,
                    **kw)), inputs)
    if name == "graph_conv":
        gps = [{"update": {"DW": rnd(1, 1, c, c, scale=0.3),
                           "biases": rnd(c, scale=0.1)},
                "feat_ln": {"gamma": rnd(c), "beta": rnd(c)},
                "update_ln": {"gamma": rnd(c), "beta": rnd(c)}}
               for _ in range(groups)]
        leaves = [v for gp in gps for v in _leaves(gp).values()]
        aff = [torch.softmax(rnd(groups * b, n, t), -1).detach()
               .requires_grad_() for _ in range(2)]
        return ((lambda x, wa, va, *_: autograd.graph_conv(gps, x, wa, va)),
                (lambda x, wa, va, *_: tcmpc._graph_conv_grouped(gps, x, wa,
                                                                 va)),
                [rnd(groups * b, n, c), *aff, *leaves])
    if name == "se_sum":
        ws = [rnd(1, 1, c, c, scale=0.3) for _ in range(2)]
        bs = [rnd(c, scale=0.1) for _ in range(2)]
        inputs = [rnd(b, n, c), rnd(b, n, c), rnd(b, n, c),
                  torch.sigmoid(rnd(b, c)).detach().requires_grad_(),
                  torch.sigmoid(rnd(b, c)).detach().requires_grad_(),
                  *ws, *bs]
        return ((lambda f, o1, o2, g1, g2, *_: autograd.se_sum(
                    f, [o1, o2], [g1, g2], ws, bs)),
                (lambda f, o1, o2, g1, g2, *_: kernels.se_sum_plain(
                    f, [o1, o2], [g1, g2], [w[0, 0] for w in ws], bs)),
                inputs)
    p = {"kernel": rnd(1, 1, 2 * c, 4 * c, scale=0.3),
         **{k: rnd(3, 4, c, scale=0.3) for k in ("W_ci", "W_cf", "W_co")},
         "ln": [{"gamma": rnd(c), "beta": rnd(c)} for _ in range(5)]}
    return ((lambda x, cc, h, *_: autograd.convlstm_step(p, x, cc, h)),
            (lambda x, cc, h, *_: tcmpc.convlstm_step_fused(
                p, x, cc, h, use_kernels=False)),
            [rnd(b, 3, 4, c), rnd(b, 3, 4, c), rnd(b, 3, 4, c),
             *_leaves(p).values()])


@pytest.mark.parametrize("name", ["spa_affinity_grouped", "graph_conv",
                                  "se_sum", "convlstm_step"])
def test_recompute_function_matches_plain_route(name):
    """Each recompute function's outputs and input gradients (weights
    included) against autograd through the op's plain route."""
    fn, plain, inputs = _op_case(name)
    got_out, got = _grads(fn, inputs)
    want_out, want = _grads(plain, inputs)
    for a, w in zip(got_out + got, want_out + want):
        scale = w.abs().max().item()
        np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(),
                                   rtol=0, atol=1e-5 * max(scale, 1e-6))


def test_kernel_route_gradients_match_plain_route_on_cpu(rng):
    """A whole TINY step's loss and gradients through the kernel route
    (the autograd functions) and through the plain route agree, within the
    tolerance held against JAX (`_grad_tol`): the routes' forwards take the
    layer-norm statistics as sums and two-pass."""
    cfg = tget("CMPC_model", **TINY)
    state = ttrain.create_train_state(0, cfg, device="cpu")
    batch = _batch(cfg, rng)
    total_k, _ = ttrain.compute_gradients(state, cfg, batch)
    got = {p: v.grad.clone() for p, v in topt.named_leaves(state.trainable)}
    total_p, _ = ttrain.compute_gradients(state, cfg, batch,
                                          use_kernels=False)
    np.testing.assert_allclose(total_k.item(), total_p.item(), rtol=1e-6)
    want = {p: v.grad.numpy() for p, v in topt.named_leaves(state.trainable)}
    _check_grads({p: g.numpy() for p, g in got.items()}, want)


# ---------------------------------------------------------------------------
# optimizer pieces and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 500, 1000, 5000])
def test_polynomial_lr_matches_jax(step):
    cfg = tget("CMPC_model", **TINY)
    want = float(jopt.polynomial_lr(jget("CMPC_model", **TINY))(
        jnp.asarray(step)))
    np.testing.assert_allclose(topt.polynomial_lr(cfg)(step), want,
                               rtol=1e-6)


@pytest.mark.parametrize("conv5", [False, True])
def test_partition_merge_matches_jax(conv5):
    """The trainable and frozen trees have JAX's paths, leaf for leaf, and
    merge_params inverts partition_params.  With conv5=True the res3-5
    conv kernels 'w' train (under trainable['backbone']); their folded BN
    constants, conv1 and res2 stay frozen."""
    geo = {**TINY, "conv5": conv5}
    params = tinit(0, tget("CMPC_model", **geo), device="cpu")
    jp, _ = jinit(0, jget("CMPC_model", **geo))
    jtr, jfr = jopt.partition_params(jp, jget("CMPC_model", **geo))
    ttr, tfr = topt.partition_params(params, tget("CMPC_model", **geo))
    assert ("backbone" in ttr) == conv5
    if conv5:
        trained = {k for k in _leaves(ttr) if k[0] == "backbone"}
        assert trained and all(k[-1] == "w" and k[1][:4] in (
            "res3", "res4", "res5") for k in trained)
        assert not any(k[-1] == "w" and k[1][:4] in ("res3", "res4", "res5")
                       for k in _leaves(tfr))
    for mine, theirs in ((ttr, jtr), (tfr, jfr)):
        assert _leaves(mine).keys() == _leaves(theirs).keys()
    merged = topt.merge_params(ttr, tfr)
    assert _leaves(merged).keys() == _leaves(params).keys()
    assert all(merged_leaf is _leaves(params)[k]
               for k, merged_leaf in _leaves(merged).items())


def test_bias_gradient_doubling_matches_jax():
    """Conv 'biases' gradients double; the LSTM's 'bias', layer norms and
    kernels do not (the same name filter as the JAX package's)."""
    names = {"a": {"DW": (2, 2), "biases": (2,)},
             "lstm": {"kernel": (3, 4), "bias": (4,)},
             "ln": [{"gamma": (3,), "beta": (3,)}]}

    def build(make):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            return make(node)
        return walk(names)

    rng = np.random.default_rng(3)
    grads = build(lambda s: rng.standard_normal(s).astype(np.float32))
    want = _leaves(jopt.scale_bias_grads_tree(
        jax.tree.map(jnp.asarray, grads)))
    tree = build(lambda s: torch.zeros(s, requires_grad=True))
    for path, leaf in topt.named_leaves(tree):
        leaf.grad = _t(_leaves(grads)[path])
    topt.scale_bias_grads(tree)
    for path, leaf in topt.named_leaves(tree):
        np.testing.assert_array_equal(leaf.grad.numpy(),
                                      np.asarray(want[path]))


@pytest.mark.parametrize("pos,neg", [(1.0, 1.0), (2.0, 0.5)])
def test_losses_match_jax(rng, pos, neg):
    scores = (5 * rng.standard_normal((2, 8, 8, 1))).astype(np.float32)
    labels = (rng.random((2, 8, 8, 1)) > 0.6).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.weighed_logistic_loss(_t(scores), _t(labels), pos,
                                      neg).item(),
        float(jlosses.weighed_logistic_loss(jnp.asarray(scores),
                                            jnp.asarray(labels), pos, neg)),
        rtol=1e-6)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (1, 1, 2, 6))]
    np.testing.assert_allclose(
        tlosses.l2_regularization_loss([_t(a) for a in leaves], 5e-4).item(),
        float(jlosses.l2_regularization_loss(
            [jnp.asarray(a) for a in leaves], 5e-4)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

def _check_grads(got: dict, want: dict) -> None:
    """Per leaf: within 1e-4 of its largest entry plus 1e-11 of the largest
    gradient of all leaves (the float32 noise where a gradient cancels to
    0)."""
    floor = 1e-11 * max(np.abs(w).max() for w in want.values())
    assert set(got) == set(want) and len(want) > 100
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + floor,
                                   err_msg=str(path))


def _batch(cfg, rng):
    b = cfg.batch_size
    words = np.zeros((b, cfg.num_steps), np.int32)
    lens = np.array([2, 5][:b], np.int32)
    for i, n in enumerate(lens):
        words[i, :n] = rng.integers(3, cfg.vocab_size, n)
    return {"im_u8": rng.integers(0, 256, (b, cfg.H, cfg.W, 3),
                                  dtype=np.uint8),
            "target_u8": (rng.random((b, cfg.H, cfg.W, 1)) > 0.7
                          ).astype(np.uint8),
            "words": words, "seq_len": lens}


def _snapshot(jstate):
    """Numpy copies of a JAX state's trees (its buffers are donated to the
    next step)."""
    tree = jax.tree.map(np.asarray, jstate.unravel(jstate.trainable))
    adam = jstate.opt_state[0]
    return {"trainable": tree,
            "frozen": jax.tree.map(np.asarray, jstate.frozen),
            "mu": jax.tree.map(np.asarray, jstate.unravel(adam.mu)),
            "nu": jax.tree.map(np.asarray, jstate.unravel(adam.nu)),
            "count": int(adam.count)}


@pytest.fixture(scope="module")
def two_steps():
    """Two JAX steps from seed 0, and the port's first step from seed 0 and
    its second from the JAX state after the first."""
    rng = np.random.default_rng(4)
    jcfg, tcfg = jget("CMPC_model", **TINY), tget("CMPC_model", **TINY)
    batches = [_batch(tcfg, rng) for _ in range(2)]
    step_j = jtrain.make_train_step(jcfg, grad_mode="tree")
    jstate = jtrain.create_train_state(0, jcfg)
    snaps, jmetrics = [_snapshot(jstate)], []
    for batch in batches:
        jstate, m = step_j(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
        snaps.append(_snapshot(jstate))
    step_t = ttrain.make_train_step(tcfg)
    first = ttrain.create_train_state(0, tcfg, device="cpu")
    s = snaps[1]
    second = train_state_from_jax(s["trainable"], s["frozen"], s["mu"],
                                  s["nu"], s["count"], tcfg, device="cpu")
    tmetrics = [step_t(state, batch)
                for state, batch in zip((first, second), batches)]
    return {"snaps": snaps, "jmetrics": jmetrics, "states": (first, second),
            "tmetrics": tmetrics, "cfg": tcfg}


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_metrics_match_jax(two_steps, step):
    got, want = two_steps["tmetrics"][step], two_steps["jmetrics"][step]
    assert set(METRICS) <= set(got)
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_gradients_match_jax(two_steps, step):
    """Adam's first moment after the step: mu = b1 mu_prev + 0.1 g, with
    mu_prev equal on both sides, so (mu - b1 mu_prev) / 0.1 is the gradient
    each side used (conv biases doubled)."""
    state = two_steps["states"][step]
    before, after = two_steps["snaps"][step], two_steps["snaps"][step + 1]
    mu_prev, mu = _leaves(before["mu"]), _leaves(after["mu"])
    assert state.optimizer.state and all(
        int(st["step"]) == step + 1 for st in state.optimizer.state.values())
    got = {path: (state.optimizer.state[leaf]["exp_avg"].numpy()
                  - 0.9 * mu_prev[path]) / 0.1
           for path, leaf in topt.named_leaves(state.trainable)}
    _check_grads(got, {p: (mu[p] - 0.9 * mu_prev[p]) / 0.1 for p in mu})


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_params_match_jax(two_steps, step):
    """The updated weights: within 1e-3 of lr of JAX's where the gradient
    is resolved, within 2 lr where it is noise; and the update itself (at
    most ~lr per weight) is not trivially zero."""
    cfg = two_steps["cfg"]
    lr = two_steps["jmetrics"][step]["learning_rate"]
    snaps = two_steps["snaps"]
    before = _leaves(snaps[step]["trainable"])
    want = _leaves(snaps[step + 1]["trainable"])
    mu_prev, mu = _leaves(snaps[step]["mu"]), _leaves(snaps[step + 1]["mu"])
    moved = 0
    for path, leaf in topt.named_leaves(two_steps["states"][step].trainable):
        err = np.abs(leaf.detach().numpy() - want[path])
        resolved = np.abs(mu[path] - 0.9 * mu_prev[path]) / 0.1 >= 1e-6
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path
        moved += int((np.abs(want[path] - before[path]) > 0.5 * lr).sum())
    assert moved > 1000
    assert two_steps["states"][step].step == step + 1
    assert cfg.lr_decay_step == 1000


class _Reader:
    """A synthetic reader of collated batches, as the JAX loop reads."""

    def __init__(self, cfg, seed=5):
        self.cfg, self.rng, self.reads = cfg, np.random.default_rng(seed), 0

    def read_collated(self, bs):
        self.reads += 1
        cfg, rng = self.cfg, self.rng
        text = np.zeros((bs, cfg.num_steps), np.int64)
        text[:, :3] = rng.integers(3, cfg.vocab_size, (bs, 3))
        return {"im_batch": rng.integers(0, 256, (bs, cfg.H, cfg.W, 3),
                                         dtype=np.uint8),
                "mask_batch": rng.random((bs, cfg.H, cfg.W)) > 0.6,
                "text_batch": text, "seq_length": np.full((bs,), 3)}


def test_train_loop_on_cpu(tmp_path):
    cfg = tget("CMPC_model", **TINY)

    class Logger:
        rows = []

        def log(self, it, metrics):
            self.rows.append((it, metrics))

    reader, logger = _Reader(cfg), Logger()
    state = ttrain.train_loop(cfg, reader, max_iter=3, device="cpu",
                              log_every=1, logger=logger)
    assert state.step == 3 and reader.reads == 3
    assert [it for it, _ in logger.rows] == [0, 1, 2]
    assert all(np.isfinite(m["loss_total"]) and m["step_time_s"] > 0
               for _, m in logger.rows)
    # the loop saves snapshots into checkpoint_dir (train/checkpoint.py)
    state = ttrain.train_loop(cfg, reader, max_iter=4, state=state,
                              start_iter=3, checkpoint_dir=str(tmp_path),
                              snapshot_every=1)
    assert state.step == 4 and reader.reads == 4
    assert latest_step(str(tmp_path)) == 4


def test_prepare_image_batch_matches_jax():
    """Host packing and the device prologue give JAX's float feed."""
    cfg = tget("CMPC_model", **TINY)
    collated = _Reader(cfg).read_collated(2)
    want = jtrain.prepare_image_batch(collated, jget("CMPC_model", **TINY))
    got = ttrain.prepare_image_batch(collated, cfg)
    for k in ("im", "target", "words", "seq_len"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   err_msg=k)
    dev = ttrain.device_image_prologue(
        ttrain.prepare_image_batch_u8(collated), "cpu")
    np.testing.assert_allclose(dev["im"].numpy(), want["im"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(dev["target"].numpy(), want["target"])


def test_brightness_aug_adds_one_scalar():
    im = torch.randn(2, 4, 4, 3)
    deltas = []
    for step in (0, 1, 0):
        out = ttrain.brightness_aug(ttrain.aug_generator(step), im)
        d = out - im
        assert torch.allclose(d, d.flatten()[0].expand_as(d), atol=1e-6)
        assert abs(d.flatten()[0].item()) <= 0.2
        deltas.append(d.flatten()[0].item())
    assert deltas[0] == deltas[2] != deltas[1]


def test_unsupported_training_options_raise():
    """The options the port once refused, conv5 and grad_accum, now build a
    step and train (held against JAX in tests/test_torch_plus_train.py);
    a grad_accum micro-step that makes no update leaves the weights."""
    for kw in ({"grad_accum": 2}, {"conv5": True}):
        cfg = tget("CMPC_model", **{**TINY, **kw})
        state = ttrain.create_train_state(0, cfg, device="cpu")
        before = {p: v.detach().clone()
                  for p, v in topt.named_leaves(state.trainable)}
        metrics = ttrain.make_train_step(cfg)(
            state, _batch(cfg, np.random.default_rng(2)))
        assert np.isfinite(float(metrics["loss_total"]))
        moved = any(not torch.equal(v, before[p])
                    for p, v in topt.named_leaves(state.trainable))
        assert moved == (cfg.grad_accum == 1) and state.step == 1


def test_build_trainer_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer("CMPC_model", **TINY)
    trainer = build_trainer("CMPC_model", device="cpu", **TINY)
    assert trainer.state.device.type == "cpu" and trainer.state.step == 0
    metrics = trainer.step(_batch(trainer.cfg, np.random.default_rng(6)))
    assert trainer.state.step == 1 and np.isfinite(float(
        metrics["loss_total"]))


def test_import_guard_covers_train_modules():
    """tests/test_torch_model.py's guard globs the package; the new train
    and utils modules are among its files and import no JAX."""
    files = {f.relative_to(REPO).as_posix()
             for f in (REPO / "cmpc_refseg_torch").rglob("*.py")}
    new = {"cmpc_refseg_torch/train/trainer.py",
           "cmpc_refseg_torch/train/optimizer.py",
           "cmpc_refseg_torch/ops/losses.py",
           "cmpc_refseg_torch/ops/autograd.py",
           "cmpc_refseg_torch/utils/moving_average.py"}
    assert new <= files
    banned = re.compile(r"^\s*(import|from)\s+jax\b|cmpc_refseg_tpu", re.M)
    assert not [f for f in new if banned.search((REPO / f).read_text())]
