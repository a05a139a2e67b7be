"""The port's kernel-holding functions against the JAX package.

Each is held against the JAX plain path (`_mutan_reference`,
`_spa_affinity_xla`, `cmpc._graph_conv`) and against the JAX Pallas kernel
run in interpret mode, as tests/test_pallas.py runs it.  On the CPU the
port's wrappers run their plain versions; the CUDA kernels themselves are
held against those plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py).  Comparisons run in float32.  Tolerances: 2e-5 where both
sides compute the same sums (one float32 rounding apart), 2e-4 where the
layer-norm statistics come from (sum, sum of squares) on one side and from
a two-pass variance on the other.  `test_mutan_matches_jax_reference`
holds both sides against a float64 oracle instead, entry by entry within
a float32 error bound derived from K (`_mutan_oracle`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import cmpc as jcmpc
from cmpc_refseg_tpu.ops import pallas_kernels as pk
from cmpc_refseg_torch.config import get_config as tget

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LN_TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# mutan
# ---------------------------------------------------------------------------

def _mutan_case(rng, b, n, k, c, nh=5):
    x = rng.standard_normal((b, n, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, nh * c))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((nh * c,))).astype(np.float32)
    lang = rng.standard_normal((b, nh * c)).astype(np.float32)
    got = kernels.mutan_fused(_t(x.reshape(b * n, k)), _t(w), _t(bias),
                              _t(lang), heads=nh, rows_per_sample=n)
    return (x, w, bias, lang, nh), got.numpy().reshape(b, n, c)


def _mutan_oracle(x, w, bias, lang, nh):
    """The mutan in float64 and, per output entry, a bound on the error of
    any float32 evaluation of it, derived from K: with u = 2^-24 and
    g(n) = n u / (1 - n u), the K-term product and bias z = x @ W + b err
    by at most g(K + 1) sum |x_k W_k| + |b| (the standard bound on a
    float32 dot product, in any summation order); tanh, 1-Lipschitz, adds
    4 u |v| for its own rounding; the head sum adds g(heads) of its
    absolute terms, weighted by |lang|; the row l2 norm turns an error dy
    into dy / ||y|| + |out| (|y| . dy / ||y||^2 + g(C) + 4 u)."""
    u = 2.0 ** -24

    def g(m):
        return m * u / (1 - m * u)
    b, n, k = x.shape
    c = w.shape[1] // nh
    x, w, bias, lang = (np.asarray(a, np.float64) for a in (x, w, bias, lang))
    v = np.tanh(x @ w + bias)
    la = np.abs(lang).reshape(b, 1, nh, c)
    vh = v.reshape(b, n, nh, c)
    y = np.tanh((vh * lang.reshape(b, 1, nh, c)).sum(2))
    norm = np.sqrt((y * y).sum(-1, keepdims=True))
    out = y / norm
    dv = g(k + 1) * (np.abs(x) @ np.abs(w) + np.abs(bias)) + 4 * u * np.abs(v)
    dy = ((dv.reshape(b, n, nh, c) * la).sum(2)
          + g(nh) * (np.abs(vh) * la).sum(2) + 4 * u * np.abs(y))
    bound = dy / norm + np.abs(out) * (
        (np.abs(y) * dy).sum(-1, keepdims=True) / norm ** 2 + g(c) + 4 * u)
    return out, bound


@pytest.mark.parametrize("b,n,k,c", [(2, 64, 24, 16), (3, 16, 40, 32)])
def test_mutan_matches_jax_reference(rng, b, n, k, c):
    """The port's mutan and JAX's `_mutan_reference` each within the
    K-derived float32 error bound of the float64 oracle (`_mutan_oracle`),
    entry by entry, so within twice it of each other; a failure names the
    side that left the bound."""
    (x, w, bias, lang, nh), got = _mutan_case(rng, b, n, k, c)
    want = np.asarray(pk._mutan_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(lang),
        nh))
    oracle, bound = _mutan_oracle(x, w, bias, lang, nh)
    for side, val in (("port", got), ("jax", want)):
        err = np.abs(val - oracle)
        assert (err <= bound).all(), (side, float((err / bound).max()))


@pytest.mark.parametrize("b,n,k,c", [(2, 64, 24, 16), (1, 128, 128, 128)])
def test_mutan_matches_pallas_interpret(rng, b, n, k, c):
    (x, w, bias, lang, nh), got = _mutan_case(rng, b, n, k, c)
    want = pk._mutan_fused_fwd(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias), jnp.asarray(lang),
                               num_heads=nh, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_mutan_matches_padded_pallas_interpret(rng):
    """The prepared-params kernel (mutan_fused_padded on pad_mutan_params
    output), which the JAX package runs for inference."""
    b, n, k, c, ld = 2, 64, 24, 16, 12
    (x, w, bias, lang, nh), got = _mutan_case(rng, b, n, k, c)
    ldw = (0.2 * rng.standard_normal((1, 1, ld, nh * c))).astype(np.float32)
    pad = pk.pad_mutan_params({"DW": w[None, None], "biases": bias},
                              {"DW": ldw, "biases": np.zeros(nh * c,
                                                             np.float32)},
                              compute_dtype=jnp.float32)
    kp = pad["w_wide"].shape[0]
    cp = pad["b_pad"].shape[1]
    x_pad = np.concatenate([x, np.zeros((b, n, kp - k), np.float32)], -1)
    l_pad = np.zeros((b, nh, cp), np.float32)
    l_pad[:, :, :c] = lang.reshape(b, nh, c)
    want = pk.mutan_fused_padded(jnp.asarray(x_pad), pad["w_wide"],
                                 pad["b_pad"],
                                 jnp.asarray(l_pad.reshape(b, nh * cp)),
                                 num_heads=nh, c=c, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [None, "interpret"])
def test_apply_mutan_matches_jax(rng, monkeypatch, fused):
    """The module function: concat with the spatial grid, the language
    projection and the kernel call, on both JAX dispatch paths."""
    if fused:
        monkeypatch.setenv("CMPC_FUSED", fused)
    cfg = jget("CMPC_model", v_emb_dim=16, rnn_size=12)
    p = jcmpc.init_mutan(2, cfg)
    vis = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    spatial = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    lang = rng.standard_normal((2, 1, 1, 12)).astype(np.float32)
    want = jcmpc.apply_mutan(p, jnp.asarray(lang), jnp.asarray(spatial),
                             jnp.asarray(vis))
    tp = {kk: {n: _t(v) for n, v in d.items()} for kk, d in p.items()}
    got = tcmpc.apply_mutan(tp, _t(lang), _t(spatial), _t(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        tcmpc.init_mutan(2, tget("CMPC_model", v_emb_dim=16, rnn_size=12))
        ["vis_trans"]["DW"], p["vis_trans"]["DW"])


# ---------------------------------------------------------------------------
# spatial-graph affinity
# ---------------------------------------------------------------------------

def _aff_inputs(rng, b=2, n=64, c=32, a=24, t=6):
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wg = (0.2 * rng.standard_normal((c, a))).astype(np.float32)
    bg = (0.1 * rng.standard_normal((a,))).astype(np.float32)
    wt = rng.standard_normal((b, t, a)).astype(np.float32)
    rel = rng.random((b, 1, t)).astype(np.float32)
    mask = np.zeros((b, 1, t), np.float32)
    mask[:, :, :max(4, 3 * t // 4)] = 1
    mask[-1, :, :2] = 0
    return x, wg, bg, wt, rel, mask


def _aff_port(args, **kw):
    return kernels.spa_affinity(*[_t(v) for v in args], **kw)


FLAGS = [(False, True), (False, False), (True, False)]


@pytest.mark.parametrize("l2n,masked", FLAGS)
def test_affinity_matches_jax_reference(rng, l2n, masked):
    args = _aff_inputs(rng)
    want = jcmpc._spa_affinity_xla(*map(jnp.asarray, args),
                                   scale=32 ** 0.5, l2n=l2n,
                                   masked_softmax=masked)
    got = _aff_port(args, scale=32 ** 0.5, l2n=l2n, masked=masked)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("l2n,masked,n,t", [
    pytest.param(*f, 64, 6, id=f"{f[0]}-{f[1]}-64") for f in FLAGS] + [
    pytest.param(False, True, 256, 6, id="False-True-256"),
    pytest.param(False, True, 64, 40, id="False-True-64-T40")])
def test_affinity_matches_pallas_interpret(rng, l2n, masked, n, t):
    """n=256 spans several kernel tiles: the column-softmax statistics;
    T = 40 is more words than one 32-word chunk of the CUDA kernel."""
    args = _aff_inputs(rng, n=n, t=t)
    want = pk.spa_affinity_fused(*map(jnp.asarray, args), scale=32 ** 0.5,
                                 l2n=l2n, masked_softmax=masked,
                                 interpret=True)
    got = _aff_port(args, scale=32 ** 0.5, l2n=l2n, masked=masked)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# graph convolution
# ---------------------------------------------------------------------------

def _graph_case(rng, b=2, n=64, c=32, t=6):
    cfg = jget("CMPC_model", mlp_dim=32, rnn_size=16, v_emb_dim=c,
               vocab_size=30, glove_dim=8, num_steps=t, res4_blocks=2,
               H=64, W=64)
    gp = jcmpc.init_spa_graph(0, cfg)["gconv"][0]
    gp["update"]["biases"] = (0.1 * rng.standard_normal((c,))
                              ).astype(np.float32)
    gp["feat_ln"]["gamma"] = (1 + 0.1 * rng.standard_normal((c,))
                              ).astype(np.float32)
    gp["update_ln"]["beta"] = (0.1 * rng.standard_normal((c,))
                               ).astype(np.float32)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wa = np.abs(rng.standard_normal((b, n, t))).astype(np.float32)
    va = np.abs(rng.standard_normal((b, n, t))).astype(np.float32)
    tgp = {k: {n_: _t(v) for n_, v in d.items()} for k, d in gp.items()}
    return gp, tgp, x, wa, va


@pytest.mark.parametrize("port_fn", ["graph_conv", "_graph_conv"])
def test_graph_conv_matches_jax_reference(rng, port_fn):
    gp, tgp, x, wa, va = _graph_case(rng)
    want = jcmpc._graph_conv(gp, jnp.asarray(x), jnp.asarray(wa),
                             jnp.asarray(va))
    arg = tcmpc.stack_gconv([tgp], torch.float32) \
        if port_fn == "graph_conv" else tgp
    got = getattr(tcmpc, port_fn)(arg, _t(x), _t(wa), _t(va))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LN_TOL)


@pytest.mark.parametrize("n,t", [pytest.param(64, 6, id="64"),
                                 pytest.param(256, 6, id="256"),
                                 pytest.param(64, 40, id="64-T40"),
                                 pytest.param(75, 17, id="75-T17"),
                                 pytest.param(75, 33, id="75-T33")])
def test_graph_conv_matches_pallas_interpret(rng, n, t):
    """T = 40: more words than one 32-word chunk of the message kernel;
    T = 17 and 33: odd word counts (the kernel's w_aff rows are 2-byte
    aligned, its K padded to 32 and 48); N = 75: no multiple of the
    kernel's 16-row tiles (the Pallas call takes one whole-sample tile)."""
    gp, tgp, x, wa, va = _graph_case(rng, n=n, t=t)
    want = pk.graph_conv_fused(gp, jnp.asarray(x), jnp.asarray(wa),
                               jnp.asarray(va), interpret=True)
    got = tcmpc.graph_conv(tcmpc.stack_gconv([tgp], torch.float32), _t(x),
                           _t(wa), _t(va))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_graph_msg_and_update_match_pallas_calls(rng):
    """Each kernel-holding function against its own Pallas call: outputs
    and whole-sample (sum, sum of squares) statistics."""
    b, n, c, t = 2, 64, 32, 6
    gp, tgp, x, wa, _ = _graph_case(rng, b=b, n=n, c=c, t=t)
    pooled = rng.standard_normal((b, t, c)).astype(np.float32)
    j_msg, j_st = pk._graph_msg_call(jnp.asarray(wa.reshape(b * n, t)),
                                     jnp.asarray(pooled), bsz=b, n=n, c=c,
                                     t=t, tiles=2, interpret=True)
    msg, st = kernels.graph_msg(_t(wa), _t(pooled))
    np.testing.assert_allclose(msg.numpy().reshape(b * n, c),
                               np.asarray(j_msg), **TOL)
    np.testing.assert_allclose(st.sum(1).numpy(),
                               np.asarray(j_st)[:, :2, 0], **TOL)

    w = gp["update"]["DW"][0, 0]
    j_z, j_st2 = pk._graph_update_call(
        jnp.asarray(x.reshape(b * n, c)), j_msg, j_st, jnp.asarray(w),
        jnp.asarray(gp["update"]["biases"]), jnp.asarray(gp["feat_ln"]
                                                         ["gamma"]),
        jnp.asarray(gp["feat_ln"]["beta"]), bsz=b, n=n, c=c, tiles=2,
        interpret=True)
    z, st2 = kernels.graph_update(_t(x), msg, st, _t(w),
                                  _t(gp["update"]["biases"]),
                                  _t(gp["feat_ln"]["gamma"]),
                                  _t(gp["feat_ln"]["beta"]))
    np.testing.assert_allclose(z.numpy().reshape(b * n, c), np.asarray(j_z),
                               **TOL)
    np.testing.assert_allclose(st2.sum(1).numpy(),
                               np.asarray(j_st2)[:, :2, 0], rtol=2e-5,
                               atol=1e-3)


@pytest.mark.parametrize("b,n,t", [(3, 75, 17), (2, 75, 33), (1, 64, 1)])
def test_graph_msg_matches_pallas_call_at_ragged_shapes(rng, b, n, t):
    """graph_msg against `_graph_msg_call` (interpret mode, one
    whole-sample tile) where the CUDA kernel's edges lie: odd T (17), T
    past one 32-word box (33), T = 1, and N = 75 rows (a ragged last
    16-row tile and 32-row group); msg and the summed statistics."""
    c = 40
    wa = np.abs(rng.standard_normal((b, n, t))).astype(np.float32)
    pooled = rng.standard_normal((b, t, c)).astype(np.float32)
    j_msg, j_st = pk._graph_msg_call(jnp.asarray(wa.reshape(b * n, t)),
                                     jnp.asarray(pooled), bsz=b, n=n, c=c,
                                     t=t, tiles=1, interpret=True)
    msg, st = kernels.graph_msg(_t(wa), _t(pooled))
    np.testing.assert_allclose(msg.numpy().reshape(b * n, c),
                               np.asarray(j_msg), **TOL)
    np.testing.assert_allclose(st.sum(1).numpy(),
                               np.asarray(j_st)[:, :2, 0], **TOL)


@pytest.mark.parametrize("graph_norm", ["masked", "unmasked",
                                        "softmax_mask"])
@pytest.mark.parametrize("fused", [None, "interpret"])
def test_apply_spa_graph_matches_jax(rng, monkeypatch, graph_norm, fused):
    if fused:
        monkeypatch.setenv("CMPC_FUSED", fused)
    geo = dict(v_emb_dim=16, rnn_size=12, num_steps=6, graph_norm=graph_norm)
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    p = jcmpc.init_spa_graph(4, jcfg)
    b = 4
    spa = rng.standard_normal((b, 4, 4, 16)).astype(np.float32)
    words = rng.standard_normal((b, 1, 6, 12)).astype(np.float32)
    parse = rng.random((b, 1, 6, 4)).astype(np.float32)
    mask = np.zeros((b, 1, 6, 1), np.float32)
    mask[:, :, :3] = 1
    want, (jw, jv) = jcmpc.apply_spa_graph(
        p, jcfg, *map(jnp.asarray, (spa, words, parse, mask)))

    def conv(d):
        return {k: (_t(v) if not isinstance(v, (dict, list)) else
                    [conv(e) for e in v] if isinstance(v, list) else conv(v))
                for k, v in d.items()}

    got, (tw, tv) = tcmpc.apply_spa_graph(conv(p), tcfg,
                                          *map(_t, (spa, words, parse,
                                                    mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LN_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    kernels.reset_launch_counts()
    args = _aff_inputs(rng)
    kernels.spa_affinity(*[_t(v) for v in args], scale=4.0, l2n=False,
                         masked=True)
    kernels.graph_msg(_t(rng.random((2, 8, 6))), _t(args[3]))
    assert kernels.launch_counts() == {k.__name__: 0
                                       for k in kernels.KERNELS}


@pytest.mark.parametrize("devices", [("meta", "meta"), ("cpu", "meta")])
def test_non_cpu_non_cuda_tensors_raise(devices):
    """Off the CPU a wrapper launches its kernel or raises: tensors on
    another device (or on mixed devices) never reach a plain version."""
    w_aff = torch.zeros((1, 8, 4), device=devices[0])
    pooled = torch.zeros((1, 4, 8), device=devices[1])
    with pytest.raises(ValueError, match="expected all on the CPU"):
        kernels.graph_msg(w_aff, pooled)
