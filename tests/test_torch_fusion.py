"""The fusion stack's kernels and the level-packed spatial graph against JAX.

SE sum, the ConvLSTM step, the grouped affinity, the grouped graph
convolution and `apply_spa_graph_grouped` of the port, on the CPU (where
the wrappers run their plain versions), against the JAX package's plain
path and its Pallas kernels run in interpret mode, as tests/test_pallas.py
runs them.  The same numpy inputs go to both, in float32.  Tolerances:
1e-5 for single functions (float32 sums in other orders); 2e-4 where the
port's layer norm takes its statistics as (sum, sum of squares) and the
JAX plain path takes a two-pass variance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import cmpc as jcmpc
from cmpc_refseg_tpu.ops import pallas_kernels as pk

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
LN_TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _tree(node):
    """numpy pytree -> float32 tensors of the same structure."""
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v) for v in node]
    return _t(node)


def _close(got, want, tol):
    for g, w in zip(got if isinstance(got, (tuple, list)) else [got],
                    want if isinstance(want, (tuple, list)) else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# SE sum
# ---------------------------------------------------------------------------

def _se_case(rng, b=2, n=64, c=12, k=2):
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    others = [rng.standard_normal((b, n, c)).astype(np.float32)
              for _ in range(k)]
    gates = [rng.random((b, c)).astype(np.float32) for _ in range(k)]
    ws = [(0.3 * rng.standard_normal((c, c))).astype(np.float32)
          for _ in range(k)]
    bs = [(0.1 * rng.standard_normal((c,))).astype(np.float32)
          for _ in range(k)]
    got = kernels.se_sum(_t(feat), [_t(o) for o in others],
                         [_t(g) for g in gates], [_t(w) for w in ws],
                         [_t(v) for v in bs])
    return (feat, others, gates, ws, bs), got


@pytest.mark.parametrize("reference", ["xla", "interpret"])
def test_se_sum_matches_jax(rng, reference):
    """C = 12 is a multiple of 4 but not of 8, like the flagship's 500."""
    (feat, others, gates, ws, bs), got = _se_case(rng)
    j = [list(map(jnp.asarray, v)) for v in (others, gates, ws, bs)]
    if reference == "xla":
        want = jcmpc._se_sum_xla(jnp.asarray(feat), *j)
    else:
        want = pk.se_sum_fused(jnp.asarray(feat), *j, interpret=True)
    _close(got, want, TOL)


# ---------------------------------------------------------------------------
# ConvLSTM
# ---------------------------------------------------------------------------

def _convlstm_case(rng, b=2, hw=8, c=12):
    p = jcmpc.init_convlstm(6, jget("CMPC_model", H=8 * hw, W=8 * hw,
                                    mlp_dim=c))
    for ln in p["ln"]:            # distinct affine per norm: order matters
        ln["gamma"] = (1 + 0.2 * rng.standard_normal((c,))).astype(np.float32)
        ln["beta"] = (0.2 * rng.standard_normal((c,))).astype(np.float32)
    x, cell, h = (rng.standard_normal((b, hw, hw, c)).astype(np.float32)
                  for _ in range(3))
    return p, x, cell, h


@pytest.mark.parametrize("reference", ["xla", "interpret"])
def test_convlstm_step_fused_matches_jax(rng, reference):
    p, x, cell, h = _convlstm_case(rng)
    args = tuple(map(jnp.asarray, (x, cell, h)))
    if reference == "xla":
        want, tol = jcmpc.convlstm_step(p, *args), LN_TOL
    else:
        want, tol = pk.convlstm_step_fused(p, *args, interpret=True), TOL
    got = tcmpc.convlstm_step_fused(_tree(p), *map(_t, (x, cell, h)))
    _close(got, want, tol)


def test_convlstm_kernels_match_pallas_calls(rng):
    """Each kernel-holding function against its own Pallas call: gates,
    new_c_raw, o_raw and the whole-sample statistics; 64-row samples in
    two of the Pallas calls' row tiles."""
    _check_convlstm_kernels(rng, hw=8, tiles=2)


def test_convlstm_kernels_match_pallas_calls_at_one_tile(rng):
    """The same at 25-row samples (N * C = 300, not a multiple of 8: the
    CUDA raw kernel's vectors narrow to 4 there), one Pallas row tile."""
    _check_convlstm_kernels(rng, hw=5, tiles=1)


def _check_convlstm_kernels(rng, hw, tiles):
    p, x, cell, h = _convlstm_case(rng, hw=hw)
    b, n, c = 2, hw * hw, 12
    w = p["kernel"][0, 0]
    ci, cf, co = (p[k].reshape(n, c) for k in ("W_ci", "W_cf", "W_co"))
    x2, c2, h2 = (v.reshape(b * n, c) for v in (x, cell, h))
    j_gates, j_st = pk._convlstm_gates_call(
        *map(jnp.asarray, (x2, h2, c2)),
        jnp.asarray(w[:c].reshape(c, 4, c).transpose(1, 0, 2)),
        jnp.asarray(w[c:].reshape(c, 4, c).transpose(1, 0, 2)),
        jnp.asarray(ci), jnp.asarray(cf), bsz=b, n=n, c=c, tiles=tiles,
        interpret=True)
    gates, st = kernels.convlstm_gates(*(_t(v.reshape(b, n, c))
                                         for v in (x2, h2, c2)),
                                       _t(w), _t(ci), _t(cf))
    np.testing.assert_allclose(gates.numpy().reshape(4, b * n, c),
                               np.asarray(j_gates), **TOL)
    # lane-replicated (sum, sum of squares) rows 2g, 2g+1 for j, i, f
    np.testing.assert_allclose(st.sum(1).numpy().reshape(b, 6),
                               np.asarray(j_st)[:, :6, 0], rtol=1e-5,
                               atol=1e-3)

    gamma = np.stack([ln["gamma"] for ln in p["ln"]])
    beta = np.stack([ln["beta"] for ln in p["ln"]])
    pad = np.zeros((3, c), np.float32)
    j_nc, j_or, j_st2 = pk._convlstm_raw_call(
        j_gates, jnp.asarray(c2), jnp.asarray(co), j_st,
        jnp.asarray(np.concatenate([gamma, pad])),
        jnp.asarray(np.concatenate([beta, pad])), bsz=b, n=n, c=c,
        tiles=tiles,
        forget_bias=1.0, interpret=True)
    nc, orw, st2 = kernels.convlstm_raw(gates, _t(c2.reshape(b, n, c)),
                                        _t(co), st, _t(gamma), _t(beta))
    np.testing.assert_allclose(nc.numpy().reshape(b * n, c),
                               np.asarray(j_nc), **TOL)
    np.testing.assert_allclose(orw.numpy().reshape(b * n, c),
                               np.asarray(j_or), **TOL)
    np.testing.assert_allclose(st2.sum(1).numpy().reshape(b, 4),
                               np.asarray(j_st2)[:, :4, 0], rtol=1e-5,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# grouped affinity and graph convolution (level packing)
# ---------------------------------------------------------------------------

def _grouped_aff_inputs(rng, g=3, per=1, n=64, c=32, a=24, t=6):
    b = g * per
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wgs = (0.2 * rng.standard_normal((g, c, a))).astype(np.float32)
    bgs = (0.1 * rng.standard_normal((g, a))).astype(np.float32)
    wt = rng.standard_normal((b, t, a)).astype(np.float32)
    rel = rng.random((b, 1, t)).astype(np.float32)
    mask = np.zeros((b, 1, t), np.float32)
    mask[:, :, :4] = 1
    return x, wgs, bgs, wt, rel, mask


@pytest.mark.parametrize("l2n,masked", [(False, True), (False, False),
                                        (True, False)])
@pytest.mark.parametrize("reference", ["xla", "interpret"])
def test_grouped_affinity_matches_jax(rng, reference, l2n, masked):
    """G = 3 levels of one sample each: the batch-1 packed layout."""
    args = _grouped_aff_inputs(rng)
    kw = dict(scale=32 ** 0.5, l2n=l2n)
    if reference == "xla":
        want = jcmpc._spa_affinity_xla_grouped(*map(jnp.asarray, args),
                                               masked_softmax=masked, **kw)
    else:
        want = pk.spa_affinity_fused(*map(jnp.asarray, args),
                                     masked_softmax=masked, interpret=True,
                                     **kw)
    got = kernels.spa_affinity_grouped(*map(_t, args), masked=masked, **kw)
    _close(got, want, TOL)


def test_grouped_affinity_rejects_ragged_groups(rng):
    args = list(map(_t, _grouped_aff_inputs(rng, per=2)))
    with pytest.raises(ValueError, match="not divisible by 4"):
        kernels.spa_affinity_grouped(args[0], args[1][[0, 1, 2, 0]],
                                     args[2][[0, 1, 2, 0]], *args[3:],
                                     scale=4.0, l2n=False, masked=True)


def _grouped_graph_case(rng, g=3, per=1, n=64, c=32, t=6):
    cfg = jget("CMPC_model", mlp_dim=32, rnn_size=16, v_emb_dim=c,
               num_steps=t, H=64, W=64)
    gps = [jcmpc.init_spa_graph(i, cfg)["gconv"][0] for i in range(g)]
    for gp in gps:                 # distinct per-group biases and affines
        gp["update"]["biases"] = (0.1 * rng.standard_normal((c,))
                                  ).astype(np.float32)
        for ln in ("feat_ln", "update_ln"):
            gp[ln]["gamma"] = (1 + 0.1 * rng.standard_normal((c,))
                               ).astype(np.float32)
            gp[ln]["beta"] = (0.1 * rng.standard_normal((c,))
                              ).astype(np.float32)
    b = g * per
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wa = np.abs(rng.standard_normal((b, n, t))).astype(np.float32)
    va = np.abs(rng.standard_normal((b, n, t))).astype(np.float32)
    return gps, [_tree(gp) for gp in gps], x, wa, va


@pytest.mark.parametrize("per", [1, 2])
@pytest.mark.parametrize("reference", ["xla", "interpret"])
def test_grouped_graph_conv_matches_jax(rng, reference, per):
    gps, tgps, x, wa, va = _grouped_graph_case(rng, per=per)
    args = tuple(map(jnp.asarray, (x, wa, va)))
    if reference == "xla":
        want, tol = jcmpc._graph_conv_grouped_xla(gps, *args), LN_TOL
    else:
        want, tol = pk.graph_conv_fused(gps, *args, interpret=True), TOL
    got = tcmpc.graph_conv(tcmpc.stack_gconv(tgps, torch.float32),
                           *map(_t, (x, wa, va)))
    _close(got, want, tol)
    plain = tcmpc._graph_conv_grouped(tgps, *map(_t, (x, wa, va)))
    _close(plain, jcmpc._graph_conv_grouped_xla(gps, *args), TOL)


def test_grouped_update_matches_pallas_call(rng):
    """graph_update_grouped against the grouped _graph_update_call."""
    b, n, c, t = 3, 64, 32, 6
    gps, _, x, wa, _ = _grouped_graph_case(rng)
    pooled = rng.standard_normal((b, t, c)).astype(np.float32)
    j_msg, j_st = pk._graph_msg_call(jnp.asarray(wa.reshape(b * n, t)),
                                     jnp.asarray(pooled), bsz=b, n=n, c=c,
                                     t=t, tiles=2, interpret=True)
    msg, st = kernels.graph_msg(_t(wa), _t(pooled))

    def stack(f):
        return np.stack([f(gp) for gp in gps])

    w = stack(lambda gp: gp["update"]["DW"][0, 0])
    bias = stack(lambda gp: gp["update"]["biases"])
    g1 = stack(lambda gp: gp["feat_ln"]["gamma"])
    b1 = stack(lambda gp: gp["feat_ln"]["beta"])
    j_z, j_st2 = pk._graph_update_call(
        jnp.asarray(x.reshape(b * n, c)), j_msg, j_st, jnp.asarray(w),
        jnp.asarray(bias[:, None]), jnp.asarray(g1[:, None]),
        jnp.asarray(b1[:, None]), bsz=b, n=n, c=c, tiles=2, interpret=True)
    z, st2 = kernels.graph_update_grouped(_t(x), msg, st, _t(w), _t(bias),
                                          _t(g1), _t(b1))
    np.testing.assert_allclose(z.numpy().reshape(b * n, c), np.asarray(j_z),
                               **TOL)
    np.testing.assert_allclose(st2.sum(1).numpy(),
                               np.asarray(j_st2)[:, :2, 0], rtol=1e-5,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the level-packed spatial graph
# ---------------------------------------------------------------------------

def _spa_levels(rng, b, graph_norm="masked"):
    geo = dict(v_emb_dim=16, rnn_size=12, num_steps=6, graph_norm=graph_norm)
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    ps = [jcmpc.init_spa_graph(4 + i, jcfg) for i in range(3)]
    for p in ps:
        for gp in p["gconv"]:
            gp["update"]["biases"] = (0.1 * rng.standard_normal((16,))
                                      ).astype(np.float32)
    spas = [rng.standard_normal((b, 4, 4, 16)).astype(np.float32)
            for _ in range(3)]
    words = rng.standard_normal((b, 1, 6, 12)).astype(np.float32)
    parse = rng.random((b, 1, 6, 4)).astype(np.float32)
    mask = np.zeros((b, 1, 6, 1), np.float32)
    mask[:, :, :3] = 1
    return jcfg, tcfg, ps, spas, (words, parse, mask)


@pytest.mark.parametrize("graph_norm", ["masked", "unmasked",
                                        "softmax_mask"])
@pytest.mark.parametrize("b", [1, 2])
def test_packed_spa_graph_matches_per_level(rng, graph_norm, b):
    jcfg, tcfg, ps, spas, lang = _spa_levels(rng, b, graph_norm)
    tps = [_tree(p) for p in ps]
    packed, pgw = tcmpc.apply_spa_graph_grouped(
        tps, tcfg, [_t(s) for s in spas], *map(_t, lang))
    for p, s, out, gw in zip(tps, spas, packed, pgw):
        want, wgw = tcmpc.apply_spa_graph(p, tcfg, _t(s), *map(_t, lang))
        _close(out, want, TOL)
        _close(gw, wgw, TOL)
    plain, _ = tcmpc.apply_spa_graph_grouped(
        tps, tcfg, [_t(s) for s in spas], *map(_t, lang), use_kernels=False)
    for out, want in zip(plain, packed):
        _close(out, want, LN_TOL)


@pytest.mark.parametrize("fused", [None, "interpret"])
def test_packed_spa_graph_matches_jax(rng, monkeypatch, fused):
    """Against the JAX package's apply_spa_graph_grouped at batch 1, which
    packs there: its XLA reference, and its grouped Pallas kernels in
    interpret mode."""
    if fused:
        monkeypatch.setenv("CMPC_FUSED", fused)
    else:
        monkeypatch.delenv("CMPC_FUSED", raising=False)
    jcfg, tcfg, ps, spas, lang = _spa_levels(rng, 1)
    want, wgw = jcmpc.apply_spa_graph_grouped(
        ps, jcfg, [jnp.asarray(s) for s in spas], *map(jnp.asarray, lang))
    got, ggw = tcmpc.apply_spa_graph_grouped(
        [_tree(p) for p in ps], tcfg, [_t(s) for s in spas], *map(_t, lang))
    for g, w, gg, wg in zip(got, want, ggw, wgw):
        _close(g, w, LN_TOL)
        _close(gg, wg, TOL)


class _Recorder(dict):
    """A parameter dict that records the path of every leaf read."""

    def __init__(self, tree, path, seen):
        super().__init__({k: _record(v, f"{path}/{k}", seen)
                          for k, v in tree.items()})
        self.path, self.seen = path, seen

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, torch.Tensor):
            self.seen.add(f"{self.path}/{key}")
        return value


def _record(node, path, seen):
    if isinstance(node, dict):
        return _Recorder(node, path, seen)
    if isinstance(node, list):
        return [_record(v, f"{path}/{i}", seen) for i, v in enumerate(node)]
    return node


def test_packed_path_reads_the_per_level_leaves(rng):
    """The packed spatial graph reads exactly the parameter leaves that
    the per-level path reads, so the weights bridge (params_from_jax),
    which already serves the per-level path, covers it."""
    _, tcfg, ps, spas, lang = _spa_levels(rng, 1)
    per_level, packed = set(), set()
    for i, (p, s) in enumerate(zip(ps, spas)):
        tcmpc.apply_spa_graph(_record(_tree(p), f"level{i}", per_level),
                              tcfg, _t(s), *map(_t, lang))
    tcmpc.apply_spa_graph_grouped(
        [_record(_tree(p), f"level{i}", packed) for i, p in enumerate(ps)],
        tcfg, [_t(s) for s in spas], *map(_t, lang))
    assert packed == per_level and len(per_level) == 3 * 10


def test_packing_rule():
    """The rule packs small per-level batches of several levels only."""
    assert tcmpc.pack_levels(1, 3)
    assert not tcmpc.pack_levels(1, 1)
    assert not tcmpc.pack_levels(tcmpc.LEVEL_PACK_MAX_BATCH + 1, 3)
