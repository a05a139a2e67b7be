"""Any width: the kernels take column counts that are multiples of 8, the
JAX package any.  `models/cmpc.py` pads each kernel's operands with zero
columns (weights with zero rows and columns per mutan head, per ConvLSTM
gate block and input half) and slices the outputs back; the statistics
count the true width (the `width` argument of the update and raw kernels
and of `kernels.ln_from_stats`).

Held here on the CPU, where the wrappers run their plain versions:

- each kernel's plain version on padded operands equals it on the
  unpadded ones, sliced (the padded output columns exactly 0; atol 1e-6
  where a product's float32 sums may run in another blocking order, the
  statistics rtol 1e-5);
- each padding function of `models/cmpc.py` (mutan, affinity, graph
  convolution, SE sum, ConvLSTM step) against the unpadded plain function
  at widths 13, 11 and 10;
- at TINY with v_emb_dim=13, vw_emb_dim=11, mlp_dim=10, the flagship's
  forward (`sigm` atol 1e-4) and one train step (tests/test_torch_train.py's
  bounds) against the JAX package, which takes those widths as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.models.model import apply_model as tapply
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.models.model import prepare_params
from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_torch.train import optimizer as topt
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import apply_model as japply
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.train import trainer as jtrain
from test_torch_model import _batch as _model_batch
from test_torch_model import TINY as MODEL_TINY
from test_torch_train import TINY as TRAIN_TINY
from test_torch_train import _batch as _train_batch
from test_torch_train import _check_grads, _leaves, _snapshot

torch.set_num_threads(2)

ODD = dict(v_emb_dim=13, vw_emb_dim=11, mlp_dim=10)
C, A, CM, CP, AP, CMP = 13, 11, 10, 16, 16, 12
HEADS, B, N, T = 5, 2, 6, 5
EXACT = dict(rtol=0, atol=1e-6)


def _pad(t, cp):
    return tcmpc.pad_cols(t, cp)


def _r(gen, *shape, scale=1.0):
    return scale * torch.randn(*shape, generator=gen)


def _mutan_args(gen):
    k = 16
    return (_r(gen, B * N, k), _r(gen, k, HEADS * C, scale=0.2),
            _r(gen, HEADS * C, scale=0.1), torch.tanh(_r(gen, B, HEADS * C)))


def _mutan_padded(args):
    x, w, b, lang = args
    return (x, tcmpc.pad_blocks(w, HEADS, CP), tcmpc.pad_blocks(b, HEADS, CP),
            tcmpc.pad_blocks(lang, HEADS, CP))


def _unheads(t):
    """[.., HEADS * CP] -> [.., HEADS * C]: each head's padding dropped."""
    return t.reshape(*t.shape[:-1], HEADS, CP)[..., :C].reshape(
        *t.shape[:-1], HEADS * C)


def _stats_close(got, want):
    np.testing.assert_allclose(got.sum(1).numpy(), want.sum(1).numpy(),
                               rtol=1e-5, atol=1e-6)


def _case(name, gen):
    """(padded outputs sliced to the true widths, unpadded outputs) of one
    kernel's plain version."""
    kw = dict(heads=HEADS, rows_per_sample=N)
    if name == "mutan":
        args = _mutan_args(gen)
        got = kernels.mutan_plain(*_mutan_padded(args), **kw)
        assert torch.equal(got[:, C:], torch.zeros_like(got[:, C:]))
        return [got[:, :C]], [kernels.mutan_plain(*args, **kw)]
    if name == "mutan_fwd_residual":
        args = _mutan_args(gen)
        out, v = kernels.mutan_fwd_residual_plain(*_mutan_padded(args), **kw)
        want = kernels.mutan_fwd_residual_plain(*args, **kw)
        return [out[:, :C], _unheads(v)], list(want)
    if name == "mutan_bwd_dz":
        v = torch.tanh(_r(gen, B * N, HEADS * C))
        lang = torch.tanh(_r(gen, B, HEADS * C))
        g = _r(gen, B * N, C)
        got = kernels.mutan_bwd_dz_plain(
            tcmpc.pad_blocks(v, HEADS, CP), tcmpc.pad_blocks(lang, HEADS, CP),
            _pad(g, CP), **kw)
        assert not _unheads(got[0]).eq(0).all()
        pad_cols = got[0].reshape(-1, HEADS, CP)[..., C:]
        assert torch.equal(pad_cols, torch.zeros_like(pad_cols))
        return [_unheads(t) for t in got], list(
            kernels.mutan_bwd_dz_plain(v, lang, g, **kw))
    if name == "mutan_dw":
        x, dz = _r(gen, B * N, 16), _r(gen, B * N, HEADS * C)
        got = kernels.mutan_dw_plain(x, tcmpc.pad_blocks(dz, HEADS, CP))
        return [_unheads(got)], [kernels.mutan_dw_plain(x, dz)]
    if name.startswith("spa_affinity"):
        groups = 2 if name.endswith("grouped") else 1
        x = _r(gen, groups * B, N, C)
        wg, bg = _r(gen, groups, C, A, scale=0.3), _r(gen, groups, A)
        wt = _r(gen, groups * B, T, A)
        rel = torch.rand(groups * B, 1, T, generator=gen)
        mask = (torch.arange(T) < 4).float().expand(groups * B, 1, T)
        akw = dict(scale=C ** 0.5, l2n=True, masked=True)
        wgp, bgp = tcmpc.pad_projection(wg, bg)
        assert wgp.shape == (groups, CP, AP)
        got = kernels.spa_affinity_grouped_plain(
            _pad(x, CP), wgp, bgp, _pad(wt, AP), rel, mask, **akw)
        return list(got), list(kernels.spa_affinity_grouped_plain(
            x, wg, bg, wt, rel, mask, **akw))
    if name == "graph_msg":
        w_aff = torch.softmax(_r(gen, B, N, T), -1)
        pooled = _r(gen, B, T, C)
        msg, st = kernels.graph_msg_plain(w_aff, _pad(pooled, CP))
        want = kernels.graph_msg_plain(w_aff, pooled)
        _stats_close(st, want[1])
        return [msg[..., :C]], [want[0]]
    if name.startswith("graph_update"):
        groups = 2 if name.endswith("grouped") else 1
        x = _r(gen, groups * B, N, C)
        msg, st = kernels.graph_msg_plain(
            torch.softmax(_r(gen, groups * B, N, T), -1),
            _r(gen, groups * B, T, C))
        w, b = _r(gen, groups, C, C, scale=0.3), _r(gen, groups, C)
        g1, b1 = 1 + _r(gen, groups, C, scale=0.1), _r(gen, groups, C)
        z, st2 = kernels.graph_update_grouped_plain(
            _pad(x, CP), _pad(msg, CP), st, tcmpc.pad_square(w, CP),
            _pad(b, CP), _pad(g1, CP), _pad(b1, CP), width=C)
        want = kernels.graph_update_grouped_plain(x, msg, st, w, b, g1, b1)
        assert torch.equal(z[..., C:], torch.zeros_like(z[..., C:]))
        _stats_close(st2, want[1])
        return [z[..., :C]], [want[0]]
    if name == "ln_from_stats":
        v = _r(gen, B, N, C)
        gamma, beta = 1 + _r(gen, C, scale=0.1), _r(gen, C)
        got = kernels.ln_from_stats(_pad(v, CP), kernels._sum_stats(v),
                                    _pad(gamma, CP), _pad(beta, CP), C)
        return [got[..., :C], got[..., C:]], [
            kernels.ln_from_stats(v, kernels._sum_stats(v), gamma, beta),
            torch.zeros(B, N, CP - C)]
    if name == "se_sum":
        feat = _r(gen, B, N, CM)
        others = [_r(gen, B, N, CM) for _ in range(2)]
        gates = [torch.sigmoid(_r(gen, B, CM)) for _ in range(2)]
        ws = [_r(gen, CM, CM, scale=0.3) for _ in range(2)]
        bs = [_r(gen, CM, scale=0.1) for _ in range(2)]
        padded = (_pad(feat, CMP), [_pad(o, CMP) for o in others],
                  [_pad(g, CMP) for g in gates],
                  [tcmpc.pad_square(w, CMP) for w in ws],
                  [_pad(b, CMP) for b in bs])
        got = kernels.se_sum_plain(*padded)
        assert torch.equal(got[..., CM:], torch.zeros(B, N, CMP - CM))
        return [got[..., :CM]], [kernels.se_sum_plain(feat, others, gates,
                                                      ws, bs)]
    # the ConvLSTM gates and raw kernels, through one step's tables
    p = _convlstm_params(gen)
    x, h, c = (_r(gen, B, N, CM) for _ in range(3))
    tp, tu = tcmpc.convlstm_tables(p, torch.float32), _unpadded_tables(p)
    gp, sp = kernels.convlstm_gates_plain(
        *(_pad(v, CMP) for v in (x, h, c)), tp["w"], tp["ci"], tp["cf"])
    gu, su = kernels.convlstm_gates_plain(x, h, c, tu["w"], tu["ci"],
                                          tu["cf"])
    _stats_close(sp.flatten(2), su.flatten(2))
    assert torch.equal(gp[..., CM:], torch.zeros(4, B, N, CMP - CM))
    if name == "convlstm_gates":
        return [gp[..., :CM]], [gu]
    ncp, orp, st2 = kernels.convlstm_raw_plain(
        gp, _pad(c, CMP), tp["co"], sp, tp["gamma"], tp["beta"], width=CM)
    ncu, oru, st2u = kernels.convlstm_raw_plain(gu, c, tu["co"], su,
                                                tu["gamma"], tu["beta"])
    _stats_close(st2.flatten(2), st2u.flatten(2))
    assert torch.equal(ncp[..., CM:], torch.zeros_like(ncp[..., CM:]))
    return [ncp[..., :CM], orp[..., :CM]], [ncu, oru]


def _convlstm_params(gen, hw=(2, 3)):
    lns = [{"gamma": 1 + _r(gen, CM, scale=0.1), "beta": _r(gen, CM,
                                                            scale=0.1)}
           for _ in range(5)]
    return {"kernel": _r(gen, 1, 1, 2 * CM, 4 * CM, scale=0.2),
            **{f"W_{k}": _r(gen, *hw, CM, scale=0.1)
               for k in ("ci", "cf", "co")}, "ln": lns}


def _unpadded_tables(p):
    return {"w": p["kernel"][0, 0],
            **{k: p[f"W_{k}"].reshape(-1, CM) for k in ("ci", "cf", "co")},
            **{k: torch.stack([ln[k] for ln in p["ln"]])
               for k in ("gamma", "beta")}}


@pytest.mark.parametrize("name", [
    "mutan", "mutan_fwd_residual", "mutan_bwd_dz", "mutan_dw",
    "spa_affinity", "spa_affinity_grouped", "graph_msg", "graph_update",
    "graph_update_grouped", "ln_from_stats", "se_sum", "convlstm_gates",
    "convlstm_raw"])
def test_padded_plain_version_equals_unpadded(name):
    got, want = _case(name, torch.Generator().manual_seed(3))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (name, i)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **EXACT,
                                   err_msg=f"{name} output {i}")


def test_width_is_checked():
    v = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="width=9"):
        kernels.ln_from_stats(v, kernels._sum_stats(v), torch.ones(8),
                              torch.zeros(8), 9)


# ---------------------------------------------------------------------------
# the padding functions of models/cmpc.py against the unpadded plain ones
# ---------------------------------------------------------------------------

def _pad_fn_case(name, gen):
    """(the padding function's output, the unpadded plain function's)."""
    if name == "apply_mutan":
        k = C + 8
        params = {"vis_trans": {"DW": _r(gen, 1, 1, k, HEADS * C, scale=0.2),
                                "biases": _r(gen, HEADS * C, scale=0.1)},
                  "lang_trans": {"DW": _r(gen, 1, 1, 7, HEADS * C, scale=0.3),
                                 "biases": _r(gen, HEADS * C, scale=0.1)}}
        vis, spatial = _r(gen, B, 2, 3, C), _r(gen, B, 2, 3, 8)
        lang = _r(gen, B, 1, 1, 7)
        got = tcmpc.apply_mutan(params, lang, spatial, vis)
        x = torch.cat([vis, spatial], -1).reshape(B * 6, k)
        lt = torch.tanh(lang.reshape(B, 7) @ params["lang_trans"]["DW"][0, 0]
                        + params["lang_trans"]["biases"])
        want = kernels.mutan_plain(x, params["vis_trans"]["DW"][0, 0],
                                   params["vis_trans"]["biases"], lt,
                                   heads=HEADS, rows_per_sample=6)
        return got, want.reshape(B, 2, 3, C)
    if name == "affinity":
        x, wt = _r(gen, B, N, C), _r(gen, B, T, A)
        wg, bg = _r(gen, 1, C, A, scale=0.3), _r(gen, 1, A)
        rel = torch.rand(B, 1, T, generator=gen)
        mask = (torch.arange(T) < 3).float().expand(B, 1, T)
        kw = dict(scale=C ** 0.5, l2n=True, masked=False)
        got = tcmpc.affinity(x, *tcmpc.pad_projection(wg, bg), wt, rel, mask,
                             **kw)
        want = kernels.spa_affinity_plain(x, wg[0], bg[0], wt, rel, mask, **kw)
        return torch.cat(got), torch.cat(want)
    if name == "graph_conv":
        gp = {"update": {"DW": _r(gen, 1, 1, C, C, scale=0.3),
                         "biases": _r(gen, C, scale=0.1)},
              "feat_ln": {"gamma": 1 + _r(gen, C, scale=0.1),
                          "beta": _r(gen, C, scale=0.1)},
              "update_ln": {"gamma": 1 + _r(gen, C, scale=0.1),
                            "beta": _r(gen, C, scale=0.1)}}
        x = _r(gen, B, N, C)
        w_aff = torch.softmax(_r(gen, B, N, T), -1)
        v_aff = torch.softmax(_r(gen, B, N, T), 1)
        got = tcmpc.graph_conv(tcmpc.stack_gconv([gp], torch.float32), x,
                               w_aff, v_aff)
        return got, tcmpc._graph_conv(gp, x, w_aff, v_aff)
    if name == "se_sum":
        feat = _r(gen, B, N, CM)
        others = [_r(gen, B, N, CM)]
        gates = [torch.sigmoid(_r(gen, B, CM))]
        ws, bs = [_r(gen, CM, CM, scale=0.3)], [_r(gen, CM, scale=0.1)]
        return (tcmpc.se_sum(feat, others, gates, ws, bs),
                kernels.se_sum_plain(feat, others, gates, ws, bs))
    p = _convlstm_params(gen)
    x, c, h = (_r(gen, B, 2, 3, CM) for _ in range(3))
    with torch.no_grad():
        got = tcmpc.convlstm_step_fused(p, x, c, h)
        want = tcmpc.convlstm_step_fused({**p, "tables": _unpadded_tables(p)},
                                         x, c, h, use_kernels=False)
    return torch.cat(got), torch.cat(want)


@pytest.mark.parametrize("name", ["apply_mutan", "affinity", "graph_conv",
                                  "se_sum", "convlstm_step_fused"])
def test_padding_function_matches_unpadded_plain(name):
    """Each function that pads for a kernel, at C 13, A 11 and CM 10 (padded
    to 16, 16 and 12), against the unpadded plain function: two-pass layer
    norms on the graph convolution's plain side (LN_TOL of
    tests/test_torch_kernels.py), else atol 1e-6."""
    with torch.no_grad():
        got, want = _pad_fn_case(name, torch.Generator().manual_seed(5))
    assert got.shape == want.shape
    tol = dict(rtol=2e-4, atol=2e-5) if name == "graph_conv" else EXACT
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


# ---------------------------------------------------------------------------
# the flagship at odd widths against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 3])
def test_odd_width_forward_matches_jax(size):
    """The flagship forward at v_emb_dim=13, vw_emb_dim=11, mlp_dim=10 from
    the raw and the prepared (padded) parameters, against JAX's apply_model
    at batch 1 and 3."""
    geo = {**MODEL_TINY, **ODD, "batch_size": size}
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    batch = _model_batch(size)
    jp, js = jinit(0, jcfg)
    want, _ = jax.jit(lambda p, s, b: japply(p, s, jcfg, b))(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tinit(0, tcfg, device="cpu")
    prepared = prepare_params(params, tcfg)
    assert prepared["graph_stack"]["wg"].shape == (3, CP, AP)
    assert prepared["levels"]["c3"]["mutan"]["w_wide"].shape == (24, 5 * CP)
    feed = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = tapply(params, tcfg, feed)
        again = tapply(prepared, tcfg, feed)
    np.testing.assert_allclose(got.sigm.numpy(), np.asarray(want.sigm),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(again.sigm.numpy(), got.sigm.numpy(), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def odd_step():
    """One JAX train step and one port step from seed 0 at the odd widths."""
    geo = {**TRAIN_TINY, **ODD}
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    batch = _train_batch(tcfg, np.random.default_rng(4))
    jstate = jtrain.create_train_state(0, jcfg)
    before = _snapshot(jstate)
    jstate, jm = jtrain.make_train_step(jcfg, grad_mode="tree")(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = ttrain.create_train_state(0, tcfg, device="cpu")
    tm = ttrain.make_train_step(tcfg)(state, batch)
    return before, _snapshot(jstate), jm, state, tm


def test_odd_width_train_step_matches_jax(odd_step):
    """Losses rtol 1e-5 and every gradient (from Adam's first moment) under
    tests/test_torch_train.py's `_check_grads`; the trainable leaves keep
    their JAX shapes (the padding is sliced off the gradients).  The gated
    exchanges' key biases, whose exact gradient is 0, are held as
    tests/test_torch_variants_train.py holds them: each side's at most
    1e-10 of the largest gradient."""
    before, after, jm, state, tm = odd_step
    for k in ("loss_main", "loss_cls_all", "loss_reg", "loss_total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    mu = _leaves(after["mu"])
    shapes = {p: tuple(v.shape) for p, v in _leaves(before["trainable"])
              .items()}
    got = {}
    for path, leaf in topt.named_leaves(state.trainable):
        assert tuple(leaf.shape) == shapes[path], path
        got[path] = state.optimizer.state[leaf]["exp_avg"].numpy() / 0.1
    want = {p: m / 0.1 for p, m in mu.items()}
    largest = max(np.abs(w).max() for w in want.values())
    zero = [p for p in want if p[-2:] == ("spa_graph_key", "biases")]
    assert len(zero) == 6
    for p in zero:
        for g in (got.pop(p), want.pop(p)):
            assert np.abs(g).max() <= 1e-10 * largest, p
    _check_grads(got, want)
