"""The kernels' plain versions at the widths past the main CUDA kernels,
against the JAX package's Pallas kernels in interpret mode.

On the card each of these shapes goes to a wrapper's wide form (the
affinity at A > 2048, the SE sum at C > 1024, the graph update at
C > 4096, the message where C > 4096 or C * T does not fit its plan, the
dz pass past its ring); tests/test_torch_gpu.py and chip_smoke.py hold
the wide forms against these plain versions there.  Here, on the CPU,
the wrappers run the plain versions, and each is held against the JAX
kernel that the JAX package runs at any width, as tests/test_pallas.py
runs it, on a few rows: the affinity at A = 2056 with and without the
l2-normalized projection, the SE sum at C = 1032, graph_msg and
graph_update at C = 4104, graph_msg at C = 4096 with T = 300 words, and
the mutan's dz pass (through the training function's backward) at
C = 4104 with 5 heads and C = 1030 with 8.  Float32 throughout.
Tolerances, those of tests/test_torch_kernels.py and
tests/test_torch_train.py for the same functions: 2e-5 (float32 sums in
other orders), the statistics' sums 2e-5 relative and 1e-3 absolute
(sums of squares over 4104 columns of O(1) values), the mutan's 3e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_tpu.ops import pallas_kernels as pk
from test_torch_train import _check_mutan_f32_residual, _mutan_case

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
STATS_TOL = dict(rtol=2e-5, atol=1e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("l2n,masked", [(True, True), (False, True),
                                        (False, False)])
def test_affinity_past_one_cluster_matches_pallas(rng, l2n, masked):
    """A = 2056: more projection columns than the CUDA kernel's cluster
    of 8 x 256 covers; the l2n row norm spans all of them."""
    b, n, c, a, t = 2, 16, 24, 2056, 6
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wg = (0.2 * rng.standard_normal((c, a))).astype(np.float32)
    bg = (0.1 * rng.standard_normal((a,))).astype(np.float32)
    wt = (rng.standard_normal((b, t, a)) / np.sqrt(a)).astype(np.float32)
    rel = rng.random((b, 1, t)).astype(np.float32)
    mask = np.ones((b, 1, t), np.float32)
    mask[1, :, 4:] = 0
    args = (x, wg, bg, wt, rel, mask)
    want = pk.spa_affinity_fused(*map(jnp.asarray, args), scale=c ** 0.5,
                                 l2n=l2n, masked_softmax=masked,
                                 interpret=True)
    got = kernels.spa_affinity(*map(_t, args), scale=c ** 0.5, l2n=l2n,
                               masked=masked)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_se_sum_past_one_cluster_matches_pallas(rng):
    """C = 1032: a row wider than the CUDA kernel's cluster of 8 x 128."""
    b, n, c, k = 2, 16, 1032, 2
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    others = [rng.standard_normal((b, n, c)).astype(np.float32)
              for _ in range(k)]
    gates = [rng.random((b, c)).astype(np.float32) for _ in range(k)]
    ws = [(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
          for _ in range(k)]
    bs = [(0.1 * rng.standard_normal((c,))).astype(np.float32)
          for _ in range(k)]
    want = pk.se_sum_fused(jnp.asarray(feat),
                           *[list(map(jnp.asarray, v))
                             for v in (others, gates, ws, bs)],
                           interpret=True)
    got = kernels.se_sum(_t(feat), *[list(map(_t, v))
                                     for v in (others, gates, ws, bs)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _msg_case(rng, b, n, c, t):
    wa = np.abs(rng.standard_normal((b, n, t))).astype(np.float32) / t
    pooled = rng.standard_normal((b, t, c)).astype(np.float32)
    j_msg, j_st = pk._graph_msg_call(jnp.asarray(wa.reshape(b * n, t)),
                                     jnp.asarray(pooled), bsz=b, n=n, c=c,
                                     t=t, tiles=1, interpret=True)
    msg, st = kernels.graph_msg(_t(wa), _t(pooled))
    np.testing.assert_allclose(msg.numpy().reshape(b * n, c),
                               np.asarray(j_msg), **TOL)
    np.testing.assert_allclose(st.sum(1).numpy(),
                               np.asarray(j_st)[:, :2, 0], **STATS_TOL)
    return msg, st, j_msg, j_st


@pytest.mark.parametrize("c,t", [pytest.param(4104, 6, id="C4104"),
                                 pytest.param(4096, 300, id="C4096-T300")])
def test_graph_msg_past_its_plan_matches_pallas(rng, c, t):
    """C = 4104: wider than the CUDA message kernel stages a row; C = 4096
    with T = 300 words: its staging and pooled boxes past shared memory."""
    _msg_case(rng, 2, 8, c, t)


def test_graph_update_past_its_affine_matches_pallas(rng):
    """C = 4104: LN1's gamma and beta past what the CUDA update kernel
    stages in shared memory; msg and its statistics from the message."""
    b, n, c, t = 2, 8, 4104, 6
    msg, st, j_msg, j_st = _msg_case(rng, b, n, c, t)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((c,))).astype(np.float32)
    g1 = (1 + 0.1 * rng.standard_normal((c,))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((c,))).astype(np.float32)
    j_z, j_st2 = pk._graph_update_call(
        jnp.asarray(x.reshape(b * n, c)), j_msg, j_st, jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(g1), jnp.asarray(b1), bsz=b, n=n, c=c,
        tiles=1, interpret=True)
    z, st2 = kernels.graph_update(_t(x), msg, st, _t(w), _t(bias), _t(g1),
                                  _t(b1))
    np.testing.assert_allclose(z.numpy().reshape(b * n, c), np.asarray(j_z),
                               **TOL)
    np.testing.assert_allclose(st2.sum(1).numpy(),
                               np.asarray(j_st2)[:, :2, 0], **STATS_TOL)


@pytest.mark.parametrize("c,nh", [pytest.param(4104, 5, id="C4104-5heads"),
                                  pytest.param(1030, 8, id="C1030-8heads")])
def test_mutan_dz_past_its_ring_matches_pallas(rng, c, nh):
    """The dz pass (MutanFunction's backward: dz, dlang, db, then dx and
    dW from dz) at heads * C past the CUDA dz kernel's ring, against JAX's
    fused backward with an f32 residual, as tests/test_torch_train.py
    holds it at the registry's widths."""
    _check_mutan_f32_residual(*_mutan_case(rng, 2, 8, k=16, c=c, nh=nh))
