"""The JAX package's public helpers that no model calls, against the port's
copies, on the CPU:

- the ConvGRU cell (`models/cmpc.py::init_convgru`, `convgru_step`; the
  reference's util/cell.py:82-143): the same draws from one int seed,
  and two steps from the same numpy parameters within atol 1e-5 of JAX's,
  bounded by 1 in magnitude (a convex combination of h and a tanh), the
  state moving on the second step (tests/test_readers.py:66-80);
- `ops/spatial.py::generate_bilinear_filter` for strides 1 to 4 and
  `spatial_feature_from_bbox` (util/processing_tools.py:19-22, :44-60),
  bit-equal to JAX's, and an out-of-range box failing the reference's
  assertion in both (tests/test_data.py:127-144).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.ops import spatial as tspatial
from cmpc_refseg_tpu.models import cmpc as jcmpc
from cmpc_refseg_tpu.ops import spatial as jspatial


class _Cfg:
    mlp_dim = 8
    vf_h = vf_w = 4


def _tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_convgru_init_matches_jax():
    assert _tree_equal(tcmpc.init_convgru(3, _Cfg), jcmpc.init_convgru(3, _Cfg))


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def test_convgru_steps_match_jax(rng):
    p = jcmpc.init_convgru(0, _Cfg)
    # gammas and betas off their init values, so the layer norms' affine
    # parts are exercised
    for ln in p["ln"]:
        ln["gamma"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
        ln["beta"] = (0.1 * rng.standard_normal(8)).astype(np.float32)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    step = jax.jit(jcmpc.convgru_step)
    pt, xt = _torch_tree(p), torch.from_numpy(x)
    h_j, h_t = jnp.zeros_like(x), torch.zeros(2, 4, 4, 8)
    outs = []
    for _ in range(2):
        h_j, h_t = step(p, jnp.asarray(x), h_j), tcmpc.convgru_step(pt, xt,
                                                                     h_t)
        assert h_t.shape == x.shape and torch.isfinite(h_t).all()
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0,
                                   atol=1e-5)
        assert h_t.abs().max() <= 1.0 + 1e-5
        outs.append(h_t)
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_bilinear_filter_matches_jax(stride):
    got = tspatial.generate_bilinear_filter(stride)
    want = jspatial.generate_bilinear_filter(stride)
    assert got.shape == (2 * stride, 2 * stride, 1, 1)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_spatial_feature_from_bbox_matches_jax(rng):
    boxes = np.stack([rng.integers(0, 40, 6), rng.integers(0, 30, 6),
                      rng.integers(40, 64, 6), rng.integers(30, 48, 6)], 1)
    for args in ((boxes, (64, 48)), ([[0, 0, 9, 19]], (10, 20))):
        got = tspatial.spatial_feature_from_bbox(*args)
        want = jspatial.spatial_feature_from_bbox(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_allclose(
        tspatial.spatial_feature_from_bbox([[0, 0, 9, 19]], (10, 20))[0],
        [-1.0, -1.0, 0.8, 0.9, -0.1, -0.05, 1.8, 1.9], atol=1e-9)


@pytest.mark.parametrize("box", [[0, 0, 10, 5], [0, 20, 5, 5]])
def test_spatial_feature_from_bbox_asserts_the_extent(box):
    for module in (tspatial, jspatial):
        with pytest.raises(AssertionError):
            module.spatial_feature_from_bbox([box], (10, 20))
