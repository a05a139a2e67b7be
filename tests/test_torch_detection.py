"""The detection head of CMPCv5_plus_model, its label assigner, the anchor
file reader and the other losses against the JAX package, in float32 on
the CPU.

Tolerances: the head's decode and the losses atol 1e-5 relative to their
scale (float32, a few operations); gradients rtol 1e-5 / atol 1e-6; the
label assigner and the anchor reader exactly (the same numpy code)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.data import anchors as tanchors
from cmpc_refseg_torch.models import detection as tdet
from cmpc_refseg_torch.ops import losses as tlosses
from cmpc_refseg_torch.utils import io as tio
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.data import anchors as janchors
from cmpc_refseg_tpu.models import detection as jdet
from cmpc_refseg_tpu.ops import losses as jlosses
from cmpc_refseg_tpu.utils import io as jio

torch.set_num_threads(2)

S, A, MLP, STRIDE, SIZE = 4, 3, 12, 8, 32


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _head(rng):
    cfg = jget("CMPCv5_plus_model", mlp_dim=MLP)
    p = jdet.init_bbox_head(jax.random.PRNGKey(0), cfg)
    p = jax.tree.map(np.asarray, p)
    p["conv"]["biases"] = (0.1 * rng.standard_normal(A * 5)).astype(
        np.float32)
    fused = rng.standard_normal((2, S, S, MLP)).astype(np.float32)
    return p, fused


def _torch_head(p):
    return {"conv": {k: _t(v) for k, v in p["conv"].items()}}


def test_init_bbox_head_matches_jax():
    from cmpc_refseg_torch.config import get_config as tget
    from cmpc_refseg_tpu.ops.layers import split_stream as jsplit
    from cmpc_refseg_torch.ops.layers import split_stream as tsplit
    jp = jdet.init_bbox_head(jsplit(3, 1)[0], jget("CMPCv5_plus_model",
                                                   mlp_dim=MLP))
    tp = tdet.init_bbox_head(tsplit(3, 1)[0], tget("CMPCv5_plus_model",
                                                   mlp_dim=MLP))
    assert tp["conv"]["DW"].shape == (3, 3, MLP, A * 5)
    for k in ("DW", "biases"):
        np.testing.assert_array_equal(tp["conv"][k], np.asarray(jp["conv"][k]))


def test_apply_bbox_head_matches_jax(rng):
    """raw [2, S, S, A, 5] and the decode: xy = (cell + sigmoid) * stride in
    x, y order, wh = anchor * exp(clip(t, -10, 8)) * stride, conf =
    sigmoid."""
    p, fused = _head(rng)
    raw_j, dec_j = jdet.apply_bbox_head(p, jnp.asarray(fused),
                                        janchors.DEFAULT_ANCHORS,
                                        stride=STRIDE)
    raw, dec = tdet.apply_bbox_head(_torch_head(p), _t(fused),
                                    tanchors.DEFAULT_ANCHORS, stride=STRIDE)
    assert raw.shape == dec.shape == (2, S, S, A, 5)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), rtol=1e-5,
                               atol=1e-4)
    # cell (row 2, column 1) decodes to x in [8, 16), y in [16, 24)
    assert 8 <= dec[0, 2, 1, 0, 0] < 16 and 16 <= dec[0, 2, 1, 0, 1] < 24
    big = tdet.apply_bbox_head(
        {"conv": {"DW": torch.zeros(3, 3, MLP, A * 5),
                  "biases": torch.full((A * 5,), 50.0)}}, _t(fused),
        tanchors.DEFAULT_ANCHORS, stride=STRIDE)[1]
    np.testing.assert_allclose(big[0, 0, 0, :, 2].numpy(),
                               np.exp(8.0) * tanchors.DEFAULT_ANCHORS[:, 0]
                               * STRIDE, rtol=1e-6)


def _boxes(rng, shape):
    xy = rng.uniform(0, SIZE, shape + (2,))
    wh = rng.uniform(1, SIZE / 2, shape + (2,))
    return np.concatenate([xy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["_iou_xywh", "_giou_xywh"])
def test_iou_and_giou_match_jax(rng, fn):
    a, b = _boxes(rng, (50,)), _boxes(rng, (50,))
    b[:5] = a[:5]                                   # identical boxes
    b[5:10, :2] = a[5:10, :2] + 100                 # disjoint boxes
    got = getattr(tdet, fn)(_t(a), _t(b)).numpy()
    want = np.asarray(getattr(jdet, fn)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:5], 1.0, rtol=1e-5)
    assert (got[5:10] <= 0).all() and (got[5:10] >= -1).all()


def _labels(rng, b=2):
    """`preprocess_true_boxes` labels of one seeded corner box per sample
    (the JAX package's, as the v5+ train script makes them)."""
    out = []
    for _ in range(b):
        x1, y1 = rng.uniform(0, SIZE / 2, 2)
        x2, y2 = x1 + rng.uniform(4, SIZE / 2), y1 + rng.uniform(4, SIZE / 2)
        out.append(janchors.preprocess_true_boxes(
            [[x1, y1, x2, y2]], SIZE, janchors.DEFAULT_ANCHORS))
    return (np.stack([o[0] for o in out]).astype(np.float32),
            np.stack([o[1] for o in out]).astype(np.float32))


def test_bbox_loss_and_gradient_match_jax(rng):
    """The loss of the head on `fused` against seeded labels, and its
    gradient with respect to the head's kernel, bias and `fused`."""
    p, fused = _head(rng)
    label, true = _labels(rng)
    assert label[..., 4].sum() >= 2

    def jloss(params, f):
        raw, dec = jdet.apply_bbox_head(params, f, janchors.DEFAULT_ANCHORS,
                                        stride=STRIDE)
        return jdet.bbox_loss(raw, dec, jnp.asarray(label), jnp.asarray(true),
                              input_size=SIZE)

    want, (jg, jgf) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(fused))
    tp = _torch_head(p)
    for v in tp["conv"].values():
        v.requires_grad_()
    f = _t(fused).requires_grad_()
    raw, dec = tdet.apply_bbox_head(tp, f, tanchors.DEFAULT_ANCHORS,
                                    stride=STRIDE)
    got = tdet.bbox_loss(raw, dec, _t(label), _t(true), input_size=SIZE)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("DW", "biases"):
        np.testing.assert_allclose(tp["conv"][k].grad.numpy(),
                                   np.asarray(jg["conv"][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgf), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("box", [[3.0, 5.0, 27.0, 30.0], [10.0, 10.0, 11.5,
                                                          12.0],
                                 [0.0, 0.0, 31.0, 6.0],
                                 [250.0, 250.0, 300.0, 310.0]])
def test_preprocess_true_boxes_matches_jax(box):
    """Big, tiny (no anchor above IoU 0.3: the best one takes it), flat and
    out-of-grid (clipped to the last cell) boxes."""
    got = tanchors.preprocess_true_boxes([box], SIZE,
                                         tanchors.DEFAULT_ANCHORS)
    want = janchors.preprocess_true_boxes([box], SIZE,
                                          janchors.DEFAULT_ANCHORS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][..., 4].sum() >= 1
    two = [[3.0, 5.0, 20.0, 22.0], box]
    for g, w in zip(tanchors.preprocess_true_boxes(two, SIZE,
                                                   tanchors.DEFAULT_ANCHORS,
                                                   max_bbox_per_scale=2),
                    janchors.preprocess_true_boxes(two, SIZE,
                                                   janchors.DEFAULT_ANCHORS,
                                                   max_bbox_per_scale=2)):
        np.testing.assert_array_equal(g, w)


def test_bbox_iou_and_anchors_match_jax(rng):
    a, b = _boxes(rng, (7,)), _boxes(rng, (7,))
    np.testing.assert_array_equal(tanchors.bbox_iou_xywh(a, b),
                                  janchors.bbox_iou_xywh(a, b))
    np.testing.assert_array_equal(tanchors.DEFAULT_ANCHORS,
                                  janchors.DEFAULT_ANCHORS)


@pytest.mark.parametrize("text", ["4.38,4.50 28.66,17.64 13.23,13.48\n",
                                  "4.38,4.50\n28.66,17.64\n13.23,13.48\n"])
def test_read_anchors_matches_jax(tmp_path, text):
    path = tmp_path / "anchors.txt"
    path.write_text(text)
    got = tio.read_anchors(str(path))
    assert got.shape == (3, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.read_anchors(str(path)))


def test_io_helpers_round_trip(tmp_path):
    names, obj = ["a b", "c"], {"x": [1, 2], "y": "z"}
    tio.save_str_list(names, tmp_path / "n.txt")
    assert tio.load_str_list(tmp_path / "n.txt") == names
    assert jio.load_str_list(tmp_path / "n.txt") == names
    tio.save_json(obj, tmp_path / "o.json")
    assert tio.load_json(tmp_path / "o.json") == obj
    assert (tmp_path / "o.json").read_text() == (
        jio.save_json(obj, tmp_path / "p.json")
        or (tmp_path / "p.json").read_text())


@pytest.mark.parametrize("name", ["dsc_loss", "iou_loss", "iou_with_threshold",
                                  "smooth_l1_loss"])
def test_losses_match_jax(rng, name):
    """The four losses and (but for the thresholded IoU) their gradients;
    smooth L1 across its |d| = 1 branch point, its branch selector taking
    no gradient."""
    if name == "smooth_l1_loss":
        a = rng.uniform(-3, 3, (6, 4)).astype(np.float32)
        b = rng.uniform(-3, 3, (6, 4)).astype(np.float32)
    else:
        a = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
        b = (rng.random((2, 5, 5, 1)) > 0.5).astype(np.float32)
        if name == "iou_with_threshold":
            b = rng.random((2, 5, 5, 1)).astype(np.float32)
            a = rng.random((2, 5, 5, 1)).astype(np.float32)
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    ta = _t(a).requires_grad_()
    got = tfn(ta, _t(b))
    want = jfn(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    if name == "iou_with_threshold":
        assert not got.requires_grad
        return
    got.backward()
    jgrad = jax.grad(lambda x: jfn(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
