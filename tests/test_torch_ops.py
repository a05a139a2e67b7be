"""The port's core ops, backbone and text encoder against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
comparisons run in float32 on the CPU.  Tolerances: 1e-5 for single ops
(float32 rounding of one reduction, summed in another order), 1e-4
relative for the backbone (a chain of ~30 convolutions whose sums run in
other orders in oneDNN and XLA)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch import config as tconfig
from cmpc_refseg_torch.models import backbone as tbackbone
from cmpc_refseg_torch.models import language as tlanguage
from cmpc_refseg_torch.ops import layers as tlayers
from cmpc_refseg_torch.ops import normalization as tnorm
from cmpc_refseg_torch.ops import resize as tresize
from cmpc_refseg_torch.ops import spatial as tspatial
from cmpc_refseg_torch.convert import params_from_jax
from cmpc_refseg_tpu import config as jconfig
from cmpc_refseg_tpu.models import backbone as jbackbone
from cmpc_refseg_tpu.models import language as jlanguage
from cmpc_refseg_tpu.ops import layers as jlayers
from cmpc_refseg_tpu.ops import normalization as jnorm
from cmpc_refseg_tpu.ops import resize as jresize
from cmpc_refseg_tpu.ops import spatial as jspatial

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("k,stride,dilation,size", [
    (7, 2, 1, 32),     # conv1 7x7/2 on an even size: pads 2 before, 3 after
    (7, 2, 1, 33),
    (3, 2, 1, 16),
    (1, 2, 1, 16),     # strided 1x1 shortcut (res3a)
    (3, 1, 2, 12),     # atrous res4
    (3, 1, 4, 12),     # atrous res5
    (1, 1, 1, 8),      # 1x1 conv as a channel matmul
])
def test_conv2d_same_matches_jax(rng, k, stride, dilation, size):
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    p = {"DW": rng.standard_normal((k, k, 5, 4)).astype(np.float32),
         "biases": rng.standard_normal((4,)).astype(np.float32)}
    want = jlayers.conv2d({kk: jnp.asarray(v) for kk, v in p.items()},
                          jnp.asarray(x), stride=stride, dilation=dilation)
    got = tlayers.conv2d({kk: _t(v) for kk, v in p.items()}, _t(x),
                         stride=stride, dilation=dilation)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [16, 15, 160])
def test_max_pool_same_matches_jax(rng, size):
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    want = jlayers.max_pool(jnp.asarray(x), 3, 2)
    got = tlayers.max_pool(_t(x), 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_same_pads_flagship_geometry():
    """The asymmetric pads a symmetric `padding=` cannot express."""
    assert tlayers.same_pads(320, 7, 2) == (2, 3)        # conv1
    assert tlayers.same_pads(160, 3, 2) == (0, 1)        # pool1
    assert tlayers.same_pads(40, 3, 1, dilation=4) == (4, 4)


@pytest.mark.parametrize("axis", [-1, (1, 2, 3)])
def test_l2_normalize_matches_jax(rng, axis):
    x = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # zero row: the eps clamp
    want = jnorm.l2_normalize(jnp.asarray(x), axis)
    got = tnorm.l2_normalize(_t(x), axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tf1_layer_norm_matches_jax(rng):
    x = (3 + rng.standard_normal((2, 4, 5, 6))).astype(np.float32)
    g = rng.standard_normal((6,)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    want = jnorm.tf1_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tnorm.tf1_layer_norm(_t(x), _t(g), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("src,dst", [(4, 32), (5, 17), (8, 8), (40, 320)])
def test_resize_matches_jax(rng, src, dst):
    x = rng.standard_normal((2, src, src, 1)).astype(np.float32)
    want = jresize.resize_bilinear(jnp.asarray(x), dst, dst)
    got = tresize.resize_bilinear(_t(x), dst, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w", [(4, 4), (40, 40), (3, 7)])
def test_spatial_grid_matches_jax(h, w):
    want = jspatial.spatial_coordinate_grid(h, w)
    got = tspatial.spatial_coordinate_grid(h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_stream_matches_jax():
    """The numpy init copy draws exactly what the JAX package draws."""
    for seed in (0, 7):
        jk = jlayers.split_stream(seed, 3)
        tk = tlayers.split_stream(seed, 3)
        np.testing.assert_array_equal(
            tlayers.xavier_conv_init(tk[0], (3, 3, 4, 5)),
            jlayers.xavier_conv_init(jk[0], (3, 3, 4, 5)))
        np.testing.assert_array_equal(
            tlayers.glorot_uniform(tk[1], (6, 8)),
            jlayers.glorot_uniform(jk[1], (6, 8)))
        np.testing.assert_array_equal(
            tlayers.normal_init(tk[2], (4, 3)),
            jlayers.normal_init(jk[2], (4, 3)))


def test_config_copy_matches_jax():
    assert set(tconfig.VARIANTS) == set(jconfig.VARIANTS)
    for name, cfg in jconfig.VARIANTS.items():
        assert dataclasses.asdict(tconfig.VARIANTS[name]) == \
            dataclasses.asdict(cfg)
    assert tconfig.get_config("CMPC_model", H=64).vf_h == 8


def test_backbone_matches_jax(rng):
    jp = jbackbone.init_backbone(3, res4_blocks=2)
    cfg = tconfig.get_config("CMPC_model", res4_blocks=2)
    tp = params_from_jax({"backbone": jp, "levels": {lv: {} for lv in
                                                     cfg.levels}},
                         cfg, device="cpu")["backbone"]
    im = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jbackbone.apply_backbone(jp, jnp.asarray(im), res4_blocks=2)
    got = tbackbone.apply_backbone(tp, _t(im), res4_blocks=2)
    for tap in ("c2", "c3", "c4", "c5"):
        assert tuple(got[tap].shape) == want[tap].shape
        np.testing.assert_allclose(got[tap].numpy(), np.asarray(want[tap]),
                                   rtol=1e-4, atol=1e-4, err_msg=tap)


def test_lstm_encoder_matches_jax():
    cfg = tconfig.get_config("CMPC_model", num_steps=6, vocab_size=30,
                             glove_dim=8, rnn_size=16)
    jcfg = jconfig.get_config("CMPC_model", num_steps=6, vocab_size=30,
                              glove_dim=8, rnn_size=16)
    jp = jlanguage.init_text_encoder(5, jcfg)
    tp = {"embedding": _t(jp["embedding"]),
          "lstm": {k: _t(v) for k, v in jp["lstm"].items()}}
    words = np.zeros((3, 6), np.int32)
    words[0, :3] = [3, 4, 5]
    words[1, :6] = [6, 7, 8, 9, 10, 11]
    words[2, :1] = [12]
    seq_len = np.array([3, 6, 1], np.int32)
    want = jlanguage.encode_text(jp, jcfg, words=jnp.asarray(words),
                                 seq_len=jnp.asarray(seq_len))
    got = tlanguage.encode_text(tp, cfg, torch.from_numpy(words),
                                torch.from_numpy(seq_len))
    for field in ("words_feat", "lang_feat", "seq_mask", "parse_feat"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   **TOL, err_msg=field)
    # the numpy init of the port draws the same parameters
    np.testing.assert_array_equal(
        tlanguage.init_text_encoder(5, cfg)["lstm"]["kernel"],
        jp["lstm"]["kernel"])
