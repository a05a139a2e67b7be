"""The port's video model (CMPC_video_mm_tgraph_allvec) against the JAX
package's, in float32 on the CPU, at tests/test_video.py's TINY geometry
(8-frame clips, frames (0, 2, 4, 6, 7) sampled).

- The init, leaf for leaf: bit-equal from the same int seed;
  `convert.params_from_jax` of JAX's tree gives the same tensors.
- `_temp_graph`, `_temp_ctx` and `_gconv_dense` alone on the same inputs:
  1e-5.
- The whole forward at batch 1 and 2, front-padded with `valid_idx` and
  back-padded with `seq_len`: `sigm`, `up`, `pred`, `up_levels` and
  `words_parse` within atol 1e-4 (tests/test_torch_model.py's bound);
  `model.prepare_params`' view (with the spatial graph level by level)
  and the kernel route (the kernels' plain versions on the CPU) too.
- The mutan of a clip as one sample of F·h·w rows against B·F samples of
  h·w rows with the language broadcast per frame: equal.
- The bf16 plain route against float32: sigm within 0.05, the logits f32
  (tests/test_video.py:44-63).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import params_from_jax
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.models import model as tmodel
from cmpc_refseg_torch.models import video as tvideo
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import video as jvideo

torch.set_num_threads(2)

NAME = "CMPC_video_mm_tgraph_allvec"
TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=2,
            res4_blocks=2, num_frames=8, sampled_frames=(0, 2, 4, 6, 7))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def video_batch(size, text, seed=1):
    """Seeded clips of 8 frames and 3- and 5-word expressions (the last
    `size`): front-padded with 'valid_idx' or back-padded with 'seq_len'."""
    rng = np.random.default_rng(seed)
    lens = np.array([3, 5], np.int32)[-size:]
    words = np.zeros((size, 6), np.int32)
    for i, n in enumerate(lens):
        ids = rng.integers(3, 30, n)
        if text == "valid_idx":
            words[i, 6 - n:] = ids
        else:
            words[i, :n] = ids
    extra = {"valid_idx": 6 - lens} if text == "valid_idx" else \
        {"seq_len": lens}
    return {"clip": (20 * rng.standard_normal((size, 8, 32, 32, 3))
                     ).astype(np.float32), "words": words, **extra}


@pytest.fixture(scope="module")
def jax_model():
    cfg = jget(NAME, **TINY)
    params, state = jvideo.init_video_model(0, cfg)
    fwd = jax.jit(lambda p, s, b: jvideo.apply_video_model(p, s, cfg, b)[0])
    return cfg, params, state, fwd


@pytest.fixture(scope="module")
def port_params():
    return tmodel.init_model(0, tget(NAME, **TINY), device="cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_init_matches_jax(seed):
    jp, js = jvideo.init_video_model(seed, jget(NAME, **TINY))
    tp = tmodel.init_numpy(seed, tget(NAME, **TINY))
    want, got = dict(_leaves(jp)), dict(_leaves(tp))
    assert list(got) == list(want) and len(want) > 300
    for path, w in want.items():
        assert np.array_equal(got[path], np.asarray(w)), path
    assert js == {} and tmodel.init_model_state(
        tget(NAME, **TINY), device="cpu") == {}


def test_params_from_jax_of_a_video_tree(jax_model, port_params):
    cfg, jp = tget(NAME, **TINY), jax_model[1]
    got = dict(_leaves(params_from_jax(jp, cfg, device="cpu")))
    want = dict(_leaves(port_params))
    assert list(got) == list(want)
    for path, w in want.items():
        assert torch.equal(got[path], w), path


def _module_case(name, rng):
    """(port output, JAX output) of one temporal module of level c4's
    weights on seeded inputs."""
    jcfg = jget(NAME, **TINY)
    jp = jvideo.init_video_model(3, jcfg)[0]["levels"]["c4"]
    tp = _torch_tree(jp)
    b, f, c = 2, 5, 16
    if name == "temp_graph":
        mm = rng.standard_normal((b * f, 4, 4, c)).astype(np.float32)
        ac = rng.standard_normal((b, 1, 1, c)).astype(np.float32)
        return (tvideo._temp_graph(tp, _t(mm), _t(ac), b, f),
                jvideo._temp_graph(jp, jcfg, jnp.asarray(mm),
                                   jnp.asarray(ac), b, f))
    if name == "temp_ctx":
        mm = rng.standard_normal((b, 4, 4, c)).astype(np.float32)
        fv = rng.standard_normal((b, f, c)).astype(np.float32)
        return (tvideo._temp_ctx(tp, _t(mm), _t(fv)),
                jvideo._temp_ctx(jp, jcfg, jnp.asarray(mm), jnp.asarray(fv)))
    x = rng.standard_normal((b, f, c)).astype(np.float32)
    adj = np.asarray(jax.nn.softmax(rng.standard_normal((b, f, f)), -1),
                     np.float32)
    return (tvideo._gconv_dense(tp["tg_gconv"], _t(x), _t(adj)),
            jvideo._gconv_dense(jp["tg_gconv"], jnp.asarray(x),
                                jnp.asarray(adj)))


def _torch_tree(node):
    if isinstance(node, dict):
        return {k: _torch_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_torch_tree(v) for v in node]
    return _t(node)


@pytest.mark.parametrize("name", ["temp_graph", "temp_ctx", "gconv_dense"])
def test_temporal_modules_match_jax(name, rng):
    got, want = _module_case(name, rng)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _check(got, want, cfg):
    np.testing.assert_allclose(got.sigm.numpy(), np.asarray(want.sigm),
                               rtol=0, atol=1e-4)
    for name in ("up", "pred", "words_parse"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for lv in cfg.levels:
        np.testing.assert_allclose(got.up_levels[lv].numpy(),
                                   np.asarray(want.up_levels[lv]),
                                   rtol=1e-4, atol=1e-4, err_msg=lv)


@pytest.mark.parametrize("size", [1, 2])
@pytest.mark.parametrize("text", ["valid_idx", "seq_len"])
def test_forward_matches_jax(jax_model, port_params, size, text,
                             monkeypatch):
    """Both sides pack the spatial graph's levels at batch 1 and 2 (the
    port by `cmpc.pack_levels`).  The prepared parameters with the graph
    level by level (batch 2, valid_idx: `level_of` the prepared stack)
    and the kernel route (batch 1) give the same forward."""
    jcfg, jp, js, fwd = jax_model
    cfg = tget(NAME, **{**TINY, "batch_size": size})
    batch = video_batch(size, text)
    want = fwd(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    feed = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = tmodel.apply_model(port_params, cfg, feed, use_kernels=False)
        _check(got, want, cfg)
        assert got.model_state == {} and set(got.gw) == set(cfg.levels)
        if size == 2 and text == "valid_idx":
            monkeypatch.setattr(tcmpc, "LEVEL_PACK_MAX_BATCH", 1)
            assert not tcmpc.pack_levels(2, 3)
            prepared = tmodel.prepare_params(port_params, cfg)
            assert "w_wide" in prepared["levels"]["c3"]["mutan"]
            assert prepared["graph_stack"]["wg"].shape[0] == 3
            _check(tmodel.apply_model(prepared, cfg, feed), want, cfg)
        if size == 1:
            _check(tmodel.apply_model(port_params, cfg, feed), want, cfg)


def test_clip_mutan_equals_per_frame_mutan(port_params, rng):
    """The clip as one sample of F·h·w rows equals B·F samples of h·w rows
    with the clip's language vector repeated per frame."""
    p = port_params["levels"]["c4"]["mutan"]
    b, f, h, w, c = 2, 5, 4, 4, 16
    lat = _t(rng.standard_normal((b * f, h, w, c)))
    lang = _t(rng.standard_normal((b, 1, 1, 16)))
    grid = _t(rng.standard_normal((h, w, 8)))
    clip = tcmpc.apply_mutan(p, lang, grid.repeat(f, 1, 1)[None].expand(
        b, f * h, w, 8), lat.reshape(b, f * h, w, c))
    per_frame = tcmpc.apply_mutan(p, lang.repeat_interleave(f, 0),
                                  grid[None].expand(b * f, h, w, 8), lat)
    assert torch.equal(clip.reshape(b * f, h, w, c), per_frame)


def test_bf16_stays_close_to_f32(port_params):
    cfg32 = tget(NAME, **{**TINY, "batch_size": 1})
    cfg16 = cfg32.replace(compute_dtype="bfloat16")
    feed = {k: torch.from_numpy(v)
            for k, v in video_batch(1, "valid_idx").items()}
    with torch.inference_mode():
        o32 = tmodel.apply_model(port_params, cfg32, feed, use_kernels=False)
        o16 = tmodel.apply_model(port_params, cfg16, feed, use_kernels=False)
    assert o16.up.dtype == torch.float32
    assert float((o16.sigm - o32.sigm).abs().max()) < 0.05


def test_video_config_needs_the_video_forward(port_params):
    """apply_model hands a video config to the video forward; the image
    body and the video forward each refuse the other's config."""
    cfg = tget(NAME, **{**TINY, "batch_size": 1})
    feed = {k: torch.from_numpy(v)
            for k, v in video_batch(1, "seq_len").items()}
    with pytest.raises(ValueError, match="apply_video_model"):
        tmodel._apply_image(port_params, cfg, feed, model_state=None,
                            train=False, use_kernels=False)
    with pytest.raises(ValueError, match="not the video model"):
        tvideo.apply_video_model(port_params, tget("CMPC_model"), feed)
    with pytest.raises(ValueError, match="'clip'"):
        tvideo.apply_video_model(port_params, cfg, {"words": feed["words"]})
