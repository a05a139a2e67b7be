"""The port's whole forward, weights and entry points against the JAX package.

The flagship CMPC_model at the TINY geometry of tests/test_model.py with
batch 3 and batch 1.  The port packs the spatial graph's levels at both
(its rule, `cmpc.pack_levels`, set on the H100); the JAX package runs
batch 3 level by level and packs batch 1.  The JAX side runs both as plain
XLA and with every forward Pallas kernel in interpret mode.  Comparisons in float32 on the CPU: `sigm` within atol 1e-4 (the
acceptance bound); the logits within 1e-4 (float32 sums in other orders
through ~40 layers)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.api import build_model
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import params_from_jax
from cmpc_refseg_torch.models import cmpc as tcmpc
from cmpc_refseg_torch.models.model import apply_model as tapply
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.models.model import prepare_params
from cmpc_refseg_torch.ops import kernels
from cmpc_refseg_torch.ops import normalization as tnorm
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import cmpc as jcmpc
from cmpc_refseg_tpu.models.model import apply_model as japply
from cmpc_refseg_tpu.models.model import init_model as jinit

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=3,
            res4_blocks=2)
REPO = Path(__file__).resolve().parent.parent


def _batch(size=3):
    rng = np.random.default_rng(1)
    words = np.zeros((3, 6), np.int32)
    words[0, :3] = [3, 4, 5]
    words[1, :2] = [6, 7]
    words[2, :6] = [8, 9, 10, 11, 12, 13]
    batch = {"im": (20 * rng.standard_normal((3, 32, 32, 3))
                    ).astype(np.float32),
             "words": words, "seq_len": np.array([3, 2, 6], np.int32)}
    return {k: v[-size:] for k, v in batch.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _long_batch(size, steps):
    """`size` expressions of up to `steps` words (the longest fills them)."""
    rng = np.random.default_rng(4)
    lens = np.array([steps, steps - 7, 9], np.int32)[-size:]
    words = np.zeros((size, steps), np.int32)
    for i, n in enumerate(lens):
        words[i, :n] = rng.integers(3, 30, n)
    return {"im": (20 * rng.standard_normal((size, 32, 32, 3))
                   ).astype(np.float32), "words": words, "seq_len": lens}


def _check_forward(monkeypatch, jax_mode, size, steps=TINY["num_steps"]):
    if jax_mode == "interpret":
        monkeypatch.setenv("CMPC_FUSED", "interpret")
    else:
        monkeypatch.delenv("CMPC_FUSED", raising=False)
    geo = {**TINY, "batch_size": size, "num_steps": steps}
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    batch = _batch(size) if steps == TINY["num_steps"] else \
        _long_batch(size, steps)
    jp, js = jinit(0, jcfg)
    want, _ = jax.jit(lambda p, s, b: japply(p, s, jcfg, b))(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got = tapply(tinit(0, tcfg, device="cpu"), tcfg,
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.sigm.numpy(), np.asarray(want.sigm),
                               rtol=0, atol=1e-4)
    for name in ("up", "pred", "words_parse"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for lv in jcfg.levels:
        np.testing.assert_allclose(got.up_levels[lv].numpy(),
                                   np.asarray(want.up_levels[lv]),
                                   rtol=1e-4, atol=1e-4, err_msg=lv)
        for g, w in zip(got.gw[lv], want.gw[lv]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5, err_msg=f"gw {lv}")


@pytest.mark.parametrize("jax_mode", ["xla", "interpret"])
def test_forward_matches_jax(monkeypatch, jax_mode):
    """Batch 3: the JAX package's per-level spatial graph against the
    port's packed one."""
    _check_forward(monkeypatch, jax_mode, 3)


@pytest.mark.parametrize("jax_mode", ["xla", "interpret"])
def test_forward_per_level_matches_jax(monkeypatch, jax_mode):
    """Batch 3 with the port's spatial graph level by level (its form above
    the packing threshold), as the JAX package runs it there."""
    monkeypatch.setattr(tcmpc, "LEVEL_PACK_MAX_BATCH", 2)
    assert not tcmpc.pack_levels(3, 3)
    _check_forward(monkeypatch, jax_mode, 3)


@pytest.mark.parametrize("jax_mode", ["xla", "interpret"])
def test_forward_batch1_matches_jax(monkeypatch, jax_mode):
    """Batch 1, the serving batch: the level-packed spatial graph on both
    sides (the grouped kernels in JAX's interpret mode)."""
    assert tcmpc.pack_levels(1, 3)
    _check_forward(monkeypatch, jax_mode, 1)


@pytest.mark.parametrize("size", [1, 3])
def test_forward_long_expressions_match_jax(monkeypatch, size):
    """num_steps = 40, more words than one 32-word chunk of the affinity
    and message kernels: batch 1 with the levels packed, batch 3 level by
    level (the port's form above the packing threshold)."""
    if size == 3:
        monkeypatch.setattr(tcmpc, "LEVEL_PACK_MAX_BATCH", 2)
    assert tcmpc.pack_levels(size, 3) == (size == 1)
    _check_forward(monkeypatch, "xla", size, steps=40)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32))


def test_exchange_step_matches_jax_and_module():
    """The fused-form exchange step (SE-sum + row l2norm) against JAX's
    and against the reference-shaped module."""
    geo = dict(mlp_dim=12, rnn_size=16)
    jcfg, tcfg = jget("CMPC_model", **geo), tget("CMPC_model", **geo)
    pex = jcmpc.init_exchange(5, jcfg, 2)
    rng = np.random.default_rng(2)
    feat, o1, o2 = (rng.standard_normal((2, 4, 4, 12)).astype(np.float32)
                    for _ in range(3))
    lang = rng.standard_normal((2, 1, 1, 16)).astype(np.float32)
    want = jcmpc.exchange_step_normed(pex, jcfg, jnp.asarray(feat),
                                      [jnp.asarray(o1), jnp.asarray(o2)],
                                      jnp.asarray(lang))
    tp = _to_torch(pex)
    args = (torch.from_numpy(feat), [torch.from_numpy(o1),
                                     torch.from_numpy(o2)],
            torch.from_numpy(lang))
    got = tcmpc.exchange_step_normed(tp, tcfg, *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    module = tnorm.l2_normalize(tcmpc.apply_exchange(tp, tcfg, *args), -1)
    np.testing.assert_allclose(module.numpy(), got.numpy(), rtol=2e-5,
                               atol=2e-6)


def test_convlstm_step_matches_jax():
    """The port's ConvLSTM step (the fused form, its only one) against the
    JAX package's plain step."""
    cfg_kw = dict(H=64, W=64, mlp_dim=12)
    p = jcmpc.init_convlstm(6, jget("CMPC_model", **cfg_kw))
    rng = np.random.default_rng(3)
    x, c, h = (rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
               for _ in range(3))
    want = jcmpc.convlstm_step(p, *map(jnp.asarray, (x, c, h)))
    got = tcmpc.convlstm_step_fused(_to_torch(p), *map(torch.from_numpy,
                                                       (x, c, h)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_plain_route_matches_kernel_route_on_cpu():
    """apply_model(..., use_kernels=False) (the reference the CUDA kernels
    are held against on the card) computes the same forward as the kernel wrappers' CPU
    path."""
    cfg = tget("CMPC_model", **TINY)
    params = tinit(0, cfg, device="cpu")
    feed = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.inference_mode():
        a = tapply(params, cfg, feed)
        b = tapply(params, cfg, feed, use_kernels=False)
    np.testing.assert_allclose(a.sigm.numpy(), b.sigm.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("max_batch", [3, 2])
def test_prepared_params_give_the_same_forward(monkeypatch, max_batch):
    """prepare_params builds the head's kernel weights once (the stacked
    spatial graph, the SE and ConvLSTM tables); the forward from them is
    the forward that builds them on each call, on both graph paths
    (batch 3 packed, then level by level)."""
    cfg = tget("CMPC_model", **TINY)
    params = tinit(0, cfg, device="cpu")
    prepared = prepare_params(params, cfg)
    stack = prepared["graph_stack"]
    assert stack["wg"].shape == (3, 16, 16)
    assert stack["gconv"][0]["g2"].shape == (3, 16)
    assert prepared["fusion_stack"]["convlstm"]["tables"]["co"].shape == \
        (16, 12)
    monkeypatch.setattr(tcmpc, "LEVEL_PACK_MAX_BATCH", max_batch)
    feed = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.inference_mode():
        a = tapply(prepared, cfg, feed)
        b = tapply(params, cfg, feed)
    assert torch.equal(a.sigm, b.sigm)


@pytest.mark.parametrize("seed", [0, 3])
def test_init_matches_params_from_jax(seed):
    """The port's numpy init reproduces JAX's init_model draw for draw, and
    params_from_jax converts JAX's tree to the same tensors."""
    cfg = tget("CMPC_model", **TINY)
    jp, _ = jinit(seed, jget("CMPC_model", **TINY))
    mine = dict(_leaves(tinit(seed, cfg, device="cpu")))
    theirs = dict(_leaves(params_from_jax(jp, cfg, device="cpu")))
    assert mine.keys() == theirs.keys() and len(mine) > 200
    for k in mine:
        assert mine[k].dtype == torch.float32
        assert torch.equal(mine[k], theirs[k]), k
    # backbone kernels are OIHW in the port, HWIO in JAX
    w = np.asarray(jp["backbone"]["conv1"]["w"])
    np.testing.assert_array_equal(mine["/backbone/conv1/w"].numpy(),
                                  w.transpose(3, 2, 0, 1))


def test_params_from_jax_rejects_another_depth():
    jp, _ = jinit(0, jget("CMPC_model", **TINY))
    with pytest.raises(ValueError, match="res4_blocks"):
        params_from_jax(jp, tget("CMPC_model", **{**TINY, "res4_blocks": 3}),
                        device="cpu")


def test_build_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("CMPC_model", **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("CMPC_model", device="cuda", **TINY)
    # the model-level route (init_model -> prepare_params -> apply_model)
    # keeps the same rule
    cfg = tget("CMPC_model", **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinit(0, cfg)
    jp, _ = jinit(0, jget("CMPC_model", **TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(jp, cfg)


def test_build_model_on_cpu_runs_without_kernel_launches():
    model = build_model("CMPC_model", device="cpu", **TINY)
    kernels.reset_launch_counts()
    out = model.forward(_batch())
    assert tuple(out.sigm.shape) == (3, 32, 32, 1)
    assert torch.isfinite(out.up).all()
    assert set(kernels.launch_counts().values()) == {0}
    # bf16 on the CPU runs the same plain path in the compute dtype
    bf = build_model("CMPC_model", device="cpu", dtype="bfloat16", **TINY)
    assert bf.params["levels"]["c3"]["mutan"]["w_wide"].dtype == \
        torch.bfloat16
    out_bf = bf.forward(_batch())
    assert float((out_bf.sigm - out.sigm).abs().max()) < 0.05


def test_unported_variant_raises():
    """No config is refused any more: the video model, the last one
    refused, inits and runs forward on the CPU (held against JAX in
    tests/test_torch_video.py); the sentence-conditioned fusion and the
    detection head init on the CPU (held against JAX in
    tests/test_torch_plus.py)."""
    cfg = tget("CMPC_video_mm_tgraph_allvec",
               **{**TINY, "batch_size": 1, "num_frames": 8,
                  "sampled_frames": (0, 2, 4, 6, 7)})
    params = tinit(0, cfg, device="cpu")
    assert set(params["levels"]["c4"]) >= {"mutan", "tg_gconv", "graph"}
    words = np.zeros((1, 6), np.int32)
    words[0, :3] = [3, 4, 5]
    with torch.inference_mode():
        out = tapply(params, cfg, {
            "clip": torch.zeros(1, 8, 32, 32, 3),
            "words": torch.from_numpy(words),
            "seq_len": torch.tensor([3])})
    assert out.sigm.shape == (1, 32, 32, 1)
    assert out.words_parse.shape == (1, 1, 6, 5)
    for name in ("CMPCv6_plus_model", "CMPCv5_plus_model"):
        params = tinit(0, tget(name, **TINY), device="cpu")
        assert ("sent_mutan" in params["levels"]["c4"]) == (
            name == "CMPCv6_plus_model")
        assert ("bbox" in params) == (name == "CMPCv5_plus_model")


def test_port_imports_nothing_of_jax():
    """The port and its chip smoke test stand alone: no jax import and no
    reference to the JAX package (chip_smoke.py's JSON line may name the
    TPU kernel each kernel replaces)."""
    banned = re.compile(r"^\s*(import|from)\s+jax\b|cmpc_refseg_tpu", re.M)
    replaces = re.compile(r'"cmpc_refseg_tpu/ops/pallas_kernels\.py:\d+"')
    files = sorted((REPO / "cmpc_refseg_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if banned.search(replaces.sub("", f.read_text()))]
    assert offenders == []


def test_kernels_have_no_switch():
    """Kernels are chosen by tensor device only: the port reads no
    environment variable but CUDA_HOME, which locates nvcc, and, in
    parallel/mesh.py alone, torchrun's LOCAL_RANK, which names a data-
    parallel process's card."""
    launcher = {REPO / "cmpc_refseg_torch" / "parallel" / "mesh.py":
                {"LOCAL_RANK"}}
    for f in (REPO / "cmpc_refseg_torch").rglob("*.py"):
        text = f.read_text()
        assert "getenv" not in text, f
        assert set(re.findall(r'os\.environ\S*?"(\w+)"', text)) <= \
            {"CUDA_HOME"} | launcher.get(f, set()), f
