"""The port's checkpoints, its checkpointed train loop and the bridges from
JAX package and TF checkpoints, on the CPU at the TINY geometry.

- A saved state restores bit-equal into a state built from another seed
  (trainable weights, Adam's moments and count, the float32 frozen
  backbone, the BN moving statistics, the step), in float32 and bfloat16,
  and a bf16 checkpoint into a float32 state; a restored run takes the
  steps an unbroken one takes, bit for bit (with the brightness
  augmentation, whose draw follows the step).
- The file layout: the newest `max_to_keep` steps stay, a temporary file
  left by a killed save is never a step, a config mismatch raises.
- `train_loop`: snapshots, `start_iter`, `val_fn` under 'val_*', the save
  at SIGTERM (tests/test_train.py::TestPreemption's case).
- JAX's `train_loop` saves an orbax checkpoint after 2 of 3 steps;
  tools/jax_checkpoint_to_torch.py converts it and the port takes the
  third step from it, held to tests/test_torch_train.py's tolerances
  against JAX's third step; the gated exchanges' key biases, whose exact
  gradient is 0, as tests/test_torch_variants_train.py holds them (each
  side's at most 1e-10 of the largest gradient).
- The BiLSTM and BERT text trees go through `params_from_jax` and a
  checkpoint round trip.
- A synthetic TF checkpoint (written by the helpers of
  tests/test_converter.py; CMPC_model, CMPCv4_model and the BiLSTM's
  CMPCv4_BiLSTM_T_model) goes through tools/tf_checkpoint_to_torch.py
  and through `convert.params_from_npz`; the port's forward from each
  matches JAX's from the converter's trees within 1e-4.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import (model_state_from_jax, params_from_jax,
                                       params_from_npz)
from cmpc_refseg_torch.models.model import apply_model as tapply
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.train import checkpoint as tck
from cmpc_refseg_torch.train import trainer as ttrain
from cmpc_refseg_torch.train.optimizer import named_leaves
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import apply_model as japply
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.train import trainer as jtrain
from tools import jax_checkpoint_to_torch, tf_checkpoint_to_torch

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=2,
            res4_blocks=2, lr_decay_step=1000)


class Reader:
    """Seeded collated batches, as both train loops read them; SIGTERM at
    the read numbered `kill_at`."""

    def __init__(self, cfg, seed=5, kill_at=None):
        self.cfg, self.rng, self.reads = cfg, np.random.default_rng(seed), 0
        self.kill_at, self.batches = kill_at, []

    def read_collated(self, bs):
        self.reads += 1
        if self.reads == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        cfg, rng = self.cfg, self.rng
        text = np.zeros((bs, cfg.num_steps), np.int64)
        text[:, :3] = rng.integers(3, cfg.vocab_size, (bs, 3))
        out = {"im_batch": rng.integers(0, 256, (bs, cfg.H, cfg.W, 3),
                                        dtype=np.uint8),
               "mask_batch": rng.random((bs, cfg.H, cfg.W)) > 0.6,
               "text_batch": text, "seq_length": np.full((bs,), 3)}
        self.batches.append(out)
        return out


class Logger:
    def __init__(self):
        self.rows = []

    def log(self, it, metrics):
        self.rows.append((it, metrics))


def _batches(cfg, n, seed=6):
    reader = Reader(cfg, seed)
    return [ttrain.prepare_image_batch_u8(reader.read_collated(
        cfg.batch_size)) for _ in range(n)]


def _leaves(state):
    """Every saved quantity of a state, by name and path."""
    adam = state.optimizer.state
    out = {("step",): torch.tensor(state.step)}
    for path, p in named_leaves(state.trainable):
        out[("trainable",) + path] = p.detach()
        if p in adam:
            out[("exp_avg",) + path] = adam[p]["exp_avg"]
            out[("exp_avg_sq",) + path] = adam[p]["exp_avg_sq"]
            out[("adam_step",) + path] = adam[p]["step"]
    for name in ("frozen", "frozen_f32", "model_state"):
        for path, leaf in named_leaves(getattr(state, name)):
            out[(name,) + path] = leaf
    return out


def _assert_bit_equal(got, want):
    a, b = _leaves(got), _leaves(want)
    assert set(a) == set(b) and len(a) > 100
    bad = [k for k in b if a[k].dtype != b[k].dtype
           or not torch.equal(a[k], b[k])]
    assert bad == []


@pytest.fixture(scope="module")
def stepped():
    """{(name, dtype): (cfg, a state after one step)} for CMPC_model in
    float32 and bfloat16 and CMPCv4_model (BN statistics moved)."""
    out = {}
    for name, dtype in (("CMPC_model", "float32"),
                        ("CMPC_model", "bfloat16"),
                        ("CMPCv4_model", "float32")):
        cfg = tget(name, **TINY, compute_dtype=dtype)
        state = ttrain.create_train_state(0, cfg, device="cpu")
        ttrain.make_train_step(cfg)(state, _batches(cfg, 1)[0])
        out[name, dtype] = state
    return out


@pytest.mark.parametrize("name,dtype", [("CMPC_model", "float32"),
                                        ("CMPC_model", "bfloat16"),
                                        ("CMPCv4_model", "float32")])
def test_round_trip_is_bit_equal(stepped, tmp_path, name, dtype):
    state = stepped[name, dtype]
    tck.save_checkpoint(str(tmp_path), state, 1)
    fresh = ttrain.create_train_state(1, state.cfg, device="cpu")
    restored = tck.restore_checkpoint(str(tmp_path), fresh)
    assert restored is fresh and restored.step == 1
    _assert_bit_equal(restored, state)
    if name == "CMPCv4_model":
        assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(
            named_leaves(state.model_state),
            named_leaves(ttrain.create_train_state(
                0, state.cfg, device="cpu").model_state)))


def test_restored_state_saves_the_same_bytes(stepped, tmp_path):
    """A state and the state restored from its checkpoint save to the same
    bytes: the tree paths' strings are interned, so pickle writes the
    same index whichever code path built the trees (their key strings
    were equal but distinct objects in a restored tree, and data.pkl came
    out 45 bytes longer here)."""
    state = stepped["CMPCv4_model", "float32"]
    tck.save_checkpoint(str(tmp_path / "a"), state, 1)
    restored = tck.restore_checkpoint(str(tmp_path / "a"),
                                      ttrain.create_train_state(
                                          1, state.cfg, device="cpu"))
    tck.save_checkpoint(str(tmp_path / "b"), restored, 1)
    a, b = (open(tmp_path / d / "1" / tck.FILE, "rb").read()
            for d in ("a", "b"))
    assert len(a) == len(b) and a == b


@pytest.mark.parametrize("name", ["CMPCv5_BiLSTM_HSV_model",
                                  "CMPCv4_BERT_model"])
def test_text_encoder_trees_round_trip(tmp_path, name):
    """The BiLSTM tree (lstm_fw, lstm_bw and the words_feat merge conv,
    kept HWIO) and BERT's empty text tree: JAX's init through
    params_from_jax is the port's init, and a state after one step (BERT's
    from a batch of 'words_feat' and 'sequence_mask') restores
    bit-equal."""
    geo = {**TINY, "bert_dim": 16, "vw_emb_dim": 8}
    cfg = tget(name, **geo)
    jp, _ = jinit(0, jget(name, **geo))
    want = dict(named_leaves(tinit(0, cfg, device="cpu")))
    got = dict(named_leaves(params_from_jax(jp, cfg, device="cpu")))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    text = {k[1:] for k in got if k[0] == "text"}
    if cfg.text_encoder == "bert":
        assert text == set() and jp["text"] == {}
    else:
        assert {k[0] for k in text} == {"embedding", "lstm_fw", "lstm_bw",
                                        "words_feat"}
        assert got[("text", "words_feat", "DW")].shape == (1, 1, 32, 16)
    batch = _batches(cfg, 1)[0]
    if cfg.text_encoder == "bert":
        rng = np.random.default_rng(2)
        del batch["words"], batch["seq_len"]
        batch.update(words_feat=rng.standard_normal(
                         (cfg.batch_size, cfg.num_steps, 16)).astype(
                             np.float32),
                     sequence_mask=(np.arange(cfg.num_steps)[None]
                                    < np.array([[3], [6]])).astype(
                                        np.float32))
    state = ttrain.create_train_state(0, cfg, device="cpu")
    ttrain.make_train_step(cfg)(state, batch)
    tck.save_checkpoint(str(tmp_path), state, 1)
    restored = tck.restore_checkpoint(str(tmp_path), ttrain.create_train_state(
        1, cfg, device="cpu"))
    _assert_bit_equal(restored, state)


def test_frozen_backbone_saved_in_float32(stepped, tmp_path):
    """A bf16 state keeps the float32 backbone it was built from; its
    checkpoint restores into a float32 state of the config (the compute
    dtype may differ), whose weights are then the originals."""
    state = stepped["CMPC_model", "bfloat16"]
    want = dict(named_leaves(tinit(0, state.cfg, device="cpu")["backbone"]))
    got = dict(named_leaves(state.frozen_f32["backbone"]))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert next(named_leaves(state.frozen))[1].dtype == torch.bfloat16
    tck.save_checkpoint(str(tmp_path), state, 1)
    f32 = tck.restore_checkpoint(str(tmp_path), ttrain.create_train_state(
        1, tget("CMPC_model", **TINY), device="cpu"))
    params = dict(named_leaves(f32.params()["backbone"]))
    assert all(params[k].dtype == torch.float32
               and torch.equal(params[k], want[k]) for k in want)


def test_resume_equals_an_unbroken_run(tmp_path):
    """2 steps, save, restore into a state from another seed, 1 step:
    the same losses and weights as 3 straight steps, bit for bit, with
    the brightness augmentation on."""
    cfg = tget("CMPC_model", **TINY, is_aug=True)
    batches = _batches(cfg, 3)
    step = ttrain.make_train_step(cfg)
    straight = ttrain.create_train_state(0, cfg, device="cpu")
    want = [float(step(straight, b)["loss_total"]) for b in batches]
    broken = ttrain.create_train_state(0, cfg, device="cpu")
    got = [float(step(broken, b)["loss_total"]) for b in batches[:2]]
    tck.save_checkpoint(str(tmp_path), broken, broken.step)
    resumed = tck.restore_checkpoint(str(tmp_path),
                                     ttrain.create_train_state(1, cfg,
                                                               device="cpu"))
    got.append(float(step(resumed, batches[2])["loss_total"]))
    assert got == want and resumed.step == 3
    _assert_bit_equal(resumed, straight)


def _small_state(cfg, step):
    """A TrainState with one small leaf per tree, for the file layout."""
    w = torch.full((4,), float(step), requires_grad=True)
    return ttrain.TrainState(
        cfg=cfg, trainable={"w": w}, frozen={"backbone": {}},
        frozen_f32={"backbone": {"conv1": {"w": torch.ones(2, 3, 1, 1)}}},
        optimizer=torch.optim.Adam([w]), model_state={}, step=step)


def test_keeps_the_newest_steps_and_skips_temporary_files(tmp_path):
    cfg, d = tget("CMPC_model", **TINY), str(tmp_path)
    assert tck.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(d, _small_state(cfg, 0))
    for step in (3, 1, 5, 2, 7, 9):
        tck.save_checkpoint(d, _small_state(cfg, step), step)
    assert sorted(int(n) for n in os.listdir(d)) == [3, 5, 7, 9]
    # a save killed before its rename leaves only the temporary file
    os.makedirs(tmp_path / "11")
    (tmp_path / "11" / f".{tck.FILE}.tmp-1").write_bytes(b"partial")
    assert tck.latest_step(d) == 9
    restored = tck.restore_checkpoint(d, _small_state(cfg, 0))
    assert restored.step == 9 and torch.equal(restored.trainable["w"],
                                              torch.full((4,), 9.0))
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(d, _small_state(cfg, 0), step=11)
    tck.save_checkpoint(d, _small_state(cfg, 11), 11)
    assert tck.latest_step(d) == 11
    assert sorted(int(n) for n in os.listdir(d)) == [5, 7, 9, 11]


def test_restore_into_another_config_raises(tmp_path):
    cfg = tget("CMPC_model", **TINY)
    tck.save_checkpoint(str(tmp_path), _small_state(cfg, 1), 1)
    for other in (tget("CMPCv2_model", **TINY),
                  tget("CMPC_model", **{**TINY, "mlp_dim": 10})):
        with pytest.raises(ValueError, match="config"):
            tck.restore_checkpoint(str(tmp_path), _small_state(other, 0))
    # the batch and the compute dtype may differ
    same = tget("CMPC_model", **{**TINY, "batch_size": 5,
                                 "compute_dtype": "bfloat16"})
    assert tck.restore_checkpoint(str(tmp_path),
                                  _small_state(same, 0)).step == 1
    with pytest.raises(ValueError, match="shape"):
        bad = _small_state(cfg, 0)
        bad.trainable["w"] = torch.zeros(5, requires_grad=True)
        tck.restore_checkpoint(str(tmp_path), bad)


def test_train_loop_snapshots_validates_and_resumes(tmp_path):
    cfg, d = tget("CMPC_model", **TINY), str(tmp_path)
    logger, vals = Logger(), []

    def val_fn(state):
        vals.append(state.step)
        return {"overall_iou": 0.25, "n": 2}

    state = ttrain.train_loop(cfg, Reader(cfg), max_iter=5, device="cpu",
                              log_every=1, logger=logger, snapshot_every=2,
                              checkpoint_dir=d, val_fn=val_fn, val_every=2)
    assert state.step == 5 and vals == [2, 4]
    assert sorted(int(n) for n in os.listdir(d)) == [2, 4]
    assert [(it, m) for it, m in logger.rows if "val_overall_iou" in m] == [
        (2, {"val_overall_iou": 0.25, "val_n": 2.0}),
        (4, {"val_overall_iou": 0.25, "val_n": 2.0})]
    # resume from step 4: iterations 4 and 5 only
    resumed = tck.restore_checkpoint(d, ttrain.create_train_state(
        1, cfg, device="cpu"))
    reader, logger = Reader(cfg), Logger()
    state = ttrain.train_loop(cfg, reader, max_iter=6, state=resumed,
                              start_iter=4, log_every=1, logger=logger,
                              checkpoint_dir=d, snapshot_every=3)
    assert state.step == 6 and reader.reads == 2
    assert [it for it, _ in logger.rows] == [4, 5]
    assert tck.latest_step(d) == 6


def test_sigterm_saves_the_step_and_restores_the_handler(tmp_path):
    cfg = tget("CMPC_model", **TINY)
    prev = signal.getsignal(signal.SIGTERM)
    reader = Reader(cfg, kill_at=3)
    state = ttrain.train_loop(cfg, reader, max_iter=50, device="cpu",
                              checkpoint_dir=str(tmp_path), log_every=1000)
    assert state.step == 3 and reader.reads == 3
    assert tck.latest_step(str(tmp_path)) == 3
    assert signal.getsignal(signal.SIGTERM) == prev


# ---------------------------------------------------------------------------
# bridges: a JAX package checkpoint, a TF checkpoint
# ---------------------------------------------------------------------------

def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's loop: 3 steps, an orbax snapshot after 2.  The port resumes
    from the converted snapshot and takes step 3 on the same batch:
    metrics rtol 1e-5; gradients (Adam's first moment) within 1e-4 of the
    leaf's largest entry plus 1e-11 of the largest gradient; weights
    within 1e-3 lr where the gradient is resolved, 2 lr elsewhere
    (tests/test_torch_train.py's bounds; the key biases as in the module
    docstring)."""
    jcfg, tcfg = jget("CMPC_model", **TINY), tget("CMPC_model", **TINY)
    reader, logger = Reader(jcfg, seed=8), Logger()
    jstate = jtrain.train_loop(jcfg, reader, max_iter=3, log_every=1,
                               logger=logger, snapshot_every=2,
                               checkpoint_dir=str(tmp_path / "jax"))
    out = str(tmp_path / "port")
    assert jax_checkpoint_to_torch.convert(str(tmp_path / "jax"),
                                           "CMPC_model", out,
                                           overrides=TINY) == 2
    state = tck.restore_checkpoint(out, ttrain.create_train_state(
        1, tcfg, device="cpu"))
    assert state.step == 2
    before = {p: state.optimizer.state[leaf]["exp_avg"].clone()
              for p, leaf in named_leaves(state.trainable)}
    weights = {p: leaf.detach().clone()
               for p, leaf in named_leaves(state.trainable)}
    got = ttrain.make_train_step(tcfg)(
        state, ttrain.prepare_image_batch_u8(reader.batches[2]))
    want = dict(logger.rows)[2]
    for k in ("loss_main", "loss_cls_all", "loss_reg", "loss_total",
              "train_mIoU", "learning_rate"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)
    adam = jstate.opt_state[0]
    mu = dict(named_leaves(_tree_np(jstate.unravel(adam.mu))))
    new = dict(named_leaves(_tree_np(jstate.unravel(jstate.trainable))))
    g_want = {p: (mu[p] - 0.9 * before[p].numpy()) / 0.1 for p in mu}
    floor = 1e-11 * max(np.abs(g).max() for g in g_want.values())
    lr = want["learning_rate"]
    assert set(mu) == set(before) and len(mu) > 100
    largest = floor / 1e-11
    for path, leaf in named_leaves(state.trainable):
        g = (state.optimizer.state[leaf]["exp_avg"].numpy()
             - 0.9 * before[path].numpy()) / 0.1
        if path[-2:] == ("spa_graph_key", "biases"):
            # the exact gradient is 0: each side's noise is held
            # (tests/test_torch_variants_train.py)
            assert max(np.abs(g).max(), np.abs(g_want[path]).max()) \
                <= 1e-10 * largest, path
        else:
            np.testing.assert_allclose(
                g, g_want[path], rtol=0,
                atol=1e-4 * np.abs(g_want[path]).max() + floor,
                err_msg=str(path))
        err = np.abs(leaf.detach().numpy() - new[path])
        resolved = np.abs(g_want[path]) >= 1e-6
        assert err[resolved].max(initial=0) <= 1e-3 * lr, path
        assert err.max() <= 2 * lr, path


@pytest.fixture(scope="module")
def tf_checkpoints(tmp_path_factory):
    """{name: (TF checkpoint path, the JAX converter's params and state,
    the converter tests' batch, JAX's forward from them)}."""
    pytest.importorskip("tensorflow")
    from test_converter import _ckpt_tensors, _forward_batch, _write_ckpt

    from tools.convert_tf_checkpoint import convert
    out = {}
    for name in ("CMPC_model", "CMPCv4_model", "CMPCv4_BiLSTM_T_model"):
        d, jcfg = tmp_path_factory.mktemp(name), jget(name, **TINY)
        ckpt = _write_ckpt(_ckpt_tensors(jcfg), str(d / "model.ckpt"))
        _, params, state = convert(ckpt, name, overrides=TINY)
        batch = _forward_batch(jcfg, np.random.default_rng(0))
        want, _ = jax.jit(lambda p, s, b: japply(p, s, jcfg, b))(
            params, state, batch)
        out[name] = (ckpt, params, state, batch, want)
    return out


@pytest.mark.parametrize("name", ["CMPC_model", "CMPCv4_model",
                                  "CMPCv4_BiLSTM_T_model"])
@pytest.mark.parametrize("route", ["tool", "npz"])
def test_tf_checkpoint_forward_matches_jax(tf_checkpoints, tmp_path, name,
                                           route):
    ckpt, jparams, jstate, batch, want = tf_checkpoints[name]
    tcfg = tget(name, **TINY)
    if route == "tool":
        tf_checkpoint_to_torch.convert(ckpt, name, str(tmp_path),
                                       overrides=TINY)
        state = tck.restore_checkpoint(str(tmp_path), ttrain.
                                       create_train_state(1, tcfg,
                                                          device="cpu"))
        assert state.step == 0 and not state.optimizer.state[next(
            named_leaves(state.trainable))[1]]["exp_avg"].any()
        params, model_state = state.params(), state.model_state
    else:
        # the layout tools/convert_tf_checkpoint.py's main() writes
        flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
        npz = str(tmp_path / "params.npz")
        np.savez(npz, **{jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in flat})
        params = params_from_npz(npz, tcfg, device="cpu")
        # the .npz holds no BN moving statistics: they come from the
        # converter's state
        model_state = model_state_from_jax(_tree_np(jstate), device="cpu")
    feed = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.inference_mode():
        got = tapply(params, tcfg, feed, model_state=model_state)
    np.testing.assert_allclose(got.sigm.numpy(), np.asarray(want.sigm),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.up.numpy(), np.asarray(want.up), rtol=0,
                               atol=1e-4 * max(1, np.abs(want.up).max()))


def test_params_from_npz_rejects_other_keys(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{"backbone/conv1/w": np.zeros(3)})
    with pytest.raises(ValueError, match="not a tree path"):
        params_from_npz(path, tget("CMPC_model", **TINY), device="cpu")

