"""The port's TF SavedModel export (`serving.export.export_savedmodel`) at
the TINY geometry, in float32 on the CPU.

- Each SavedModel of CASES is loaded with `tf.saved_model.load`: its
  `predict_images` takes JAX's input names and dtypes (images f32,
  sentences int32, sequence_lenghts int32, sic), and its masks match the
  port's `make_predict_fn` within 1e-5 and the JAX package's own
  SavedModel within 1e-4 (JAX's tests/test_serving.py tolerance).  Both
  SavedModels of a case are written, loaded and run in spawned processes
  (tests/torch_savedmodel_worker.py), both from init_model(PRNGKey(0));
  the port's parameters are JAX's through `convert.params_from_jax`.
  CASES: the flagship at batch 1, CMPCv5_BiLSTM_HSV_model and
  CMPCv5_plus_model at batch 2 (the last two together trace to every
  ATen op of the 14 image configs that take words, WORD_CONFIG_OPS).
- Slow (`-m slow`, ~2 min): the sweep traces every one of the 14 configs
  and holds that their union is WORD_CONFIG_OPS and lowers; and the video
  config's SavedModel, which JAX's exporter writes as its image forward,
  against JAX's as above.
- A graph with an op outside the lowering's table raises
  NotImplementedError naming it; CMPCv4_BERT_model, which JAX's exporter
  fails on too, raises ValueError.
- `cmpc_refseg_torch.serving.export` and the lowering import with
  TensorFlow blocked.
"""

import importlib
import multiprocessing as mp
import sys
from concurrent.futures import ProcessPoolExecutor

import jax
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import torch_savedmodel_worker as worker  # noqa: E402,I100
from cmpc_refseg_torch.config import VARIANTS  # noqa: E402
from cmpc_refseg_torch.config import get_config as tget  # noqa: E402
from cmpc_refseg_torch.models.model import init_model as tinit  # noqa: E402
from cmpc_refseg_torch.models.model import init_model_state  # noqa: E402
from cmpc_refseg_torch.serving import export as texport  # noqa: E402
from cmpc_refseg_torch.serving import tf_lowering  # noqa: E402
from cmpc_refseg_tpu.config import get_config as jget  # noqa: E402
from cmpc_refseg_tpu.models.model import init_model as jinit  # noqa: E402

torch.set_num_threads(4)

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=1,
            res4_blocks=2)
VIDEO = "CMPC_video_mm_tgraph_allvec"
# (config, batch size, seed of the inputs)
CASES = (("CMPC_model", 1, 0), ("CMPCv5_BiLSTM_HSV_model", 2, 1),
         ("CMPCv5_plus_model", 2, 2))
VIDEO_CASE = (VIDEO, 1, 3)
COVER = ("CMPCv5_BiLSTM_HSV_model", "CMPCv5_plus_model")
WORD_CONFIGS = tuple(n for n in VARIANTS
                     if n not in ("CMPCv4_BERT_model", VIDEO))
WORD_CONFIG_OPS = frozenset({
    "getitem", "aten._assert_tensor_metadata.default", "aten.abs.default",
    "aten.add.Tensor", "aten.addcmul.default", "aten.alias.default",
    "aten.arange.default", "aten.cat.default", "aten.clamp.default",
    "aten.contiguous.default", "aten.conv2d.default", "aten.div.Tensor",
    "aten.einsum.default", "aten.eq.Scalar", "aten.eq.Tensor",
    "aten.exp.default", "aten.expand.default", "aten.flip.default",
    "aten.gather.default", "aten.gt.Scalar", "aten.index.Tensor",
    "aten.lift_fresh_copy.default", "aten.lt.Tensor", "aten.matmul.default",
    "aten.max_pool2d.default", "aten.maximum.default", "aten.mean.dim",
    "aten.meshgrid.indexing", "aten.minimum.default", "aten.mul.Tensor",
    "aten.ne.Scalar", "aten.new_zeros.default", "aten.ones_like.default",
    "aten.pad.default", "aten.permute.default",
    "aten.promote_types.default", "aten.reciprocal.default",
    "aten.relu.default", "aten.relu_.default", "aten.remainder.Scalar",
    "aten.repeat.default", "aten.reshape.default", "aten.rsqrt.default",
    "aten.rsub.Scalar", "aten.select.int", "aten.sigmoid.default",
    "aten.slice.Tensor", "aten.softmax.int", "aten.split.Tensor",
    "aten.sqrt.default", "aten.stack.default", "aten.sub.Tensor",
    "aten.sum.dim_IntList", "aten.tanh.default", "aten.to.device",
    "aten.to.dtype", "aten.transpose.int", "aten.unbind.int",
    "aten.unsqueeze.default", "aten.var_mean.correction",
    "aten.view.default", "aten.where.self", "aten.zeros_like.default"})
SIGNATURE = {"images": "float32", "sentences": "int32",
             "sequence_lenghts": "int32"}


def _ops(program):
    return {tf_lowering.op_name(n.target) for n in program.graph.nodes
            if n.op == "call_function"}


def _export_cases(cases, root):
    """{case: (the port's SavedModel run on the case's inputs, JAX's)},
    each run (masks, input spec), the port's also its program's ATen ops;
    each SavedModel written in a spawned process of its own."""
    with ProcessPoolExecutor(2 * len(cases),
                             mp_context=mp.get_context("spawn"),
                             initializer=worker.init) as pool:
        runs = {case: (pool.submit(worker.port_savedmodels, [case], TINY,
                                   root),
                       pool.submit(worker.jax_savedmodels, [case], TINY,
                                   root))
                for case in cases}
        return {case: (port.result()[case], jax_run.result()[case])
                for case, (port, jax_run) in runs.items()}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    return _export_cases(CASES, str(tmp_path_factory.mktemp("savedmodels")))


def _check_case(case, runs):
    """A case's two runs: JAX's input names, dtypes and shapes; masks
    within 1e-5 of the port's predict function and 1e-4 of JAX's."""
    (got, spec, _), (jax_masks, jax_spec) = runs
    name, batch, seed = case
    ims, words, lens = worker.inputs(batch, TINY, seed)
    shapes = {"images": [batch, 32, 32, 3], "sentences": [batch, 6],
              "sequence_lenghts": [batch]}
    assert spec == jax_spec == {k: (SIGNATURE[k], shapes[k])
                                for k in SIGNATURE}
    assert got.shape == (batch, 32, 32)
    cfg, params, state = worker.port_model(name, TINY)
    predict = texport.make_predict_fn(cfg.replace(video=False), params, state)
    with torch.no_grad():
        want = predict(torch.from_numpy(ims), torch.from_numpy(words).long(),
                       torch.from_numpy(lens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jax_masks, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{n}-bs{b}" for n, b, _ in CASES])
def test_savedmodel_matches_the_port_and_jax(exported, case):
    _check_case(case, exported[case])


@pytest.mark.slow
def test_video_savedmodel_matches_the_port_and_jax(tmp_path):
    """JAX's exporter writes a video config's image forward (its
    apply_model never dispatches to the video model); the port's does the
    same.  Slow: two more exports."""
    _check_case(VIDEO_CASE,
                _export_cases([VIDEO_CASE], str(tmp_path))[VIDEO_CASE])


def test_cover_traces_every_op_of_the_word_configs(exported):
    """COVER's programs hold every ATen op that the 14 image configs that
    take words trace to (the slow sweep holds that union), and the
    lowering's table takes each."""
    ops = {name: run[0][2] for (name, _, _), run in exported.items()}
    assert set().union(*(ops[n] for n in COVER)) == WORD_CONFIG_OPS
    assert not WORD_CONFIG_OPS - set(tf_lowering._table()) - {"getitem"}


@pytest.mark.slow
def test_every_word_config_traces_to_the_lowered_ops():
    """The 14 image configs that take words: each traced program lowers
    (no op outside the table), and their union is WORD_CONFIG_OPS.  Slow:
    one torch.export trace a config, ~5 s each."""
    union = set()
    for name in WORD_CONFIGS:
        cfg = tget(name, **TINY)
        state = init_model_state(cfg, device="cpu") \
            if cfg.decoder == "aspp_v3plus" else None
        program = texport._trace(cfg, tinit(0, cfg, device="cpu"), state, 2)
        assert not tf_lowering.missing_ops(program), name
        union |= _ops(program)
    assert len(WORD_CONFIGS) == 14 and union == WORD_CONFIG_OPS


class _Cumsum(torch.nn.Module):
    def forward(self, x):
        return torch.cumsum(x, 0) * 2


def test_an_op_outside_the_table_raises():
    program = torch.export.export(_Cumsum(), (torch.ones(3),))
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        tf_lowering.lower(program, [tf.TensorSpec([3], tf.float32)])


def test_bert_config_raises_as_jax_does(tmp_path):
    from cmpc_refseg_tpu.serving.export import export_savedmodel

    name = "CMPCv4_BERT_model"
    jparams, jstate = jinit(jax.random.PRNGKey(0), jget(name, **TINY))
    with pytest.raises(Exception):
        export_savedmodel(jget(name, **TINY), jparams, jstate,
                          str(tmp_path / "jax"))
    cfg = tget(name, **TINY)
    with pytest.raises(ValueError, match="BERT features"):
        texport.export_savedmodel(cfg, tinit(0, cfg, device="cpu"),
                                  init_model_state(cfg, device="cpu"),
                                  str(tmp_path / "port"))


def test_export_imports_without_tensorflow(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for name in ("cmpc_refseg_torch.serving.export",
                 "cmpc_refseg_torch.serving.tf_lowering"):
        monkeypatch.delitem(sys.modules, name)
        module = importlib.import_module(name)
        assert module.__name__ == name
    with pytest.raises(ImportError):
        importlib.import_module("tensorflow")
