"""The SavedModels of tests/test_torch_savedmodel.py, written, loaded back
with `tf.saved_model.load` and run on `inputs` in spawned processes: the
JAX package's `export_savedmodel` of a (config, batch) from
init_model(PRNGKey(0)) (`jax_savedmodels`), and the port's from the same
parameters through `convert.params_from_jax` (`port_savedmodels`).

`init` (the pool's initializer) puts JAX on the CPU, as tests/conftest.py
does, makes both packages importable and gives TensorFlow two threads.
"""

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def init():
    for p in (str(REPO), str(REPO / "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import tensorflow as tf
    # a few processes share the host: two threads each
    tf.config.threading.set_intra_op_parallelism_threads(2)
    tf.config.threading.set_inter_op_parallelism_threads(2)


def inputs(batch: int, tiny: dict, seed: int):
    """predict_images' inputs: seeded images [batch, H, W, 3] at a
    mean-subtracted image's scale and expressions of 3 and 5 words."""
    rng = np.random.default_rng(seed)
    words = np.zeros((batch, tiny["num_steps"]), np.int32)
    lens = np.array([3, 5][:batch], np.int32)
    for i, n in enumerate(lens):
        words[i, :n] = rng.integers(3, tiny["vocab_size"], n)
    ims = 50 * rng.standard_normal((batch, tiny["H"], tiny["W"], 3))
    return ims.astype(np.float32), words, lens


def run_signature(sig, ims, words, lens):
    """The masks of a loaded `predict_images` signature, and its inputs as
    {name: (dtype name, shape)}."""
    import tensorflow as tf
    out = sig(images=tf.constant(ims), sentences=tf.constant(words),
              sequence_lenghts=tf.constant(lens))
    (mask,) = out.values()
    spec = {k: (v.dtype.name, v.shape.as_list())
            for k, v in sig.structured_input_signature[1].items()}
    return mask.numpy(), spec


def jax_params(name: str, tiny: dict):
    """The JAX config and init_model(PRNGKey(0))'s (params, state)."""
    import jax

    from cmpc_refseg_tpu.config import get_config
    from cmpc_refseg_tpu.models.model import init_model

    cfg = get_config(name, **tiny)
    return cfg, *init_model(jax.random.PRNGKey(0), cfg)


def port_model(name: str, tiny: dict):
    """The port's config, and `jax_params`' parameters and BN state
    converted (`convert.params_from_jax`, `model_state_from_jax`)."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.convert import model_state_from_jax, params_from_jax

    _, params, state = jax_params(name, tiny)
    cfg = get_config(name, **tiny)
    state = model_state_from_jax(state, device="cpu") \
        if cfg.decoder == "aspp_v3plus" else None
    return cfg, params_from_jax(params, cfg, device="cpu"), state


def jax_savedmodels(cases, tiny: dict, root: str) -> dict:
    """{case: (masks, input spec)} of the JAX SavedModel of each case
    (config name, batch, seed) run on `inputs(batch, tiny, seed)`."""
    import tensorflow as tf

    from cmpc_refseg_tpu.serving.export import export_savedmodel

    out = {}
    for name, batch, seed in cases:
        path = export_savedmodel(*jax_params(name, tiny),
                                 os.path.join(root, f"jax-{name}-{batch}"),
                                 batch_size=batch)
        sig = tf.saved_model.load(path).signatures["predict_images"]
        out[name, batch, seed] = run_signature(sig, *inputs(batch, tiny,
                                                            seed))
    return out


def port_savedmodels(cases, tiny: dict, root: str) -> dict:
    """{case: (masks, input spec, the ATen op names of the traced
    program)} of the port's SavedModel of each case (config name, batch,
    seed) run on `inputs(batch, tiny, seed)`."""
    import tensorflow as tf
    import torch

    from cmpc_refseg_torch.serving import export, tf_lowering

    torch.set_num_threads(2)
    lower, out = tf_lowering.lower, {}
    for name, batch, seed in cases:
        ops = set()

        def traced(program, signature, ops=ops):
            ops.update(tf_lowering.op_name(n.target)
                       for n in program.graph.nodes
                       if n.op == "call_function")
            return lower(program, signature)

        tf_lowering.lower = traced
        path = export.export_savedmodel(
            *port_model(name, tiny),
            os.path.join(root, f"port-{name}-{batch}"), batch_size=batch)
        sig = tf.saved_model.load(path).signatures["predict_images"]
        out[name, batch, seed] = (*run_signature(sig, *inputs(batch, tiny,
                                                              seed)), ops)
    tf_lowering.lower = lower
    return out
