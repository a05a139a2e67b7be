#!/usr/bin/env python3
"""Write the port's TF SavedModel of every image config that takes words
(all but CMPCv4_BERT_model and the video model) at a tiny geometry on the
CPU, and hold each against the port's own predict function.

For each config: the seconds of `serving.export.export_savedmodel` (the
torch.export trace, the lowering and the save), the distinct ATen ops and
the nodes of the traced program, and the largest difference between the
loaded SavedModel's `predict_images` masks and `make_predict_fn`'s on
seeded inputs.  One line per config, then one JSON line with the union of
the ops.  Batch 2, in a temporary directory removed at the end.  Needs
TensorFlow (the exporting host's); no GPU.

    python3 tools/savedmodel_sweep.py
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=1,
            res4_blocks=2)


def main():
    import tensorflow as tf
    import torch

    from cmpc_refseg_torch.config import VARIANTS, get_config
    from cmpc_refseg_torch.models.model import init_model, init_model_state
    from cmpc_refseg_torch.serving import export, tf_lowering

    out = tempfile.TemporaryDirectory(prefix="savedmodel_sweep-")
    seen, lower = {}, tf_lowering.lower

    def traced(program, signature):
        seen["ops"] = {tf_lowering.op_name(n.target)
                       for n in program.graph.nodes if n.op == "call_function"}
        seen["nodes"] = sum(n.op == "call_function"
                            for n in program.graph.nodes)
        return lower(program, signature)

    tf_lowering.lower = traced
    rng = np.random.default_rng(0)
    b, union = 2, set()
    for name in VARIANTS:
        cfg = get_config(name, **TINY)
        if cfg.video or cfg.text_encoder == "bert":
            continue
        params = init_model(0, cfg, device="cpu")
        state = init_model_state(cfg, device="cpu") \
            if cfg.decoder == "aspp_v3plus" else None
        t0 = time.perf_counter()
        path = export.export_savedmodel(cfg, params, state,
                                        os.path.join(out.name, name),
                                        batch_size=b)
        secs = time.perf_counter() - t0
        ims = (50 * rng.standard_normal((b, cfg.H, cfg.W, 3))).astype(
            np.float32)
        lens = rng.integers(3, cfg.num_steps + 1, b).astype(np.int32)
        words = np.zeros((b, cfg.num_steps), np.int32)
        for i, n in enumerate(lens):
            words[i, :n] = rng.integers(3, cfg.vocab_size, n)
        sig = tf.saved_model.load(path).signatures["predict_images"]
        (got,) = sig(images=tf.constant(ims), sentences=tf.constant(words),
                     sequence_lenghts=tf.constant(lens)).values()
        with torch.no_grad():
            want = export.make_predict_fn(cfg, params, state)(
                torch.from_numpy(ims), torch.from_numpy(words).long(),
                torch.from_numpy(lens).long())
        err = float(np.abs(got.numpy() - want.numpy()).max())
        union |= seen["ops"]
        print(f"{name}: export {secs:.1f} s, {len(seen['ops'])} ATen ops, "
              f"{seen['nodes']} nodes, max |SavedModel - predict| "
              f"{err:.3e}", flush=True)
    out.cleanup()
    print(json.dumps({"ops": sorted(union), "count": len(union)}))


if __name__ == "__main__":
    main()
