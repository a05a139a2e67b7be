"""The plain reference of the benchmark's CMPC models (`model.py`, seeded
weights from `weights.py`), as the harness calls it.

A configuration file (benchmark/configs/<name>.json) names the reference
its cells are checked against with a top-level key,

    "reference": "benchmark/reference/<file>.py"

a path from the root of the checkout.  Without the key this module is
used.  The harness loads the file as it loads a metric reader
(`cell.load_module`), with benchmark/ on `sys.path`, so a new reference
imports the pieces it shares rather than copying them:

    from reference.model import backbone, mutan, graph_conv, resize, ...
    from reference.flagship import head_of, make_params, ...

A reference imports only `reference.*`, torch, numpy and the standard
library: nothing of the program (cmpc_refseg_torch), neither JAX nor the
JAX package, and no other module of the benchmark (`program`, `cell`,
`check`, ... reach the program).  It takes nothing that the program made:
the harness hands both sides the same seeded weights (`make_params`) and
inputs.  benchmark/tests/test_bench_imports.py holds every reference to
this.

The contract: what the harness calls, and nothing more.

  Ops(precision="float32")
      the products (`mm`, `conv`) in 'float32' (TF32 off), 'bfloat16'
      (the scale of the infer check) or 'fp8' (the control).
  tf32_off()
      a context in which float32 products run without TF32.
  check_supported(model)
      raises ValueError, naming the option, for a configuration the
      reference does not follow; `cell.reference_of` calls it whenever it
      resolves the module, so at set-up, before the weights are made and
      the program is built.
  forward(ops, params, model, batch)
      {'up': logits [B,H,W,1], 'up_levels': {level: logits}, 'sigm'} of a
      batch as `generate.reference_batch` makes it.
  forward_frozen_backbone(ops, params, model, batch, block)
      the same with the backbone outside autograd, `block` images at a
      time.
  loss(outputs, target, model, head)
      the train loss, a scalar, over `forward`'s outputs; `head` is
      `head_of(params)`.
  poly_lr(model, step)
      the learning rate of step `step` (0-based).
  make_params(model, seed, device)
      the float32 parameter tree, the program's layout and names, from
      the seed on the device: the same tree the program is built from.
  meta_params(model)
      that tree as meta tensors, for counting FLOPs.
  head_of(params)
      the trainable subtree; the harness doubles the gradient of every
      leaf whose path holds 'biases', as the program does.

`model` is the configuration file's 'model' dict.  The kernels' widths
that the rooflines take are the harness's (`cell.cost_spec`, read from
`model`), not the reference's.
"""

from reference.model import (Ops, check_supported, forward,  # noqa: F401
                             forward_frozen_backbone, loss, poly_lr,
                             tf32_off)
from reference.weights import make_params, meta_params  # noqa: F401


def head_of(params):
    """Everything but the frozen backbone."""
    return {k: v for k, v in params.items() if k != "backbone"}
