"""Autograd for the head's kernels: the counterpart of the JAX package's
``custom_vjp`` rules.

- `MutanFunction` is `mutan_fused`'s rule (pallas_kernels.py:301-327 of the
  JAX package): its forward runs the mutan kernel's training form, which
  also writes the residual v = tanh(x @ W + b) in bf16, and saves x, the
  cast W, lang and v; its backward runs the dz kernel (dz, dlang, db), dx =
  dz @ W^T as a plain product (the JAX package computes it in XLA) and dW =
  x^T @ dz through the dW kernel.
- The other head ops follow the JAX package's rules for them, whose
  backward is the vjp of the plain function (``_spa_affinity_fwd``,
  ``_graph_conv_opt_fwd``, ``_se_sum_opt_fwd``, ``_convlstm_opt_fwd`` in its
  models/cmpc.py): `spa_affinity_grouped`, `graph_conv`, `se_sum` and
  `convlstm_step` launch the op's Hopper kernels in the forward and save
  only its inputs; the backward recomputes the op's plain route
  (``use_kernels=False``) under autograd and returns its vjp.  Each wraps a
  whole op, as the JAX rules do: the kernels' statistics partials never
  need a gradient of their own.

Weights enter as the f32 trainable tensors, flat, and are cast and stacked
to the compute dtype inside each call, so every leaf gets its gradient.
The forwards pad to the kernels' widths inside (``models/cmpc.py``); the
recomputed plain routes of the backward run at the true widths, but for
the ConvLSTM step's, which runs on its padded tables (its layer norms
counting the true width).  On
CPU tensors the wrappers run their plain versions, so the same functions
run there (with an f32 residual when the compute dtype is f32).
"""

from __future__ import annotations

import torch

from cmpc_refseg_torch.models import cmpc
from cmpc_refseg_torch.ops import kernels


class MutanFunction(torch.autograd.Function):
    """x [M, K] (compute dtype), w [K, heads*C] f32, b [heads*C] f32, lang
    [M/N, heads*C] f32 -> out [M, C] in x's dtype (`kernels.mutan_plain`)."""

    @staticmethod
    def forward(ctx, x, w, b, lang, heads: int, rows_per_sample: int):
        wc = w.to(x.dtype).contiguous()
        out, v = kernels.mutan_fwd_residual(x, wc, b, lang, heads=heads,
                                            rows_per_sample=rows_per_sample)
        ctx.save_for_backward(x, wc, lang, v)
        ctx.heads, ctx.rows_per_sample = heads, rows_per_sample
        return out

    @staticmethod
    def backward(ctx, g):
        x, wc, lang, v = ctx.saved_tensors
        dz, dlang, db = kernels.mutan_bwd_dz(
            v, lang, g.contiguous(), heads=ctx.heads,
            rows_per_sample=ctx.rows_per_sample)
        dz = dz.to(x.dtype)
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = torch.matmul(dz, wc.t()) if need_x else None
        dw = kernels.mutan_dw(x, dz) if need_w else None
        return dx, dw, db, dlang, None, None


def mutan(x, w, b, lang, *, heads: int, rows_per_sample: int):
    """The differentiable mutan (`MutanFunction`)."""
    return MutanFunction.apply(x, w, b, lang, heads, rows_per_sample)


class _Recompute(torch.autograd.Function):
    """forward(kernel_fn, plain_fn, *tensors) -> kernel_fn(*tensors), a tuple
    of tensors, saving only the inputs; backward: the vjp of
    plain_fn(*tensors), recomputed."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, *tensors):
        ctx.plain_fn = plain_fn
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        return tuple(kernel_fn(*tensors))

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = ctx.plain_fn(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t, n in zip(inputs, needs) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
        return (None, None, *[next(got, None) if n else None for n in needs])


def _stack(leaves, dtype):
    return torch.stack(list(leaves)).to(dtype).contiguous()


def spa_affinity_grouped(x, wgs, bgs, wt, rel, mask, *, scale: float,
                         l2n: bool, masked: bool):
    """The spatial-graph affinity of G levels (`kernels.
    spa_affinity_grouped_plain`): wgs, bgs are the G levels' f32 projection
    weights [C, A] and biases [A].  G = 1 launches the ungrouped kernel."""
    groups = len(wgs)
    kw = dict(scale=scale, l2n=l2n, masked=masked)

    def split(ts):
        return (ts[0], _stack(ts[1:1 + groups], ts[0].dtype),
                _stack(ts[1 + groups:1 + 2 * groups], ts[0].dtype),
                *ts[1 + 2 * groups:])

    def kernel_fn(*ts):
        x_, wg, bg, *rest = split(ts)
        return cmpc.affinity(x_, *cmpc.pad_projection(wg, bg), *rest, **kw)

    def plain_fn(*ts):
        return kernels.spa_affinity_grouped_plain(*split(ts), **kw)

    return _Recompute.apply(kernel_fn, plain_fn, x, *wgs, *bgs, wt, rel, mask)


_GCONV_LEAVES = (("update", "DW"), ("update", "biases"), ("feat_ln", "gamma"),
                 ("feat_ln", "beta"), ("update_ln", "gamma"),
                 ("update_ln", "beta"))


def graph_conv(gps, x, w_aff, v_aff):
    """One graph-convolution round of G levels (`cmpc._graph_conv_grouped`):
    gps are the G levels' round parameters (f32).  The forward is
    `cmpc.graph_conv` on their `stack_gconv`: the message and update kernels
    and the glue."""
    n = len(_GCONV_LEAVES)
    leaves = [gp[a][b] for gp in gps for a, b in _GCONV_LEAVES]

    def rebuild(ts):
        gps_ = []
        for g in range(len(gps)):
            gp = {"update": {}, "feat_ln": {}, "update_ln": {}}
            for (a, b), t in zip(_GCONV_LEAVES, ts[g * n:(g + 1) * n]):
                gp[a][b] = t
            gps_.append(gp)
        return gps_

    def kernel_fn(x_, wa, va, *ts):
        return (cmpc.graph_conv(cmpc.stack_gconv(rebuild(ts), x_.dtype), x_,
                                wa, va),)

    def plain_fn(x_, wa, va, *ts):
        return (cmpc._graph_conv_grouped(rebuild(ts), x_, wa, va),)

    return _Recompute.apply(kernel_fn, plain_fn, x, w_aff, v_aff, *leaves)[0]


def se_sum(feat, others, gates, ws, bs):
    """The exchange's SE sum (`kernels.se_sum_plain`): ws, bs are the other
    levels' f32 `trans_feat` kernels [1, 1, C, C] and biases [C]."""
    k = len(others)

    def split(ts):
        dt = ts[0].dtype
        return (ts[0], list(ts[1:1 + k]), list(ts[1 + k:1 + 2 * k]),
                [w[0, 0].to(dt).contiguous() for w in ts[1 + 2 * k:1 + 3 * k]],
                [b.to(dt) for b in ts[1 + 3 * k:]])

    def kernel_fn(*ts):
        return (cmpc.se_sum(*split(ts)),)

    def plain_fn(*ts):
        return (kernels.se_sum_plain(*split(ts)),)

    return _Recompute.apply(kernel_fn, plain_fn, feat, *others, *gates, *ws,
                            *bs)[0]


def convlstm_step(p, x, c, h):
    """One ConvLSTM step (`cmpc.convlstm_step_fused`): p holds the f32
    kernel, peepholes and 5 layer norms.  The forward is the gates and raw
    kernels and the finalize.  Returns (new_c, new_h)."""
    names = ("kernel", "W_ci", "W_cf", "W_co")
    leaves = [p[k] for k in names] + [ln[k] for ln in p["ln"]
                                      for k in ("gamma", "beta")]

    def rebuild(ts):
        lns = [{"gamma": ts[4 + 2 * i], "beta": ts[5 + 2 * i]}
               for i in range(len(p["ln"]))]
        return {**dict(zip(names, ts[:4])), "ln": lns}

    def kernel_fn(x_, c_, h_, *ts):
        return cmpc.convlstm_step_fused(rebuild(ts), x_, c_, h_)

    def plain_fn(x_, c_, h_, *ts):
        return cmpc.convlstm_step_fused(rebuild(ts), x_, c_, h_,
                                        use_kernels=False)

    return _Recompute.apply(kernel_fn, plain_fn, x, c, h, *leaves)
