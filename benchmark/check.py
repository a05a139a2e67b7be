"""The comparison that decides `correct`: the readings of what the timed
path produced against the plain reference that the cell's configuration
names (`cell.reference_of`: a module of the contract in
reference/flagship.py, passed in as `ref`; float32, TF32 off), each held
to its limit in benchmark/limits/<cell>.json.

Infer cells: `sigm_err_scaled`, ||s - s_ref|| over every sampled pixel of
the masks' probabilities (the answers the window copied to the host) in
units of the reference's own error at the configurations' precision,
||s_ref,bf16 - s_ref||: how far rounding reaches the masks depends on the
seed's weights, and this unit cancels it.  `sigm_err_all`, the same error
over ||s_ref - 0.5||, is logged beside it.

Train cells: the first three steps of the trainer that the window drives,
against the reference's three steps from the same weights on the same
batches:
  loss_gap    max over the steps of |L - L_ref| / |L_ref|;
  grad_diff_median
              the median over the moving leaves (below) of ||g - g_ref|| /
              ||g_ref||, g the first step's gradient as Adam holds it
              (exp_avg / (1 - beta1) after one update);
  change_gap  max over the moving leaves of | ||d|| - ||d_ref|| | /
              max(||d_ref||, median leaf ||d_ref||), d = p3 - p0 after
              three updates.
A leaf moves when its reference gradient is at least a thousandth of the
median leaf's; the others (biases under a softmax) move by round-off alone
under Adam.  Logged beside them: `loss_gap_1` (the first step's) and
`grad_gap` (the worst leaf's gap of gradient norms, as `change_gap`).
"""

from __future__ import annotations

import statistics

import torch

from generate import reference_batch

BETA1 = 0.9
TINY_GRAD = 1e-3


def leaf_items(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts and lists, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_items(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, prefix + (i,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# infer
# ---------------------------------------------------------------------------

def infer_reference(ref, model, batch, params, ops, block, device):
    """The reference `ref`'s sigm [B, H, W] of a pool batch, `block` rows
    at a time, on the host."""
    n = len(batch["words"])
    outs = []
    with torch.no_grad(), ref.tf32_off():
        for r0 in range(0, n, block):
            rb = reference_batch(model, batch, slice(r0, r0 + block), device)
            outs.append(ref.forward(ops, params, model, rb)["sigm"][..., 0]
                        .float().cpu())
    return torch.cat(outs)


def infer_readings(ref, model, mix, seed, pool, answers, device,
                   precision="float32", answer_of=None):
    """The infer readings of the program's `answers` {slot: sigm [B, H, W]
    on the host} against the reference `ref` at the slots `check_slots`
    draws; `answer_of(slot, params, ops)`, when given, stands in for the
    program (the control: the reference in `precision`)."""
    params = ref.make_params(model, seed, device)
    gots, wants, halves = [], [], []
    for slot in check_slots(mix, seed, answers):
        def reference(ops):
            return infer_reference(ref, model, pool[slot], params, ops,
                                   mix["ref_block"], device)
        wants.append(reference(ref.Ops()))
        halves.append(reference(ref.Ops("bfloat16")))
        gots.append(answers[slot] if answer_of is None else answer_of(
            slot, params, ref.Ops(precision)))
    got, want, half = (torch.cat(t).double() for t in (gots, wants, halves))
    return {"sigm_err_all": float((got - want).norm()
                                  / (want - 0.5).norm()),
            "sigm_err_scaled": float((got - want).norm()
                                     / (half - want).norm())}


def check_slots(mix, seed, answers):
    """The pool slots compared: `mix['check_batches']` of those answered,
    drawn from the seed."""
    slots = sorted(answers)
    g = torch.Generator().manual_seed(int(seed) % (1 << 63) + 1)
    order = torch.randperm(len(slots), generator=g).tolist()
    return sorted(slots[i] for i in order[:mix["check_batches"]])


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def reference_steps(ref, model, pool, seed, steps, device,
                    precision="float32", block=8):
    """The reference `ref`'s `steps` train steps from the seed's weights
    on pool batches 0.. steps-1: (losses, first gradient {path: tensor},
    change {path: tensor}).  The frozen backbone runs without gradient,
    `block` rows at a time; the head forward and backward over the whole
    batch."""
    ops = ref.Ops(precision)
    params = ref.make_params(model, seed, device)
    head = ref.head_of(params)
    leaves = [t.requires_grad_() for _, t in leaf_items(head)]
    start = [t.detach().clone() for t in leaves]
    opt = torch.optim.Adam(leaves, lr=model["start_lr"], betas=(BETA1, 0.999),
                           eps=1e-8, foreach=False)
    losses, grad1 = [], None
    with ref.tf32_off():
        for step in range(steps):
            rb = reference_batch(model, pool[step], slice(None), device)
            out = ref.forward_frozen_backbone(ops, params, model, rb, block)
            total = ref.loss(out, rb["target"], model, head)
            opt.zero_grad(set_to_none=True)
            total.backward()
            for path, t in leaf_items(head):
                if "biases" in path:
                    t.grad.mul_(2.0)
            if grad1 is None:
                grad1 = [t.grad.detach().clone() for t in leaves]
            for g in opt.param_groups:
                g["lr"] = ref.poly_lr(model, step)
            opt.step()
            losses.append(float(total.detach()))
    paths = [p for p, _ in leaf_items(head)]
    change = [t.detach() - s for t, s in zip(leaves, start)]
    return losses, dict(zip(paths, grad1)), dict(zip(paths, change))


def leaf_gaps(got: dict, want: dict, keep=None):
    """{leaf: | got - want | / max(want, median want)} over the leaves of
    `keep` (all when None)."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}


def train_readings(program: dict, reference: tuple):
    """The train readings of a program's record {'losses', 'grads' (path:
    tensor), 'grad_norms', 'change_norms' (path: float)} against
    `reference_steps`' output, and the leaves of the widest gaps."""
    losses, grad1, change = reference
    gref = {k: float(v.norm()) for k, v in grad1.items()}
    med = statistics.median(gref.values())
    moved = {k for k, v in gref.items() if v >= TINY_GRAD * med}
    cref = {k: float(v.norm()) for k, v in change.items()}
    gaps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], losses)]
    grad = leaf_gaps(program["grad_norms"], gref)
    chg = leaf_gaps(program["change_norms"], cref, moved)
    diff = [float((program["grads"][k].to(v.device) - v).norm()) / gref[k]
            for k, v in grad1.items() if k in moved]
    return {"loss_gap": max(gaps), "loss_gap_1": gaps[0],
            "grad_gap": max(grad.values()),
            "grad_diff_median": statistics.median(diff),
            "change_gap": max(chg.values()),
            "leaves": {"grad": top(grad, gref), "change": top(chg, cref)}}


def top(gaps: dict, norms: dict, k=4):
    """The `k` leaves of the widest gaps: [path, gap, reference norm]."""
    worst = sorted(gaps, key=gaps.get, reverse=True)[:k]
    return [["/".join(map(str, p)), gaps[p], norms[p]] for p in worst]


def judge(readings: dict, limits: dict):
    """(correct, [(name, value, limit)]): every reading at or under its
    limit; a reading that is not a finite number fails."""
    rows = [(k, float(readings.get(k, float("nan"))), lim)
            for k, lim in limits.items()]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
