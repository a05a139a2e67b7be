"""The heavy checks of tests/test_torch_pretrain.py, run in spawned
processes: each task runs the port's VOC pipeline and the JAX package's
tools/pretrain_backbone.py on the same weights and batches and returns only
what the test holds (losses, per-leaf errors, predictions).  So the test's
process keeps no copies of the models, and JAX's tracing, which holds the
interpreter, does not share one with the port's runs.

`init` (the pool's initializer) puts JAX on the CPU, as tests/conftest.py
does, and caches the JAX tool's `make_train_step` by config, so that the
runs of one process share a compiled step.
"""

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
NC, RES4, CROP, BS, SIZE = 4, 2, 64, 2, 72
TREE_SEED = 3
N_DRAWS = 3
COMMON = ["--num-classes", str(NC), "--res4-blocks", str(RES4),
          "--crop-size", str(CROP), "--batch-size", str(BS), "--seed", "0",
          "--print-every", "1"]


def _cfg(**kw):
    cfg = dict(lr=2.5e-4, num_steps=3, power=0.9, momentum=0.9,
               weight_decay=5e-4, num_classes=NC, res4_blocks=RES4,
               opt="sgd", train_msc=False, compute_dtype=None)
    return {**cfg, **kw}


CASES = {"sgd_all": (_cfg(), "all"),
         "adam_head": (_cfg(opt="adam"), "head"),
         "sgd_msc": (_cfg(train_msc=True), "all")}


def init():
    """A worker's start: JAX on the CPU, both packages importable, the JAX
    tool's make_train_step cached by config."""
    for p in (str(REPO), str(REPO / "tools")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(2)
    from tools import pretrain_backbone as pb
    real, steps = pb.make_train_step, {}

    def cached(cfg):
        key = tuple(sorted((k, str(v)) for k, v in cfg.items()))
        if key not in steps:
            steps[key] = real(cfg)
        return steps[key]
    pb.make_train_step = cached


def tree():
    """The numpy weights every check starts from (the port's seeded init,
    JAX layout)."""
    from cmpc_refseg_torch.tools.pretrain_backbone import init_numpy
    return init_numpy(TREE_SEED, RES4, NC)


def draw(t, d):
    """Draw d of the weights: `t` times (1 + 1e-3 N(0, 1)) from seed d,
    leaf by leaf (draw 0: `t` itself)."""
    if not d:
        return t
    rng = np.random.default_rng(d)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return (node * (1 + 1e-3 * rng.standard_normal(node.shape))).astype(
            np.float32)
    return walk(t)


def batches(data_dir, data_list, msc):
    """Two augmented batches of one image each, labels on the stride-8 grid
    (at the crop's resolution for msc); the command lines run BS."""
    from cmpc_refseg_torch.tools import voc
    images, masks = voc.read_data_list(data_dir, data_list)
    rng = np.random.default_rng(7)
    out = []
    for i in range(2):
        im, lb = voc.augment_pair(rng, *voc.load_pair(images[i], masks[i]),
                                  CROP, CROP)
        lb = lb.astype(np.int32)
        out.append((im[None], (lb if msc else voc.downsample_labels(lb))[None]))
    return out


def flat_jax(t):
    import jax
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def flat_port(t):
    from cmpc_refseg_torch.tools import pretrain_backbone as tpb
    from cmpc_refseg_torch.train.optimizer import named_leaves
    return {tpb.keystr(p): tpb.to_disk(p, leaf)
            for p, leaf in named_leaves(t)}


def step_errors(got, want, before):
    """Per leaf: max |w_t - w_j| over the leaf's largest |w_j - w_0| (plus
    2^-23 of its largest |w_j|, the rounding of the addition); a leaf that
    does not move must be equal (else the error is inf)."""
    assert set(got) == set(want)
    out = {}
    for name, w in want.items():
        delta = np.abs(w - before[name]).max()
        if not delta:
            out[name] = 0.0 if np.array_equal(got[name], w) else np.inf
            continue
        out[name] = float(np.abs(got[name] - w).max() / (
            delta + 2.0 ** -23 * np.abs(w).max()))
    return out


def _jax_run(t, case, bs):
    """Two JAX steps of `case` from the numpy tree `t`: the initial
    trainable leaves, then per step loss, ce, leaves and Adam's moments."""
    from tools import pretrain_backbone as pb
    cfg, scope = CASES[case]
    opt, step = pb.make_train_step(cfg)
    train_p, frozen_p = pb.split_trainable(t, scope)
    opt_state = opt.init(train_p)
    out = [{"train": flat_jax(train_p)}]
    for im, lb in bs:
        train_p, opt_state, loss, ce = step(train_p, frozen_p, opt_state,
                                            im, lb)
        adam = opt_state[0] if cfg["opt"] == "adam" else None
        out.append({"loss": float(loss), "ce": float(ce),
                    "train": flat_jax(train_p),
                    "mu": adam and flat_jax(adam.mu),
                    "nu": adam and flat_jax(adam.nu)})
    return out


def sgd_case(case, data_dir, data_list):
    """Per draw and step of an SGD case: both losses and ce, and the step
    errors of the port's weights against JAX's."""
    import torch

    from cmpc_refseg_torch.tools import pretrain_backbone as tpb
    cfg, scope = CASES[case]
    bs = batches(data_dir, data_list, cfg["train_msc"])
    out = []
    for d in range(N_DRAWS):
        t = draw(tree(), d)
        want = _jax_run(t, case, bs)
        trainer = tpb.VocTrainer(tpb.params_to_torch(t, device="cpu"), cfg,
                                 scope)
        assert flat_port(trainer.trainable).keys() == want[0]["train"].keys()
        run = []
        for k, (im, lb) in enumerate(bs, start=1):
            loss, ce = trainer.step(torch.from_numpy(im),
                                    torch.from_numpy(lb))
            run.append({"loss": (float(loss), want[k]["loss"]),
                        "ce": (float(ce), want[k]["ce"]),
                        "errors": step_errors(flat_port(trainer.trainable),
                                              want[k]["train"],
                                              want[0]["train"])})
        assert trainer.count == 2
        out.append(run)
    return out


def _load_jax_adam(trainer, state):
    """The JAX state after a first Adam step (weights, moments, count 1)
    into `trainer`, as test_torch_train.py starts its second step."""
    import torch

    from cmpc_refseg_torch.tools import pretrain_backbone as tpb
    trainer.count = 1
    for path, leaf in trainer.named:
        n = tpb.keystr(path)
        with torch.no_grad():
            leaf.copy_(tpb.from_disk(path, state["train"][n], leaf))
        trainer.optimizer.state[leaf] = {
            "step": torch.tensor(1.0),
            "exp_avg": tpb.from_disk(path, state["mu"][n], leaf),
            "exp_avg_sq": tpb.from_disk(path, state["nu"][n], leaf)}


def adam_case(data_dir, data_list):
    """Head-only Adam, the second step from JAX's state after the first:
    per step both losses, the port's ce, and per leaf the largest error
    where JAX's gradient is resolved (|g| >= 1e-6, read from its first
    moment) and the largest error, over lr."""
    import torch

    from cmpc_refseg_torch.tools import pretrain_backbone as tpb
    cfg, scope = CASES["adam_head"]
    bs = batches(data_dir, data_list, False)
    t = tree()
    want = _jax_run(t, "adam_head", bs)
    trainer = tpb.VocTrainer(tpb.params_to_torch(t, device="cpu"), cfg,
                             scope)
    out = []
    for k, (im, lb) in enumerate(bs, start=1):
        if k == 2:
            _load_jax_adam(trainer, want[1])
        loss, ce = trainer.step(torch.from_numpy(im), torch.from_numpy(lb))
        w, prev = want[k], want[k - 1].get("mu")
        got = flat_port(trainer.trainable)
        rule = {}
        for n, m in w["mu"].items():
            g = (m - (0.9 * prev[n] if prev else 0)) / 0.1
            err = np.abs(got[n] - w["train"][n])
            rule[n] = (float(err[np.abs(g) >= 1e-6].max(initial=0))
                       / cfg["lr"], float(err.max()) / cfg["lr"])
        out.append({"loss": (float(loss), w["loss"]), "ce": float(ce),
                    "rule": rule})
    return out


def forwards():
    """`voc_logits` and `eval_forward` with msc off and on, both packages,
    on two seeded 64x64 images: per output the shapes, the largest
    difference and the largest entry; and whether msc moved the logits."""
    import jax
    import jax.numpy as jnp
    import torch

    from cmpc_refseg_torch.tools import pretrain_backbone as tpb
    from tools import pretrain_backbone as pb
    t = tree()
    im = (50 * np.random.default_rng(2).standard_normal(
        (2, CROP, CROP, 3))).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(lambda p, x: (
        pb.voc_logits(p, x, res4_blocks=RES4),
        pb.eval_forward(p, x, NC, RES4, msc=False),
        pb.eval_forward(p, x, NC, RES4, msc=True)))(t, jnp.asarray(im))]
    params = tpb.params_to_torch(t, device="cpu")
    x = torch.from_numpy(im)
    with torch.inference_mode():
        got = [tpb.voc_logits(params, x, res4_blocks=RES4).numpy(),
               tpb.eval_forward(params, x, NC, RES4, msc=False).numpy(),
               tpb.eval_forward(params, x, NC, RES4, msc=True).numpy()]
    return {"outputs": [(g.shape, w.shape, float(np.abs(g - w).max()),
                         float(np.abs(w).max())) for g, w in zip(got, want)],
            "msc_moved": not np.allclose(want[1], want[2])}


def adam_forwards(data_dir, data_list):
    return {"adam_head": adam_case(data_dir, data_list),
            "forwards": forwards()}


def jax_cli(data_dir, data_list, init_npz, root, image):
    """JAX's command lines: 3 steps from the init npz, a --start-step run
    (its LR count starts at 0), eval and inference of its snapshot."""
    from tools import pretrain_backbone as pb
    data = ["--data-dir", data_dir, "--data-list", data_list]
    out = {"loss": pb.main(["--mode", "train", *data, *COMMON,
                            "--restore", init_npz, "--num-steps", "3",
                            "--snapshot-dir", os.path.join(root, "jax"),
                            "--save-every", "100"])}
    pb.main(["--mode", "train", *data, *COMMON, "--restore", init_npz,
             "--num-steps", "3", "--start-step", "2",
             "--snapshot-dir", os.path.join(root, "js"),
             "--save-every", "100"])
    snap = os.path.join(root, "jax", "model_step3.npz")
    out["miou"] = pb.main(["--mode", "eval", *data, *COMMON,
                           "--restore", snap])
    out["pred"] = pb.main(["--mode", "infer", *data, *COMMON,
                           "--restore", snap, "--image", image,
                           "--out", os.path.join(root, "jax.png")])
    return out
