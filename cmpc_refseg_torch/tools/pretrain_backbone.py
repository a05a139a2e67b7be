"""DeepLab-ResNet VOC semantic segmentation on the port: train, multi-scale
train, head-only fine-tune, eval, multi-scale eval and inference.

The pipeline that made the backbone init every CMPC config starts from
(the reference vendors it at external/tensorflow-deeplab-resnet/), on the
port's ResNet-101 (``models/backbone.py``), with the JAX package's
tools/pretrain_backbone.py's flags and semantics:

- the model: the backbone's res5c_relu tap and the VOC head, four biased
  atrous 3x3 convs (rates 6/12/18/24, SAME), summed in float32
  (deeplab_resnet/model.py:403-422);
- the loss: the mean softmax CE over the pixels whose label is below
  `num_classes` (255 and every other such label ignored), on labels
  downsampled nearest to the stride-8 grid (train.py:166-175);
- SGD (momentum 0.9) with three LR groups, backbone x1, head weights x10,
  head biases x20, at lr (1 - count / num_steps)^power, `count` being
  the optimizer's own update count (it starts at 0 even with
  --start-step and comes back only through --restore-opt); weight decay
  in the loss, wd * 0.5 * sum(w^2) over the trainable conv kernels
  (train.py:118-215);
- --scope all trains every backbone conv kernel and the head (the folded
  BN's scale and offset stay frozen); --scope head the head alone;
  --opt adam is Adam at the constant lr on the CE alone (fine_tune.py);
- --train-msc: the CE of the max-fused logits of scales 1, 0.75 and 0.5
  plus one CE per scale, each against the labels downsampled to that
  scale's grid (train_msc.py:145-216);
- eval: the mIoU over the list, each image zero-padded to a multiple of
  64 (labels with 255), its logits resized back (TF1 bilinear) and the
  argmax cropped; --msc max-fuses scales 1, 0.75 and 0.5 of the padded
  image on the scale-1 grid (evaluate_msc.py:98-104).  Eval and
  inference run in float32; --bf16 sets the training compute dtype;
- inference: one image to a VOC-coloured PNG (BGR on disk).

Parameters.  The port's tree is {'backbone': the port's backbone tree,
'head': {'c0'..'c3': {'w', 'b'}}}, every 'w' an OIHW float32 tensor
(channels_last).  The init draws from the port's seeded numpy stream
(``ops.layers.InitStream``), not from JAX's PRNG, so a seed gives other
random weights than the JAX tool's; --restore reads a snapshot of either
package (``tools/kaffe.py`` turns a caffemodel into the tree).

Snapshots.  `model_step{N}.npz` holds one array per leaf under the JAX
package's names (``jax.tree_util.keystr`` paths such as
``['backbone']['conv1']['w']``), conv kernels HWIO, so a snapshot of
either package restores in the other.  `opt_step{N}.npz` is the port's
own: 'step' (the loop iteration to continue from), 'count' (the
optimizer's update count), 'opt' ('sgd' or 'adam'), per trainable leaf
'momentum<path>' (SGD) or 'mu<path>' and 'nu<path>' (Adam), HWIO for
kernels like the leaf, and 'data_stream', a JSON string of the loop's
numpy generator state, epoch order and position.  The JAX tool restarts
the data stream from the seed on resume; the port's --restore-opt
continues it, so a resumed run repeats the unbroken run bit for bit.

Runs on the CUDA device unless --device says otherwise; without a CUDA
device and without --device cpu it raises.

  python -m cmpc_refseg_torch.tools.pretrain_backbone --mode train \
      --data-dir VOC --data-list train.txt --bf16
  python -m cmpc_refseg_torch.tools.pretrain_backbone --mode eval \
      --data-dir VOC --data-list val.txt --restore model_step20001.npz --msc
  python -m cmpc_refseg_torch.tools.pretrain_backbone --mode infer \
      --image img.jpg --out pred.png --restore model_step20001.npz
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from cmpc_refseg_torch.convert import (backbone_from_jax, keystr,
                                       resolve_device)
from cmpc_refseg_torch.models.backbone import apply_backbone, init_backbone
from cmpc_refseg_torch.ops.layers import split_stream, xavier_conv_init
from cmpc_refseg_torch.ops.resize import resize_bilinear
from cmpc_refseg_torch.tools.voc import (augment_pair, downsample_labels,
                                         load_image, load_pair,
                                         make_voc_colormap, pad_to_bucket,
                                         read_data_list)
from cmpc_refseg_torch.train.optimizer import named_leaves
from cmpc_refseg_torch.train.trainer import PreemptionGuard

ATROUS_RATES = (6, 12, 18, 24)   # deeplab_resnet/model.py:403-422
MSC_SCALES = (0.75, 0.5)         # beside scale 1
LR_MULTS = (1.0, 10.0, 20.0)     # backbone, head weights, head biases


# ---------------------------------------------------------------- params ---

def init_voc_head(key, num_classes: int, cin: int = 2048) -> dict:
    """Numpy VOC head: four atrous 3x3 convs fc1_voc12_c0..c3 (HWIO 'w',
    zero 'b')."""
    keys = split_stream(key, len(ATROUS_RATES))
    return {f"c{i}": {"w": xavier_conv_init(k, (3, 3, cin, num_classes)),
                      "b": np.zeros((num_classes,), np.float32)}
            for i, k in enumerate(keys)}


def init_numpy(seed, res4_blocks: int = 23, num_classes: int = 21) -> dict:
    """The VOC model's numpy tree in the JAX layout (HWIO kernels) from an
    int seed."""
    kb, kh = split_stream(seed, 2)
    return {"backbone": init_backbone(kb, res4_blocks),
            "head": init_voc_head(kh, num_classes)}


def _kernel(w: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(np.transpose(
        np.asarray(w, np.float32), (3, 2, 0, 1))), device=device).contiguous(
            memory_format=torch.channels_last)


def params_to_torch(tree: dict, *, device=None) -> dict:
    """The numpy tree (`init_numpy`'s layout) -> the port's tensors on
    `device` (CUDA when None): float32, every 'w' OIHW channels_last."""
    device = resolve_device(device)
    backbone = backbone_from_jax(tree["backbone"], device=device)
    for block in backbone.values():
        for unit in ([block] if "w" in block else block.values()):
            unit["w"] = unit["w"].contiguous(
                memory_format=torch.channels_last)
    head = {k: {"w": _kernel(u["w"], device),
                "b": torch.tensor(np.asarray(u["b"], np.float32),
                                  device=device)}
            for k, u in tree["head"].items()}
    return {"backbone": backbone, "head": head}


def to_disk(path, tensor) -> np.ndarray:
    """A leaf as it is saved: float32 numpy, a kernel 'w' HWIO."""
    a = tensor.detach().float().cpu()
    if path[-1] == "w":
        a = a.permute(2, 3, 1, 0)
    return np.array(a.numpy(), order="C")


def from_disk(path, array, like: torch.Tensor) -> torch.Tensor:
    """`to_disk`'s inverse, in `like`'s device and memory format."""
    a = np.asarray(array, np.float32)
    if path[-1] == "w":
        return _kernel(a, like.device)
    return torch.as_tensor(a, device=like.device)


def load_params_npz(path: str, tree: dict) -> dict:
    """Fill the numpy tree `tree` (JAX layout) in place from a snapshot
    (`save_params`'s or the JAX tool's, or tools/convert_tf_checkpoint.py's
    npz): each leaf from its ``keystr`` name; a missing name raises
    KeyError, a shape other than the leaf's ValueError.  Returns `tree`."""
    with np.load(path) as data:
        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                    continue
                name = keystr(prefix + (k,))
                a = np.asarray(data[name], np.float32)
                if a.shape != np.shape(v):
                    raise ValueError(f"{path}: {name} has shape {a.shape}, "
                                     f"the model {np.shape(v)}")
                node[k] = a
        walk(tree, ())
    return tree


# ----------------------------------------------------------------- model ---

def apply_voc_head(head: dict, c5, compute_dtype=None):
    """fc1_voc12 logits [B, h, w, num_classes] float32 from the res5c_relu
    tap `c5` [B, h, w, 2048]: each atrous conv in the compute dtype, its
    output in float32 plus its bias, the four summed in float32."""
    x = c5.permute(0, 3, 1, 2)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    out = None
    for i, rate in enumerate(ATROUS_RATES):
        u = head[f"c{i}"]
        w = u["w"] if compute_dtype is None else u["w"].to(compute_dtype)
        y = F.conv2d(x, w, padding=rate, dilation=rate).float() \
            + u["b"].view(1, -1, 1, 1)
        out = y if out is None else out + y
    return out.permute(0, 2, 3, 1)


def voc_logits(params: dict, im, *, compute_dtype=None,
               res4_blocks: int = 23):
    """Logits on the stride-8 grid of mean-subtracted BGR images
    [B, H, W, 3]."""
    c5 = apply_backbone(params["backbone"], im, compute_dtype=compute_dtype,
                        taps=("c5",), res4_blocks=res4_blocks)["c5"]
    return apply_voc_head(params["head"], c5, compute_dtype)


def voc_ce_loss(logits, labels, num_classes: int):
    """Mean softmax CE over the pixels whose label is < num_classes
    (labels [B, h, w] on the logits' grid)."""
    valid = labels < num_classes
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, safe[..., None])[..., 0]
    ce = torch.where(valid, ce, 0.0)
    return ce.sum() / valid.sum().clamp(min=1)


def eval_forward(params: dict, im, num_classes: int, res4_blocks: int,
                 msc: bool = False):
    """Logits [B, H, W, num_classes] at the input's resolution; `msc`
    max-fuses scales 1, 0.75 and 0.5 on the scale-1 grid."""
    del num_classes   # the head's width; kept for the JAX signature
    logits = voc_logits(params, im, res4_blocks=res4_blocks)
    if msc:
        h, w = im.shape[1:3]
        fh, fw = logits.shape[1:3]
        for s in MSC_SCALES:
            xs = resize_bilinear(im, int(h * s), int(w * s))
            ls = resize_bilinear(voc_logits(params, xs,
                                            res4_blocks=res4_blocks), fh, fw)
            logits = torch.maximum(logits, ls)
    return resize_bilinear(logits, im.shape[1], im.shape[2])


# ----------------------------------------------------------------- train ---

def lr_mult(path) -> float:
    """The LR multiplier of a leaf: head biases x20, head weights x10,
    the backbone x1 (train.py:196-213)."""
    if path[0] == "head":
        return 20.0 if path[-1] == "b" else 10.0
    return 1.0


def split_trainable(params: dict, scope: str):
    """(trainable, frozen) trees: the head, and with scope 'all' every
    backbone conv kernel 'w' (the folded BN constants stay frozen)."""
    def is_trainable(path):
        return path[0] == "head" or (scope == "all" and path[-1] == "w")

    train_p, frozen_p = {}, {}
    for path, leaf in named_leaves(params):
        node = train_p if is_trainable(path) else frozen_p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return train_p, frozen_p


def merge_trees(a: dict, b: dict) -> dict:
    """Deep merge of two disjoint trees of dicts."""
    out = dict(b)
    for k, v in a.items():
        out[k] = merge_trees(v, out[k]) if (isinstance(v, dict)
                                            and k in out) else v
    return out


def train_config(args) -> dict:
    """The trainer's config from the command line (the JAX tool's keys)."""
    return dict(lr=args.learning_rate, num_steps=args.num_steps,
                power=args.power, momentum=args.momentum,
                weight_decay=args.weight_decay, num_classes=args.num_classes,
                res4_blocks=args.res4_blocks, opt=args.opt,
                train_msc=args.train_msc,
                compute_dtype=torch.bfloat16 if args.bf16 else None)


class VocTrainer:
    """The train step on the port's parameter tree `params` (its trainable
    tensors are switched to requires_grad in place).

    `cfg`: `train_config`'s dict; `scope`: 'all' or 'head'.  SGD is
    ``torch.optim.SGD`` (momentum, no dampening) with one param group per
    LR multiplier; before each update every group's lr is set to
    `lr(count) * mult`.  Adam is ``torch.optim.Adam`` (0.9, 0.999, 1e-8)
    at the constant lr.  Both are torch's implementation for the device
    (foreach on CUDA).  After `step`, each trainable leaf's .grad holds
    the step's gradient."""

    def __init__(self, params: dict, cfg: dict, scope: str = "all"):
        self.cfg = cfg
        self.trainable, self.frozen = split_trainable(params, scope)
        self.named = list(named_leaves(self.trainable))
        leaves = [leaf.requires_grad_() for _, leaf in self.named]
        foreach = leaves[0].is_cuda
        if cfg["opt"] == "adam":
            self.optimizer = torch.optim.Adam(
                leaves, lr=cfg["lr"], betas=(0.9, 0.999), eps=1e-8,
                foreach=foreach)
        else:
            groups = [{"params": [leaf for path, leaf in self.named
                                  if lr_mult(path) == m], "mult": m}
                      for m in LR_MULTS]
            self.optimizer = torch.optim.SGD(
                [g for g in groups if g["params"]], lr=cfg["lr"],
                momentum=cfg["momentum"], foreach=foreach)
        self.count = 0

    def params(self) -> dict:
        return merge_trees(self.trainable, self.frozen)

    def lr(self, count: int) -> float:
        """The poly-decay lr at update `count`."""
        c = self.cfg
        return c["lr"] * (1.0 - count / c["num_steps"]) ** c["power"]

    def loss(self, im, labels):
        """(loss, ce) of a batch: `im` [B, H, W, 3] float32 mean-subtracted
        BGR, `labels` [B, h, w] on the stride-8 grid (at the crop's
        resolution with train_msc)."""
        cfg = self.cfg
        params = self.params()
        n = cfg["num_classes"]

        def logits_at(x):
            return voc_logits(params, x, compute_dtype=cfg["compute_dtype"],
                              res4_blocks=cfg["res4_blocks"])

        logits = logits_at(im)
        if cfg["train_msc"]:
            h, w = im.shape[1:3]
            fh, fw = logits.shape[1:3]
            per_scale, fused = [logits], logits
            for s in MSC_SCALES:
                ls = logits_at(resize_bilinear(im, int(h * s), int(w * s)))
                per_scale.append(ls)
                fused = torch.maximum(fused, resize_bilinear(ls, fh, fw))
            ce = voc_ce_loss(fused, downsample_labels(labels,
                                                      out_size=(fh, fw)), n)
            for ls in per_scale:
                ce = ce + voc_ce_loss(ls, downsample_labels(
                    labels, out_size=ls.shape[1:3]), n)
        else:
            ce = voc_ce_loss(logits, labels, n)
        if cfg["opt"] == "adam":
            return ce, ce
        wd = sum((leaf * leaf).sum() for path, leaf in self.named
                 if path[-1] == "w")
        return ce + cfg["weight_decay"] * 0.5 * wd, ce

    def step(self, im, labels):
        """One update on a batch; (loss, ce) as 0-d tensors, detached."""
        for _, leaf in self.named:
            leaf.grad = None
        loss, ce = self.loss(im, labels)
        loss.backward()
        if self.cfg["opt"] != "adam":
            lr = self.lr(self.count)
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group["mult"]
        self.optimizer.step()
        self.count += 1
        return loss.detach(), ce.detach()

    def opt_arrays(self) -> dict:
        """The optimizer's state as `opt_step{N}.npz` holds it (less 'step'
        and 'data_stream')."""
        out = {"count": np.asarray(self.count), "opt": np.asarray(
            self.cfg["opt"])}
        names = ("mu", "nu") if self.cfg["opt"] == "adam" else ("momentum",)
        keys = ("exp_avg", "exp_avg_sq") if self.cfg["opt"] == "adam" \
            else ("momentum_buffer",)
        for path, leaf in self.named:
            st = self.optimizer.state.get(leaf, {})
            for name, key in zip(names, keys):
                if st.get(key) is not None:
                    out[name + keystr(path)] = to_disk(path, st[key])
        return out

    def load_opt_arrays(self, data) -> None:
        """`opt_arrays`' inverse (from an open npz)."""
        if str(data["opt"]) != self.cfg["opt"]:
            raise ValueError(f"optimizer state of {str(data['opt'])!r}, "
                             f"the run's is {self.cfg['opt']!r}")
        self.count = int(data["count"])
        adam = self.cfg["opt"] == "adam"
        for path, leaf in self.named:
            if adam:
                if "mu" + keystr(path) not in data.files:
                    continue
                self.optimizer.state[leaf] = {
                    "step": torch.tensor(float(self.count)),
                    "exp_avg": from_disk(path, data["mu" + keystr(path)],
                                         leaf),
                    "exp_avg_sq": from_disk(path, data["nu" + keystr(path)],
                                            leaf)}
            elif "momentum" + keystr(path) in data.files:
                self.optimizer.state[leaf] = {
                    "momentum_buffer": from_disk(
                        path, data["momentum" + keystr(path)], leaf)}


def save_params(snapshot_dir: str, step: int, params: dict, trainer=None,
                stream=None) -> str:
    """`model_step{step}.npz` (every leaf under its ``keystr`` name, kernels
    HWIO) and, with `trainer`, `opt_step{step}.npz` (its state, the loop's
    `step` and the data `stream` dict); returns the model file's path."""
    os.makedirs(snapshot_dir, exist_ok=True)
    out = os.path.join(snapshot_dir, f"model_step{step}.npz")
    np.savez(out, **{keystr(p): to_disk(p, leaf)
                     for p, leaf in named_leaves(params)})
    if trainer is not None:
        np.savez(os.path.join(snapshot_dir, f"opt_step{step}.npz"),
                 step=np.asarray(step), **trainer.opt_arrays(),
                 data_stream=np.asarray(json.dumps(stream)))
    print(f"saved {out}", flush=True)
    return out


def load_opt_state_npz(path: str, trainer: VocTrainer):
    """Restore `trainer`'s optimizer from `opt_step{N}.npz`; returns (the
    saved loop step, the data stream dict or None)."""
    with np.load(path) as data:
        trainer.load_opt_arrays(data)
        stream = json.loads(str(data["data_stream"])) \
            if "data_stream" in data.files else None
        return int(data["step"]), stream


def init_params(args, device) -> dict:
    """The VOC model's parameters: seeded, or the --restore snapshot."""
    tree = init_numpy(args.seed, args.res4_blocks, args.num_classes)
    if args.restore:
        load_params_npz(args.restore, tree)
    return params_to_torch(tree, device=device)


def run_train(args, *, on_step=None) -> float:
    """The train loop; returns the last step's loss.  One
    ``default_rng(seed)`` permutes the list each epoch and draws the
    augmentation; a SIGTERM or SIGINT stops the loop at a step boundary
    with a snapshot.  `on_step(it, trainer, loss, ce)`, when given, is
    called after each step."""
    device = resolve_device(args.device)
    trainer = VocTrainer(init_params(args, device), train_config(args),
                         args.scope)
    images, masks = read_data_list(args.data_dir, args.data_list)
    rng = np.random.default_rng(args.seed)
    order, pos = rng.permutation(len(images)), 0
    start_step = args.start_step
    if args.restore_opt:
        start_step, stream = load_opt_state_npz(args.restore_opt, trainer)
        if stream is not None:
            rng.bit_generator.state = stream["rng"]
            order, pos = np.asarray(stream["order"]), stream["pos"]

    def save(step):
        save_params(args.snapshot_dir, step, trainer.params(), trainer, {
            "rng": rng.bit_generator.state,
            "order": [int(i) for i in order], "pos": int(pos)})

    crop = args.crop_size
    loss = None
    with PreemptionGuard() as guard:
        for it in range(start_step, args.num_steps):
            if guard.fired:
                if args.snapshot_dir:
                    save(it)
                print(f"preempted at iter {it}: snapshot saved, exiting "
                      "cleanly", flush=True)
                return float("nan") if loss is None else float(loss)
            ims, lbs = [], []
            for _ in range(args.batch_size):
                if pos >= len(order):
                    order, pos = rng.permutation(len(images)), 0
                i = order[pos]
                pos += 1
                im, lb = load_pair(images[i], masks[i])
                im, lb = augment_pair(rng, im, lb, crop, crop,
                                      scale=not args.no_scale,
                                      mirror=not args.no_mirror)
                ims.append(im)
                lb = lb.astype(np.int32)
                # the msc loss downsamples per scale on the device
                lbs.append(lb if args.train_msc else downsample_labels(lb))
            loss, ce = trainer.step(
                torch.as_tensor(np.stack(ims), device=device),
                torch.as_tensor(np.stack(lbs), device=device))
            if on_step is not None:
                on_step(it, trainer, loss, ce)
            if it % args.print_every == 0:
                print(f"step {it} loss {float(loss):.4f} ce {float(ce):.4f}",
                      flush=True)
            if args.snapshot_dir and (it + 1) % args.save_every == 0:
                save(it + 1)
    if args.snapshot_dir:
        save(args.num_steps)
    return float("nan") if loss is None else float(loss)


# ------------------------------------------------------------------ eval ---

def predict(params: dict, im: np.ndarray, args):
    """The argmax [h, w] (int64 tensor on the parameters' device) of one
    mean-subtracted BGR image [h, w, 3], padded to its bucket."""
    dev = params["head"]["c0"]["w"].device
    pim, (h, w) = pad_to_bucket(im)
    with torch.inference_mode():
        logits = eval_forward(params, torch.as_tensor(pim[None], device=dev),
                              args.num_classes, args.res4_blocks,
                              msc=args.msc)
        return logits[0].argmax(-1)[:h, :w]


def confusion(params: dict, images, masks, args, on_pred=None):
    """The confusion matrix [n, n] (int64 tensor on the device; rows the
    ground truth) over the image and mask paths, counted on the device;
    `on_pred(i, pred, gt)` sees each image's argmax and labels."""
    n = args.num_classes
    dev = params["head"]["c0"]["w"].device
    conf = torch.zeros(n * n, dtype=torch.int64, device=dev)
    for i, (imp, mkp) in enumerate(zip(images, masks)):
        im, lb = load_pair(imp, mkp)
        pred = predict(params, im, args)
        gt = torch.as_tensor(lb.astype(np.int64), device=dev)
        valid = gt < n
        conf += torch.bincount(gt[valid] * n + pred[valid], minlength=n * n)
        if on_pred is not None:
            on_pred(i, pred, gt)
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{len(images)}", flush=True)
    return conf.view(n, n)


def mean_iou(conf: np.ndarray):
    """(mIoU over the classes present, per-class IoU) of a confusion
    matrix."""
    inter = np.diag(conf).astype(np.float64)
    union = conf.sum(0) + conf.sum(1) - np.diag(conf)
    iou = inter / np.maximum(union, 1)
    return float(iou[union > 0].mean()), iou


def run_eval(args, *, on_pred=None) -> float:
    """mIoU over the list; prints the JAX tool's JSON line."""
    params = init_params(args, resolve_device(args.device))
    images, masks = read_data_list(args.data_dir, args.data_list)
    conf = confusion(params, images, masks, args, on_pred).cpu().numpy()
    miou, iou = mean_iou(conf)
    print(json.dumps({"mean_iou": round(miou, 5),
                      "per_class_iou": [round(float(x), 5) for x in iou]}))
    return miou


def run_infer(args) -> np.ndarray:
    """One image's prediction [h, w], written as a VOC-coloured PNG."""
    import cv2
    params = init_params(args, resolve_device(args.device))
    pred = predict(params, load_image(args.image), args).cpu().numpy()
    rgb = make_voc_colormap()[pred]
    cv2.imwrite(args.out, rgb[:, :, ::-1])   # BGR on disk
    print(f"wrote {args.out}")
    return pred


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("train", "eval", "infer"),
                    required=True)
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--data-list", default="train.txt")
    ap.add_argument("--image")
    ap.add_argument("--out", default="pred.png")
    ap.add_argument("--restore", help="params .npz (either package's "
                    "snapshot, or tools/convert_tf_checkpoint.py's)")
    ap.add_argument("--restore-opt",
                    help="opt_step*.npz saved beside a snapshot: restores "
                         "the optimizer, its count, the step and the data "
                         "stream")
    ap.add_argument("--start-step", type=int, default=0,
                    help="continue the loop from this iteration "
                         "(overridden by --restore-opt's recorded step)")
    ap.add_argument("--snapshot-dir", default="")
    ap.add_argument("--num-classes", type=int, default=21)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--crop-size", type=int, default=321)
    ap.add_argument("--learning-rate", type=float, default=2.5e-4)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--power", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--num-steps", type=int, default=20001)
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--print-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--scope", choices=("all", "head"), default="all",
                    help="'head' = fine_tune.py head-only training")
    ap.add_argument("--opt", choices=("sgd", "adam"), default="sgd")
    ap.add_argument("--msc", action="store_true",
                    help="multi-scale max-fused eval (evaluate_msc.py)")
    ap.add_argument("--train-msc", action="store_true",
                    help="multi-scale training loss (train_msc.py:145-216)")
    ap.add_argument("--no-scale", action="store_true")
    ap.add_argument("--no-mirror", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--res4-blocks", type=int, default=23)
    ap.add_argument("--device", default=None,
                    help="torch device (CUDA when not given)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.mode == "train":
        return run_train(args)
    if args.mode == "eval":
        return run_eval(args)
    return run_infer(args)


if __name__ == "__main__":
    main()
