"""The train step and its loop (reference: trainval_model.py:19-147).

A step is the differentiable forward (`models.model.apply_model` in train
mode where autograd records: the head's kernels through
``ops/autograd.py``, the frozen backbone outside the graph, or with
conv5=True its res3-5 kernels in it, the ASPP decoder's BN on the batch
statistics), the loss (with the detection loss when the batch carries box
labels), autograd's backward, the conv-bias gradient x2 and one Adam
update whose lr comes from the polynomial schedule at the update count;
with grad_accum = k, k such micro-steps make one update on their mean
gradient (optax MultiSteps).  The decoder's BN moving statistics are
carried in the state.  Batches arrive as uint8 images and masks
(`prepare_image_batch_u8`) and are expanded on the device.

The loop saves snapshots and a checkpoint at preemption
(``train/checkpoint.py``), resumes from `start_iter` and runs a `val_fn`.

Data parallel: under a process group (``parallel/mesh.py``, one process
per device) each rank steps on its rows of the global batch; the step
averages the gradients over the ranks once per update (one flat
all-reduce) and the metrics each step, the ASPP decoder's BN takes the
global batch's moments, and every rank makes the same update.  The loop
reads `batch_size / R` rows a step, checks at start that the ranks hold
the same weights, agrees on a preemption across the ranks, and logs and
writes checkpoints on rank 0 only.

Tensor parallelism and ZeRO: under a (data x model) layout
(``parallel/mesh.py::make_mesh``; `create_train_state(mesh=)` or
`shard_train_state`) the state stores each leaf that `tp_shardings`
engages as the rank's slice of it, the others whole, and holds Adam for
its segment of the flat vector only (``optimizer.ZeroAdam``).  The step
gathers the engaged leaves whole over the model group before its forward
(storage sharded, compute replicated: every kernel runs on full weights),
and at the micro-step that updates reduce-scatters the gradient over the
world as a mean, steps Adam on the segment and all-gathers the segments.
The m ranks of a data slot hold the same rows, so every mean over the
world (gradients, metrics, the ASPP BN moments) is the data group's.

Not ported: the JAX step's layout knobs (the grad modes, the fused Adam,
the XLA dW switch), which are TPU launch-count workarounds with the same
math.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from cmpc_refseg_torch.config import ModelConfig
from cmpc_refseg_torch.convert import to_device
from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR
from cmpc_refseg_torch.models.model import (apply_model, compute_loss,
                                            init_model, init_model_state,
                                            prepare_backbone)
from cmpc_refseg_torch.parallel.mesh import (Mesh, agree_any,
                                             all_reduce_mean_,
                                             check_replicated, distributed,
                                             is_primary_process,
                                             local_batch_size, tp_shardings)
from cmpc_refseg_torch.train.checkpoint import save_checkpoint
from cmpc_refseg_torch.train.optimizer import (ZeroAdam, accumulate,
                                               make_optimizer, merge_params,
                                               named_leaves,
                                               partition_params,
                                               polynomial_lr, scale_bias_grads)
from cmpc_refseg_torch.utils.moving_average import MovingAverage


@dataclasses.dataclass
class TrainState:
    """`cfg`: the config the state trains; `trainable`: the f32 parameter
    tensors that train (requires_grad; with conv5, the res3-5 conv kernels
    under 'backbone'); `frozen`: the frozen backbone, in
    `prepare_backbone`'s view (bf16 kernels under a bf16 compute dtype);
    `frozen_f32`: the same tree in float32 on the host, bit-equal to the
    weights the state was built from (what a checkpoint saves);
    `optimizer`: Adam over the trainable tensors; `model_state`: the BN
    moving statistics (`models.model.init_model_state`; {} for the
    multiscore decoder); `step`: micro-steps done, as the JAX state counts
    them (updates done = step // grad_accum); `accum`: with grad_accum > 1,
    the running mean of this update's micro-step gradients, one tensor per
    trainable leaf (None before the first micro-step); `zero`: under a
    layout, its `ZeroAdam` (None otherwise): `trainable` then holds each
    engaged leaf's shard, `optimizer` is Adam over the rank's segment, and
    `accum` this rank's own running mean of full gradients."""
    cfg: ModelConfig
    trainable: dict
    frozen: dict
    frozen_f32: dict
    optimizer: torch.optim.Optimizer
    model_state: dict
    step: int = 0
    accum: Optional[list] = None
    zero: Optional[ZeroAdam] = None

    @property
    def device(self) -> torch.device:
        return next(named_leaves(self.trainable))[1].device

    def params(self) -> dict:
        """The full parameter tree (trainable merged with frozen); under a
        layout the engaged leaves gathered whole (a collective)."""
        trainable = self.trainable if self.zero is None else \
            self.zero.gather(self.trainable, requires_grad=False)
        return merge_params(trainable, self.frozen)


def train_state_from_params(params: dict, cfg: ModelConfig,
                            model_state: dict) -> TrainState:
    """A fresh TrainState (step 0, empty Adam moments) from port
    parameters and BN moving statistics; the trainable tensors are switched
    to requires_grad in place."""
    trainable, frozen = partition_params(params, cfg)
    leaves = [leaf.requires_grad_() for _, leaf in named_leaves(trainable)]
    return TrainState(cfg=cfg, trainable=trainable,
                      frozen={"backbone": prepare_backbone(
                          frozen["backbone"], cfg)},
                      frozen_f32=to_device(frozen, "cpu"),
                      optimizer=make_optimizer(cfg, leaves),
                      model_state=model_state)


def create_train_state(seed, cfg: ModelConfig, glove=None, *,
                       device=None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """TrainState from an int seed (the JAX package's init_model draws and
    initial BN statistics; the embedding from `glove` [vocab_size,
    glove_dim] when given), on `device` (CUDA when None; raises without
    it); laid out on `mesh` under the production rule when given
    (`shard_train_state`)."""
    state = train_state_from_params(
        init_model(seed, cfg, glove, device=device), cfg,
        init_model_state(cfg, device=device))
    if mesh is not None:
        shard_train_state(state, mesh)
    return state


def shard_train_state(state: TrainState, mesh: Mesh, *,
                      min_dim: int = 512) -> TrainState:
    """`state`, one process's state that every rank holds alike, laid out
    on `mesh` in place: the leaves that `tp_shardings(min_dim=)` engages
    stored as this rank's shards, Adam (its moments and count, if it has
    stepped) kept for this rank's segment only (`ZeroAdam`); `accum` as
    it is.  Returns `state`."""
    if state.zero is not None:
        raise ValueError("the state is laid out already")
    named = list(named_leaves(state.trainable))
    dims = [d for _, d in named_leaves(
        tp_shardings(state.trainable, mesh, min_dim=min_dim))]
    zero = ZeroAdam(state.cfg, mesh, [t for _, t in named], dims)
    adam = [state.optimizer.state.get(t) for _, t in named]
    if any(adam):
        zero.load([t for _, t in named],
                  *([st[k] for st in adam] for k in ("exp_avg",
                                                     "exp_avg_sq")),
                  float(adam[0]["step"]))
    state.trainable = zero.shard_tree(state.trainable)
    state.optimizer = zero.optimizer
    state.zero = zero
    return state


def aug_generator(step: int) -> torch.Generator:
    """The brightness augmentation's generator for a step, seeded from
    (42, step) as the JAX step folds the step into PRNGKey(42)."""
    seed = int(np.random.SeedSequence([42, int(step)]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def brightness_aug(generator: torch.Generator, im, max_delta: float = 0.2):
    """`tf.image.random_brightness(im, 0.2)` (CMPCv4_model.py:83-84): one
    uniform delta in [-max_delta, max_delta) added to the whole batch
    tensor.  The delta comes from `generator`, so it cannot match the JAX
    package's PRNG draw bit for bit; its law is the same."""
    delta = (torch.rand((), generator=generator).item() * 2 - 1) * max_delta
    return im + delta


def prepare_image_batch(collated: dict, cfg: ModelConfig) -> dict:
    """Host-side packing (trainval_model.py:83-96): uint8 RGB -> float32
    BGR - mean; bool mask -> float target; int32 text."""
    im = collated["im_batch"].astype(np.float32)
    out = {"im": (im[..., ::-1] - IMAGE_MEAN_BGR).astype(np.float32),
           "target": collated["mask_batch"].astype(np.float32)[..., None],
           "words": collated["text_batch"].astype(np.int32)}
    if "seq_length" in collated:
        out["seq_len"] = collated["seq_length"].astype(np.int32).reshape(-1)
    return out


def prepare_image_batch_u8(collated: dict) -> dict:
    """Compact host packing: uint8 RGB and uint8 mask, normalized on the
    device (`device_image_prologue`), 4x fewer host-to-device bytes than
    the float32 feed."""
    out = {"im_u8": np.ascontiguousarray(collated["im_batch"].astype(np.uint8)),
           "target_u8": collated["mask_batch"].astype(np.uint8)[..., None],
           "words": collated["text_batch"].astype(np.int32)}
    if "seq_length" in collated:
        out["seq_len"] = collated["seq_length"].astype(np.int32).reshape(-1)
    return out


def device_image_prologue(batch: dict, device) -> dict:
    """The batch as tensors on `device`, a compact uint8 batch expanded
    there: RGB uint8 -> f32 BGR - mean, uint8 mask -> f32 target.  An
    already expanded batch ('im', 'target') is moved as it is."""
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if "im_u8" in b:
        mean = torch.as_tensor(IMAGE_MEAN_BGR, dtype=torch.float32,
                               device=device)
        b["im"] = b.pop("im_u8").float().flip(-1) - mean
    if "target_u8" in b:
        b["target"] = b.pop("target_u8").float()
    return b


def device_clip_prologue(batch: dict, device, cfg: ModelConfig) -> dict:
    """`device_image_prologue` of a video batch: a uint8 RGB 'clip_u8'
    [B, num_frames, H, W, 3] has its cfg.sampled_frames gathered on the
    device and only those expanded, into 'frames' [B, F, H, W, 3] f32 BGR
    - mean (`models.video.apply_video_model` takes them as they are; the
    same numbers as expanding the whole clip and gathering after)."""
    clip = batch.get("clip_u8")
    b = device_image_prologue({k: v for k, v in batch.items()
                               if k != "clip_u8"}, device)
    if clip is not None:
        clip = torch.as_tensor(clip, device=device)
        idx = torch.as_tensor(cfg.sampled_frames, device=device)
        mean = torch.as_tensor(IMAGE_MEAN_BGR, dtype=torch.float32,
                               device=device)
        b["frames"] = clip.index_select(1, idx).float().flip(-1) - mean
    return b


def compute_gradients(state: TrainState, cfg: ModelConfig, batch: dict, *,
                      use_kernels: bool = True, trainable=None):
    """Forward (train mode), loss and backward of one batch on the full
    trainable tree `trainable` (the state's own when None; a state under
    a layout stores shards, so it needs `state.zero.gather(...)`'s tree):
    leaves every leaf's gradient in its .grad (the conv biases' doubled)
    and the new BN moving statistics in `state.model_state` (no
    gradient), and returns (loss_total, metrics), detached.  `use_kernels=False` runs the
    plain PyTorch versions of the kernels under autograd (the reference
    the kernel route is held against).  A video config's batch goes
    through `device_clip_prologue`, and its metrics have no 'train_mIoU'
    (the JAX package's video step has none)."""
    if cfg.video:
        b = device_clip_prologue(batch, state.device, cfg)
    else:
        b = device_image_prologue(batch, state.device)
    if cfg.is_aug and not cfg.video:
        b["im"] = brightness_aug(aug_generator(state.step), b["im"])
    if trainable is None:
        if state.zero is not None:
            raise ValueError("a state under a layout stores shards: pass "
                             "trainable=state.zero.gather(state.trainable)")
        trainable = state.trainable
    params = merge_params(trainable, state.frozen)
    outputs = apply_model(params, cfg, b, model_state=state.model_state,
                          train=True, use_kernels=use_kernels)
    state.model_state = outputs.model_state
    total, metrics = compute_loss(outputs, b["target"], cfg, params,
                                  label_bbox=b.get("label_bbox"),
                                  true_bbox=b.get("true_bbox"))
    for _, leaf in named_leaves(trainable):
        leaf.grad = None
    total.backward()
    scale_bias_grads(trainable)
    if cfg.video:
        return total.detach(), {k: v.detach() for k, v in metrics.items()}
    with torch.no_grad():
        # on-graph batch mIoU summary (CMPC_model.py:486-490)
        pred, labl = outputs.up > 0, b["target"] > 0
        inter = (pred & labl).sum(dim=(1, 2, 3)).float()
        union = (pred | labl).sum(dim=(1, 2, 3)).float()
        metrics["train_mIoU"] = torch.mean(inter / union.clamp(min=1))
    return total.detach(), {k: v.detach() for k, v in metrics.items()}


def reduce_gradients(state: TrainState) -> None:
    """Under a process group, every trainable leaf's .grad becomes its mean
    over the ranks (one flat all-reduce); without one, nothing changes."""
    if distributed():
        all_reduce_mean_(p.grad for _, p in named_leaves(state.trainable))


def make_train_step(cfg: ModelConfig, *,
                    use_kernels: bool = True) -> Callable:
    """(state, batch) -> metrics: one update of `state` in place.

    batch: 'im_u8' [B,H,W,3] uint8 RGB and 'target_u8' [B,H,W,1] uint8 (or
    'im' f32 BGR - mean and 'target' f32), 'words' [B,T], 'seq_len' [B]
    (the 'bert' encoder: 'words_feat' [B,T,768] f32 and 'sequence_mask'
    [B,T] instead, moved by `device_image_prologue` as they are; with the
    detection head, 'label_bbox' [B,S,S,A,5] and 'true_bbox' [B,M,4] f32,
    `data.anchors.preprocess_true_boxes`' labels); numpy or tensors.  The
    video config's batch holds 'clip_u8' [B,num_frames,H,W,3] uint8 RGB
    (or 'clip' f32 BGR - mean) instead of the image, and the center
    frame's 'target_u8' (`cli_video.prepare_video_batch_u8`).
    Metrics: the losses of `compute_loss`, 'train_mIoU' (not for the
    video model; 0-d tensors on the device) and 'learning_rate' (the lr
    of this micro-step's update, from the update count: it advances once
    per update, as the JAX package's MultiSteps `gradient_step` does).

    With grad_accum = k, the step is a micro-step: its gradient joins the
    running mean in `state.accum`, and every k-th micro-step makes one
    Adam update from that mean and clears it.  `use_kernels=False` trains
    on the plain route (`compute_gradients`).

    Under a process group the batch is this rank's rows of the global
    batch: the update's gradient is averaged over the ranks (one flat
    all-reduce, at the micro-step that updates) and so are the metrics,
    which are then the global batch's.

    A state laid out on a layout (`state.zero`) steps under it: the batch
    is the rows of this rank's data slot (`shard_batch(batch, mesh)`), the
    forward runs on the engaged leaves gathered whole, and the update is
    `ZeroAdam.update` (a reduce-scatter of the gradient over the world,
    Adam on the segment, an all-gather)."""
    schedule = polynomial_lr(cfg)
    k = cfg.grad_accum

    def train_step(state: TrainState, batch: dict) -> dict:
        trainable = state.trainable if state.zero is None else \
            state.zero.gather(state.trainable)
        _, metrics = compute_gradients(state, cfg, batch,
                                       use_kernels=use_kernels,
                                       trainable=trainable)
        lr = schedule(state.step // k)
        leaves = [p for _, p in named_leaves(trainable)]
        grads = [p.grad for p in leaves]
        emit = True
        if k > 1:
            if state.accum is None:
                state.accum = [torch.zeros_like(p) for p in leaves]
            mini = state.step % k
            with torch.no_grad():
                for acc, g in zip(state.accum, grads):
                    accumulate(acc, g, mini)
            emit = mini == k - 1
            if emit:
                grads = [acc.clone() for acc in state.accum]
                for acc in state.accum:
                    acc.zero_()
        if emit and state.zero is not None:
            state.zero.update(state.trainable, grads, lr)
        elif emit:
            for p, g in zip(leaves, grads):
                p.grad = g
            reduce_gradients(state)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
        if distributed():
            all_reduce_mean_(metrics.values())
        state.step += 1
        metrics["learning_rate"] = lr
        return metrics

    return train_step


class PreemptionGuard:
    """SIGTERM/SIGINT set a flag that the train loop reads at each step
    boundary, so it stops cleanly there.  The previous handlers come back
    at the first signal, so a second one still interrupts.  A no-op off the
    main thread, where handlers cannot be installed."""

    def __init__(self):
        self.fired = False
        self._prev = {}

    def __enter__(self):
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:   # not the main thread
            self._prev = {}
        return self

    def _handle(self, signum, frame):
        self.fired = True
        self._restore()

    def _restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)
        self._prev = {}

    def __exit__(self, *exc):
        self._restore()
        return False


def train_loop(cfg: ModelConfig, reader, *, max_iter: int,
               state: Optional[TrainState] = None, seed: int = 0,
               glove=None, device=None, log_every: int = 100, snapshot_every: int = 0,
               checkpoint_dir: Optional[str] = None, logger=None,
               start_iter: int = 0, val_fn: Optional[Callable] = None,
               val_every: int = 0) -> TrainState:
    """Train steps `start_iter` to `max_iter` - 1 over
    `reader.read_collated(batch_size)` (dicts of stacked arrays:
    'im_batch', 'mask_batch', 'text_batch', 'seq_length').  `state`
    defaults to `create_train_state(seed, cfg, glove, device=device)`.

    Logs every `log_every` iterations (console, and `logger.log(it,
    metrics)` when given).  `val_fn(state) -> dict` runs every `val_every`
    iterations, its metrics logged as 'val_*' at `it + 1`.  With
    `checkpoint_dir`, a snapshot is saved as step `it + 1` every
    `snapshot_every` iterations, and SIGTERM or SIGINT saves step `it` at
    the next step boundary and stops the loop there (`PreemptionGuard`;
    without `checkpoint_dir` it only stops).  Resume with
    `checkpoint.restore_checkpoint` into `state` and `start_iter` =
    the restored step.  Iterations count micro-steps (`TrainState.step`),
    so with grad_accum = k a snapshot at a step that is not a multiple of
    k holds the accumulator of the update in progress.

    Under a process group of R ranks, `cfg.batch_size` is the global
    batch: each rank reads `batch_size / R` rows a step from its own
    `reader` (its shard of the data), the ranks must start from the same
    weights (checked), a preemption of any rank stops all at the same
    iteration, and only rank 0 prints, logs and writes checkpoints;
    `val_fn` runs on every rank.

    A `state` laid out on a layout (`create_train_state(mesh=)`) trains
    under it: each rank reads `batch_size / d` rows a step, d the data
    axis, and the m ranks of a data slot must read the same rows (their
    readers the same shard); the ranks of a model index must start from
    the same shards (checked); a checkpoint gathers the sharded state on
    every rank while rank 0 writes it."""
    if state is None:
        state = create_train_state(seed, cfg, glove, device=device)
    mesh = state.zero.mesh if state.zero is not None else None
    check_replicated((leaf for _, leaf in named_leaves(state.trainable)),
                     group=mesh.data if mesh is not None else None)
    step_fn = make_train_step(cfg)
    with PreemptionGuard() as guard:
        return _train_iters(cfg, reader, state, step_fn, guard,
                            max_iter=max_iter, log_every=log_every,
                            snapshot_every=snapshot_every,
                            checkpoint_dir=checkpoint_dir, logger=logger,
                            start_iter=start_iter, val_fn=val_fn,
                            val_every=val_every)


def _train_iters(cfg, reader, state, step_fn, guard, *, max_iter, log_every,
                 snapshot_every, checkpoint_dir, logger, start_iter, val_fn,
                 val_every):
    sharded = state.zero is not None
    local_bs = local_batch_size(cfg.batch_size, state.zero.mesh.data
                                if sharded else None)
    primary = is_primary_process()
    # a sharded state's checkpoint is gathered on every rank
    saves = primary or sharded
    time_avg = MovingAverage(100)
    last = time.time()
    for it in range(start_iter, max_iter):
        if agree_any(guard.fired):
            if checkpoint_dir and saves:
                save_checkpoint(checkpoint_dir, state, it)
            if primary:
                print(f"preempted at iter {it}: "
                      f"{'checkpoint saved, ' if checkpoint_dir else ''}"
                      "stopping cleanly", flush=True)
            return state
        batch = prepare_image_batch_u8(reader.read_collated(local_bs))
        metrics = step_fn(state, batch)
        now = time.time()
        time_avg.add(now - last)
        last = now
        if it % log_every == 0 and primary:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = time_avg.get()
            print(f"iter {it}: loss {metrics['loss_cls_all']:.2f} "
                  f"mIoU {metrics['train_mIoU']:.3f} "
                  f"lr {metrics['learning_rate']:.2e} "
                  f"({time_avg.get():.3f}s/it)", flush=True)
            if logger is not None:
                logger.log(it, metrics)
        if val_fn is not None and val_every and (it + 1) % val_every == 0:
            val_metrics = val_fn(state)
            if logger is not None and primary:
                logger.log(it + 1, {f"val_{k}": float(v)
                                    for k, v in val_metrics.items()})
        if checkpoint_dir and snapshot_every and saves \
                and (it + 1) % snapshot_every == 0:
            save_checkpoint(checkpoint_dir, state, it + 1)
    return state
