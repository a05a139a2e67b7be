"""The evaluation protocol (reference: trainval_model.py test(), :150-303).

- forward at (H, W) = 320x320, the upsampled logits thresholded at 1e-9
  (trainval_model.py:244);
- the prediction taken back to native resolution by resize_and_crop
  (:245);
- cumulative IoU = sum(I) / sum(U), mean IoU and precision@{.5..:.9}
  (:267-294).

The forward runs batched on the device; the native-resolution mapping and
the sums run per sample on the host, since every sample has its own size.
`evaluate_sharded` is the on-device form at model resolution that a train
loop's `val_fn` uses, on one device or over a process group's ranks.
With `use_crf`, `evaluate` also scores the DenseCRF-refined masks
(trainval_model.py:246-259, ``ops/densecrf.py``).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from cmpc_refseg_torch.config import ModelConfig
from cmpc_refseg_torch.convert import resolve_device, to_device
from cmpc_refseg_torch.data.image import resize_and_crop
from cmpc_refseg_torch.models.model import apply_model, prepare_params
from cmpc_refseg_torch.ops.densecrf import refine_mask
from cmpc_refseg_torch.ops.metrics import (EVAL_PRECISION_THRESHOLDS,
                                           SegEvalAccumulator,
                                           batched_mask_iu)
from cmpc_refseg_torch.parallel.mesh import data_group, shard_batch
from cmpc_refseg_torch.train.optimizer import named_leaves
from cmpc_refseg_torch.train.trainer import device_image_prologue

SCORE_THRESHOLD = 1e-9   # trainval_model.py:160,244

_BATCH_KEYS = ("im", "words", "seq_len", "valid_idx", "words_feat",
               "sequence_mask")


def native_prediction(up: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """The native-resolution boolean prediction of the reference
    (trainval_model.py:244-245 + util/eval_tools.py:31-35): threshold the
    upsampled logits at `up >= 1e-9`, bilinearly resize the FLOAT 0/1 mask
    to (oh, ow), then count any nonzero pixel as foreground, as
    np.logical_and on floats does.  The boundary dilates; a > 0.5
    re-threshold would erode it."""
    return resize_and_crop((up >= SCORE_THRESHOLD).astype(np.float32),
                           oh, ow) != 0


def _device_of(params) -> torch.device:
    return next(named_leaves(params))[1].device


def make_eval_step(cfg: ModelConfig, *, use_kernels: bool = True):
    """(params, model_state, batch) -> (up, sigm) [B, H, W, 1] on the
    params' device: the eval-mode forward under inference mode, the batch
    moved there (and a uint8 batch expanded) by `device_image_prologue`.
    `use_kernels=False` runs the kernels' plain versions."""
    def eval_step(params, model_state, batch):
        with torch.inference_mode():
            b = device_image_prologue(batch, _device_of(params))
            out = apply_model(params, cfg, b, model_state=model_state,
                              train=False, use_kernels=use_kernels)
        return out.up, out.sigm
    return eval_step


def eval_batches(sample_iter, batch_size: int,
                 max_samples: Optional[int] = None) -> Iterator:
    """(group, batch) pairs: up to `batch_size` samples of `sample_iter`
    (at most `max_samples` in all) and their model inputs stacked into one
    batch of `batch_size` rows, a short last group padded with copies of
    its last sample, so every forward has one shape."""
    group, n = [], 0

    def stack(group):
        pad = batch_size - len(group)
        batch = {}
        for k in _BATCH_KEYS:
            if k in group[0]:
                rows = [np.asarray(s[k]) for s in group]
                rows += [rows[-1]] * pad
                batch[k] = np.concatenate(rows, axis=0)
        return batch

    for sample in sample_iter:
        if max_samples is not None and n + len(group) >= max_samples:
            break
        group.append(sample)
        if len(group) == batch_size:
            yield group, stack(group)
            n += len(group)
            group = []
    if group:
        yield group, stack(group)


def evaluate(cfg: ModelConfig, params, model_state, sample_iter, *,
             use_crf: bool = False, max_samples: Optional[int] = None,
             visualize_fn=None, batch_size: int = 8, device=None,
             use_kernels: bool = True) -> dict:
    """The reference protocol over `sample_iter`, whose samples hold the
    model inputs (batched [1, ...]: 'im', 'words' with 'seq_len' or
    'valid_idx', or BERT's 'words_feat' and 'sequence_mask') plus
    'orig_size' (h, w) and 'target_native' (the
    native-resolution ground truth), and with `use_crf` 'im_native' (the
    native uint8 RGB image).

    Forwards run on `device` (CUDA when None; raises without it) in
    batches of `batch_size` (`eval_batches`); each sample's prediction is
    mapped back to its native size and summed on the host.
    `visualize_fn(n, sample, pred, sigm)` sees each sample.  Returns
    {'no_crf': SegEvalAccumulator.result()}, and with `use_crf` also
    'crf': the same sums of `densecrf.refine_mask` of the native image
    and the sigmoid taken to native size (resize_and_crop)."""
    dev = resolve_device(device)
    params = prepare_params(to_device(params, dev), cfg)
    model_state = to_device(model_state or {}, dev)
    eval_step = make_eval_step(cfg, use_kernels=use_kernels)
    acc = SegEvalAccumulator()
    acc_crf = SegEvalAccumulator() if use_crf else None
    n = 0
    for group, batch in eval_batches(sample_iter, batch_size, max_samples):
        up_b, sigm_b = eval_step(params, model_state, batch)
        up_b = up_b[..., 0].float().cpu().numpy()
        sigm_b = sigm_b[..., 0].float().cpu().numpy()
        for j, sample in enumerate(group):
            oh, ow = sample["orig_size"]
            target = np.asarray(sample["target_native"]) > 0
            pred = native_prediction(up_b[j], oh, ow)
            acc.update(np.sum(np.logical_and(pred, target)),
                       np.sum(np.logical_or(pred, target)))
            if use_crf:
                crf_mask = refine_mask(np.asarray(sample["im_native"]),
                                       resize_and_crop(sigm_b[j], oh, ow))
                acc_crf.update(np.sum(np.logical_and(crf_mask, target)),
                               np.sum(np.logical_or(crf_mask, target)))
            if visualize_fn is not None:
                visualize_fn(n, sample, pred, sigm_b[j])
            n += 1
    results = {"no_crf": acc.result()}
    if use_crf:
        results["crf"] = acc_crf.result()
    return results


def model_res_iu(up: torch.Tensor, target: torch.Tensor):
    """Per-sample (I, U) [B] on the device at model resolution: `up`
    [B, H, W, 1] thresholded at 1e-9 against `target` [B, H, W, 1] > 0.5."""
    return batched_mask_iu(up[..., 0] >= SCORE_THRESHOLD,
                           target[..., 0] > 0.5)


def make_sharded_eval_step(cfg: ModelConfig):
    """(params, model_state, batch) -> the batch's sums (I, U, IoU) and its
    precision counts [5] (IoU > each threshold), on the params' device.
    The batch holds 'target' [B, H, W, 1] (or 'target_u8') beside the
    model inputs.  Evaluation at model resolution, the fixed-shape fast
    path for model selection during training; `evaluate` gives the
    reported numbers (the two differ by up to ~0.02 IoU on
    boundary-heavy masks, tests/test_eval_protocol.py)."""
    forward = make_eval_step(cfg)
    thresholds = torch.tensor(EVAL_PRECISION_THRESHOLDS)

    def eval_step(params, model_state, batch):
        dev = _device_of(params)
        with torch.inference_mode():
            b = device_image_prologue(batch, dev)
            up, _ = forward(params, model_state, b)
            i, u = model_res_iu(up, b["target"])
            iou = i.float() / u.clamp(min=1).float()
            prec = (iou[:, None] > thresholds.to(dev)).sum(dim=0)
            return i.sum(), u.sum(), iou.sum(), prec
    return eval_step


def evaluate_sharded(cfg: ModelConfig, params, model_state, batch_iter, *,
                     mesh=None, max_batches: Optional[int] = None,
                     device=None) -> dict:
    """`make_sharded_eval_step` over the global batches of `batch_iter`:
    overall and mean IoU and precision@X at model resolution, on `device`
    (CUDA when None).  With `mesh`, a process group (``torch.distributed``,
    e.g. ``group.WORLD``) whose every rank calls this with the same
    batches, each rank scores its rows of each batch by its rank in
    `mesh` (`shard_batch`) and the sums are all-reduced over `mesh`, so
    every rank returns what one device returns (I, U and the precision
    counts equal; the IoU sum in another order).  Under a (data x model)
    layout `mesh` is the layout (its data group is taken) or its data
    group: a group holding two ranks of one data slot raises
    (`data_group`), since it would count their rows twice."""
    if mesh is not None:
        mesh = data_group(mesh)
    dev = resolve_device(device)
    params = prepare_params(to_device(params, dev), cfg)
    model_state = to_device(model_state or {}, dev)
    eval_step = make_sharded_eval_step(cfg)
    # I, U, the IoU sum, n, then the precision counts
    sums = torch.zeros(4 + len(EVAL_PRECISION_THRESHOLDS),
                       dtype=torch.float64, device=dev)
    for bi, batch in enumerate(batch_iter):
        if max_batches is not None and bi >= max_batches:
            break
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        i, u, iou, prec = eval_step(params, model_state, batch)
        rows = np.shape(batch["im" if "im" in batch else "im_u8"])[0]
        sums += torch.cat([torch.stack([i.double(), u.double(),
                                        iou.double()]),
                           torch.tensor([rows], dtype=torch.float64,
                                        device=dev), prec.double()])
    if mesh is not None:
        torch.distributed.all_reduce(sums, group=mesh)
    tot_i, tot_u, tot_iou, n, *tot_prec = sums.tolist()
    n = int(n)
    return {
        "overall_iou": tot_i / max(tot_u, 1),
        "mean_iou": tot_iou / max(n, 1),
        "n": n,
        **{f"prec@{t}": tot_prec[k] / max(n, 1)
           for k, t in enumerate(EVAL_PRECISION_THRESHOLDS)},
    }


def print_results(results: dict) -> None:
    """The reference's printout (trainval_model.py:288-303)."""
    for variant, r in results.items():
        print(f"=== {variant} ===")
        for k in sorted(r):
            if k.startswith("prec@"):
                print(f"precision@{k[5:]} = {r[k]:.5f}")
        print(f"overall IoU = {r['overall_iou']:.5f}")
        print(f"mean IoU = {r['mean_iou']:.5f} ({r['n']} samples)")
