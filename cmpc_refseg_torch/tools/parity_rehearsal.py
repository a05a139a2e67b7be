"""One-command dress rehearsal of the port's UNC accuracy-parity runbook
(the counterpart of the JAX package's tools/parity_rehearsal.py, without
JAX).

The real parity run (README, "Accuracy-parity runbook") needs external
artifacts: the COCO images, the REFER pickles and the reference's TF
checkpoint.  This tool runs the whole flow against fabricated ones, so the
runbook has no seams the day the real ones land:

  1. fabricate a mini-REFER/COCO layout: refcoco/refs(unc).p,
     instances.json with polygon and RLE annotations, COCO-named JPEGs and
     vocabulary_Gref.txt;
  2. build the val batches:  data.builders -d unc -t val
     (reference build_batches.py:79-124);
  3. write a reference-named TF checkpoint (`reference_tensors`);
  4. convert it into step 0 of a port TrainState checkpoint
     (tools/convert_tf_checkpoint.py, train/checkpoint.py);
  5. evaluate with the DenseCRF:  cli -m test -d unc -c
     (reference trainval_model.py:150-303), and parse the printed
     IoU / precision table.

Steps 1-4 run on the host; step 5 on the CUDA device unless the CPU is
asked for (`device="cpu"`, `-device cpu`).  Writing the TF checkpoint (and
reading it back) needs TensorFlow, as the real conversion does.  Where it
is absent (the card's machine), `from_tensors=True` (`--from-tensors`)
feeds the fabricated tensors straight to the converter and skips step 3;
without it the rehearsal raises, naming that option.

Run:
  python -m cmpc_refseg_torch.tools.parity_rehearsal [workdir] \\
      [--from-tensors] [--full-width] [-device cpu]

At the default geometry (the JAX rehearsal's TINY config and its three
small noise images) a CPU run takes seconds.  `--full-width` rehearses the
registry's CMPC_model (320x320, ResNet-101, its own widths) on one
batch of 8 fabricated images of COCO's sizes, each of flat colour blocks
(the DenseCRF's lattice on a noise image of that size takes ~10 s a
frame).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pickle
import re
import sys
import time

import numpy as np

MODEL = "CMPC_model"
TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=1,
            res4_blocks=2)
TINY_SIZES = tuple((48 + 8 * i, 64 + 8 * i) for i in range(3))
# COCO train2014's common sizes (h, w): one batch of --full-width images
COCO_SIZES = ((480, 640), (427, 640), (640, 480), (375, 500), (500, 375),
              (424, 640), (512, 640), (640, 427))
COCO_BLOCK = 80              # pixels a side of a flat colour block

VOCAB_WORDS = ["<pad>", "<go>", "<eos>", "<unk>", "a", "the", "red", "blue",
               "left", "right", "person", "dog", "on", "man", "woman", "big",
               "small", "green", "top", "bottom", "cat", "car", "chair",
               "table", "in", "of", "middle", "white", "black", "near"]
SENTENCES = ("the red person on the left", "a big dog near the table",
             "small cat in the middle")

_ROW = re.compile(r"^(overall IoU|mean IoU|precision@[\d.]+) = ([-\d.]+)")


@dataclasses.dataclass
class Rehearsal:
    """What a rehearsal gives: the printed table {'no_crf': {row: value},
    'crf': {...}} (rows 'precision@0.5' .. 'precision@0.9', 'overall IoU',
    'mean IoU'), the seconds of each step, the converted checkpoint's
    directory and the batches' root."""
    table: dict
    seconds: dict
    ckpt_dir: str
    batches: str


def fabricate_refer_layout(data_root: str, sizes=TINY_SIZES,
                           block: int = 1) -> None:
    """A synthetic mini-REFER under `data_root`: refcoco/refs(unc).p and
    instances.json (a polygon annotation on even images, a compressed RLE
    on odd ones), one COCO-named train2014 JPEG of each (h, w) in `sizes`,
    and vocabulary_Gref.txt.  Each image is uniform random colour in
    squares of `block` pixels (1: noise).  With the defaults, the JAX
    package's rehearsal's files."""
    from PIL import Image

    from cmpc_refseg_torch.data.coco_mask import (rle_counts_from_mask,
                                                  rle_string_from_counts)

    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(data_root, "refer", "refcoco"), exist_ok=True)
    im_dir = os.path.join(data_root, "coco", "images", "train2014")
    os.makedirs(im_dir, exist_ok=True)
    with open(os.path.join(data_root, "vocabulary_Gref.txt"), "w") as f:
        f.write("\n".join(VOCAB_WORDS) + "\n")

    refs, annotations, images = [], [], []
    for i, (h, w) in enumerate(sizes):
        img_id, ann_id = 100 + i, 200 + i
        colours = rng.integers(0, 256, (-(-h // block), -(-w // block), 3))
        im = np.repeat(np.repeat(colours, block, 0), block, 1)[:h, :w]
        name = f"COCO_train2014_{img_id:012d}.jpg"
        Image.fromarray(im.astype(np.uint8)).save(os.path.join(im_dir, name))
        images.append({"id": img_id, "height": h, "width": w,
                       "file_name": name})
        if i % 2 == 0:
            # a polygon: a triangle-ish blob
            seg = [[8.0, 8.0, float(w - 10), 12.0, float(w // 2),
                    float(h - 8)]]
        else:
            # the compressed RLE of a centred box
            m = np.zeros((h, w), np.uint8)
            m[h // 4:3 * h // 4, w // 4:3 * w // 4] = 1
            seg = {"size": [h, w],
                   "counts": rle_string_from_counts(rle_counts_from_mask(m))}
        annotations.append({"id": ann_id, "image_id": img_id,
                            "segmentation": seg, "iscrowd": 0})
        refs.append({"ref_id": i, "ann_id": ann_id, "image_id": img_id,
                     "split": "val",
                     "sentences": [{"sent": SENTENCES[i % len(SENTENCES)]}]})

    with open(os.path.join(data_root, "refer", "refcoco", "refs(unc).p"),
              "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(data_root, "refer", "refcoco", "instances.json"),
              "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)


def write_tf_checkpoint(tensors: dict, path: str) -> str:
    """Save {name: array} as a TF checkpoint bundle at prefix `path` (the
    SaveV2 op, which tf.compat.v1's Saver runs, without building a graph
    of variables); returns the prefix.  Imports tensorflow."""
    import tensorflow as tf

    os.makedirs(os.path.dirname(path), exist_ok=True)
    names = list(tensors)
    tf.raw_ops.SaveV2(prefix=path, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tensors[n] for n in names])
    return path


def parse_table(report: str) -> dict:
    """The IoU / precision rows of `cli -m test`'s printout, by section:
    {'no_crf': {row: value}, 'crf': {...}}."""
    table, section = {}, None
    for line in report.splitlines():
        head = re.match(r"^=== (\w+) ===$", line)
        if head:
            section = table.setdefault(head.group(1), {})
            continue
        row = _ROW.match(line)
        if row and section is not None:
            section[row.group(1)] = float(row.group(2))
    return table


def _tensorflow_or_raise() -> None:
    try:
        import tensorflow  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "the rehearsal writes and reads a TF checkpoint, and tensorflow "
            "does not import here: pass --from-tensors (from_tensors=True) "
            "to feed the fabricated tensors straight to the converter") \
            from e


def run(workdir: str, *, from_tensors: bool = False,
        full_width: bool = False, tensors=None, device=None) -> Rehearsal:
    """The five steps under `workdir`.  `tensors` ({reference name: array})
    are the checkpoint's (`reference_tensors` of the config when None);
    `full_width` rehearses the registry's CMPC_model at batch 8 on the
    COCO_SIZES images, else the TINY geometry on the JAX rehearsal's
    three.  Step 5 runs on `device` (CUDA when None; raises without
    it)."""
    from cmpc_refseg_torch import cli
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.data import builders
    from cmpc_refseg_torch.tools import convert_tf_checkpoint as ctc

    if not from_tensors:
        _tensorflow_or_raise()
    if full_width:
        overrides, bs, sizes, block = {}, len(COCO_SIZES), COCO_SIZES, \
            COCO_BLOCK
    else:
        overrides, bs, sizes, block = TINY, 1, TINY_SIZES, 1
    cfg = get_config(MODEL, **overrides)
    data_root = os.path.join(workdir, "data")
    out_root = os.path.join(workdir, "batches")
    ckpt_dir = os.path.join(workdir, "converted_ckpt")
    seconds = {}

    def step(key, what):
        print(f"[rehearsal] {what} ...", flush=True)
        seconds[key] = -time.perf_counter()

    def done(key):
        seconds[key] += time.perf_counter()

    step("layout", "1/5 fabricating the mini-REFER/COCO layout")
    fabricate_refer_layout(data_root, sizes, block)
    done("layout")

    step("batches", "2/5 building the UNC val batches (builders -d unc)")
    builders.main(["-d", "unc", "-t", "val", "-data_root", data_root,
                   "-out_root", out_root, "-T", str(cfg.num_steps),
                   "-H", str(cfg.H), "-W", str(cfg.W)])
    built = [f for f in os.listdir(os.path.join(out_root, "unc",
                                                "val_batch"))
             if f.endswith(".npz")]
    if len(built) != len(sizes):
        raise RuntimeError(f"the builder wrote {len(built)} batches for "
                           f"{len(sizes)} refs")
    done("batches")

    if tensors is None:
        tensors = ctc.reference_tensors(cfg)
    if from_tensors:
        get = tensors.__getitem__
        print("[rehearsal] 3/5 skipped (--from-tensors): the fabricated "
              "tensors go straight to the converter", flush=True)
    else:
        step("tf_checkpoint", "3/5 writing the reference-named TF "
             "checkpoint")
        get = ctc.checkpoint_getter(write_tf_checkpoint(
            tensors, os.path.join(workdir, "tf", "model.ckpt")))
        done("tf_checkpoint")

    step("convert", "4/5 converting it into a port TrainState checkpoint")
    cfg, params, model_state = ctc.convert_tensors(get, MODEL, overrides,
                                                   device="cpu")
    done("convert")
    seconds["save"] = -time.perf_counter()
    ctc.save_train_state(ckpt_dir, cfg, params, model_state)
    seconds["save"] += time.perf_counter()
    del params, model_state

    step("evaluate", "5/5 evaluating (cli -m test -d unc -c)")
    argv = ["-m", "test", "-d", "unc", "-t", "val", "-n", MODEL,
            "-f", out_root, "-ckpt_dir", ckpt_dir, "-emb_dir", data_root,
            "-T", str(cfg.num_steps), "-H", str(cfg.H), "-W", str(cfg.W),
            "-bs", str(bs), "-c"]
    for k in overrides.keys() & {"rnn_size", "v_emb_dim", "mlp_dim",
                                 "glove_dim", "res4_blocks", "vocab_size"}:
        argv += [f"-{k}", str(overrides[k])]
    if device is not None:
        argv += ["-device", str(device)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    done("evaluate")
    report = buf.getvalue()
    print(report, flush=True)
    table = parse_table(report)
    if set(table) != {"no_crf", "crf"} or any(
            "overall IoU" not in t for t in table.values()):
        raise RuntimeError(f"no IoU table in the printout: {report!r}")
    print(f"[rehearsal] PASS: the runbook's flow ran end to end "
          f"({len(built)} batches; overall IoU "
          f"{table['no_crf']['overall IoU']:.5f}, with the CRF "
          f"{table['crf']['overall IoU']:.5f}, on fabricated weights)",
          flush=True)
    return Rehearsal(table=table, seconds=seconds, ckpt_dir=ckpt_dir,
                     batches=out_root)


def main(argv=None):
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--from-tensors", action="store_true",
                    help="feed the fabricated tensors straight to the "
                         "converter (no TensorFlow needed; skips step 3)")
    ap.add_argument("--full-width", action="store_true",
                    help="the registry's CMPC_model at batch 8 on COCO-size "
                         "images, in place of the TINY geometry")
    ap.add_argument("-device", default=None,
                    help="step 5's device: cuda (default; raises without "
                         "one) or cpu")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="parity_rehearsal_")
    os.makedirs(workdir, exist_ok=True)
    run(workdir, from_tensors=args.from_tensors,
        full_width=args.full_width, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
