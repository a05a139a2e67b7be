"""Offline batch builders (reference: build_batches.py, generate_trainmeta.py,
generate_black.py; the JAX package's data/builders.py, a copy: it writes
the same files).

    python -m cmpc_refseg_torch.data.builders -d unc -t val -data_root ./data

Each builder writes per-sample `.npz` files consumed by NpzReader —
`{text_batch, im_batch, mask_batch, sent_batch}` (build_batches.py:72-76).
"""

from __future__ import annotations

import json
import os

import numpy as np

from cmpc_refseg_torch.data import image as im_proc
from cmpc_refseg_torch.data import text as text_proc
from cmpc_refseg_torch.data.refvos import OBJECT_COLOR, decode_object_mask


def _imread(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _load_referit_mask(mask_path):
    """ReferIt .mat masks: object = (segimg_t == 0) (util/io.py:26-29)."""
    from scipy.io import loadmat
    mat = loadmat(mask_path)
    segimg_t = mat["segimg_t"]
    return segimg_t == 0


def build_referit_batches(setname: str, T: int, input_H: int, input_W: int,
                          data_root: str = "./data",
                          out_root: str = "./referit") -> int:
    """ReferIt builder (build_batches.py:30-76): resize-pad only for train;
    test keeps native resolution for the eval-time crop-back protocol."""
    vocab_file = os.path.join(data_root, "vocabulary_referit.txt")
    im_dir = os.path.join(data_root, "referit/images")
    mask_dir = os.path.join(data_root, "referit/mask")
    query_file = os.path.join(
        data_root, f"referit/referit_query_{setname.split('_')[-1]}.json")

    vocab_dict = text_proc.load_vocab_dict_from_file(vocab_file)
    with open(query_file) as f:
        query_dict = json.load(f)

    out_dir = os.path.join(out_root, setname + "_batch")
    os.makedirs(out_dir, exist_ok=True)
    is_train = "train" in setname

    n = 0
    for name, sents in sorted(query_dict.items()):
        im_name = name.split("_", 1)[0] + ".jpg"
        im = _imread(os.path.join(im_dir, im_name))
        mask = _load_referit_mask(os.path.join(mask_dir, name + ".mat"))
        if is_train:
            im_out = im_proc.resize_and_pad(im, input_H, input_W)
            im_out = np.clip(np.rint(im_out), 0, 255).astype(np.uint8)
            mask_out = im_proc.resize_and_pad(mask, input_H, input_W)
        else:
            im_out, mask_out = im, mask
        for sent in sents:
            text = text_proc.preprocess_sentence(sent, vocab_dict, T)
            np.savez(os.path.join(out_dir, f"referit_{setname}_{n}.npz"),
                     text_batch=np.asarray(text, np.int32),
                     im_batch=im_out, mask_batch=(mask_out > 0),
                     sent_batch=[sent])
            n += 1
    return n


_REFER_SOURCE = {
    # dataset flag -> (REFER directory name, splitBy)  (build_batches.py:90-96)
    "Gref": ("refcocog", "google"),
    "unc": ("refcoco", "unc"),
    "unc+": ("refcoco+", "unc"),
}


def load_refer_dataset(refer_root: str, dataset: str):
    """Load a REFER dataset's refs + COCO annotations without the external
    refer/pycocotools packages (build_batches.py:90-99).

    Expects the standard REFER layout: ``{refer_root}/{name}/refs({splitBy}).p``
    (a pickle list of ref dicts: ref_id/ann_id/image_id/split/sentences) and
    ``{refer_root}/{name}/instances.json`` (COCO-format images+annotations).
    Returns (refs, anns_by_id, images_by_id)."""
    import pickle
    if dataset not in _REFER_SOURCE:
        raise ValueError(f"Unknown dataset {dataset!r} "
                         f"(expected one of {sorted(_REFER_SOURCE)})")
    name, split_by = _REFER_SOURCE[dataset]
    ddir = os.path.join(refer_root, name)
    with open(os.path.join(ddir, f"refs({split_by}).p"), "rb") as f:
        refs = pickle.load(f)
    with open(os.path.join(ddir, "instances.json")) as f:
        instances = json.load(f)
    anns = {a["id"]: a for a in instances["annotations"]}
    images = {im["id"]: im for im in instances["images"]}
    return refs, anns, images


def build_coco_batches(dataset: str, setname: str, T: int, input_H: int,
                       input_W: int, data_root: str = "./data",
                       out_root: str = ".", im_type: str = "train2014") -> int:
    """UNC/UNC+/Gref batch builder (build_batches.py:79-124) — the lineage of
    the UNC-val npz batches the eval protocol consumes.  Per ref with the
    requested split: decode the annotation mask (polygons or RLE,
    data/coco_mask.py), resize-pad image+mask only for train splits, and
    write one npz per sentence with front-padded tokens
    ({text_batch, im_batch, mask_batch, sent_batch})."""
    from cmpc_refseg_torch.data.coco_mask import decode_segmentation

    vocab_file = os.path.join(data_root, "vocabulary_Gref.txt")
    im_dir = os.path.join(data_root, "coco/images")
    refs, anns, images = load_refer_dataset(
        os.path.join(data_root, "refer"), dataset)
    vocab_dict = text_proc.load_vocab_dict_from_file(vocab_file)

    out_dir = os.path.join(out_root, dataset, setname + "_batch")
    os.makedirs(out_dir, exist_ok=True)
    is_train = "train" in setname

    n = 0
    for ref in refs:
        if ref["split"] != setname:
            continue
        im_info = images[ref["image_id"]]
        im_name = f"COCO_{im_type}_{ref['image_id']:012d}"
        im = _imread(os.path.join(im_dir, im_type, im_name + ".jpg"))
        mask = decode_segmentation(anns[ref["ann_id"]]["segmentation"],
                                   im_info["height"],
                                   im_info["width"]).astype(np.float32)
        if is_train:
            im_out = im_proc.resize_and_pad(im, input_H, input_W)
            im_out = np.clip(np.rint(im_out), 0, 255).astype(np.uint8)
            mask_out = im_proc.resize_and_pad(mask, input_H, input_W)
        else:
            im_out, mask_out = im, mask
        for sentence in ref["sentences"]:
            sent = sentence["sent"]
            text = text_proc.preprocess_sentence(sent, vocab_dict, T)
            np.savez(os.path.join(out_dir, f"{dataset}_{setname}_{n}.npz"),
                     text_batch=np.asarray(text, np.int32),
                     im_batch=im_out, mask_batch=(mask_out > 0),
                     sent_batch=[sent])
            n += 1
    return n


def build_refvos_sample(im_path: str, mask_path: str, sent: str, obj_id: str,
                        vocab_dict: dict, T: int, input_H: int, input_W: int,
                        out_path: str) -> None:
    """RefVOS single-sample builder (build_batches.py:126-189)."""
    im = _imread(im_path)
    mask_rgb = _imread(mask_path)[:, :, :3]
    mask = decode_object_mask(mask_rgb, obj_id)
    im_out = im_proc.resize_and_pad(im, input_H, input_W)
    im_out = np.clip(np.rint(im_out), 0, 255).astype(np.uint8)
    mask_out = im_proc.resize_and_pad(mask, input_H, input_W)
    text, seq_len = text_proc.preprocess_sentence_lstm(sent, vocab_dict, T)
    np.savez(out_path, text_batch=np.asarray(text, np.int32),
             im_batch=im_out, mask_batch=(mask_out > 0),
             seq_length=np.int32(seq_len), sent_batch=[sent])


def build_refvos_batches(setname: str, T: int, input_H: int, input_W: int,
                         im_dir: str, mask_dir: str, meta_expressions: str,
                         save_dir: str, inrange=None,
                         vocab_file: str = "./data/vocabulary_Gref.txt") -> int:
    """RefVOS full-set builder (build_batches.py:126-189): enumerate
    videos -> expressions -> frames from meta_expressions.json, skip samples
    whose image/mask file is absent or whose object color is missing from
    the frame, resize-pad only for train setnames.  `inrange` restricts to a
    sample-index range (the reference's shard/resume mechanism)."""
    vocab_dict = text_proc.load_vocab_dict_from_file(vocab_file)
    data_folder = os.path.join(save_dir, "refvos", setname + "_batch")
    os.makedirs(data_folder, exist_ok=True)

    with open(meta_expressions) as f:
        videos = json.load(f)["videos"]
    samples = []
    for vid in videos:
        video = videos[vid]
        for eid in video["expressions"]:
            exp = video["expressions"][eid]["exp"]
            obj_id = str(video["expressions"][eid]["obj_id"])
            for fid in video["frames"]:
                samples.append((os.path.join(vid, fid + ".jpg"),
                                os.path.join(vid, fid + ".png"),
                                exp, obj_id))

    if inrange is None:
        inrange = range(len(samples))
    is_train = "train" in setname
    written = 0
    for n_batch in inrange:
        im_name, mask_name, sent, obj_id = samples[n_batch]
        im_path = os.path.join(im_dir, im_name)
        mask_path = os.path.join(mask_dir, mask_name)
        if not (os.path.exists(im_path) and os.path.exists(mask_path)):
            continue
        im = _imread(im_path)
        mask_obj = decode_object_mask(_imread(mask_path)[:, :, :3], obj_id)
        if not mask_obj.any():
            continue
        if is_train:
            im_out = im_proc.resize_and_pad(im, input_H, input_W)
            im_out = np.clip(np.rint(im_out), 0, 255).astype(np.uint8)
            mask_out = im_proc.resize_and_pad(
                mask_obj.astype(np.float32), input_H, input_W)
        else:
            im_out, mask_out = im, mask_obj
        text = text_proc.preprocess_sentence(sent, vocab_dict, T)
        np.savez(os.path.join(data_folder, f"refvos_{setname}_{n_batch}.npz"),
                 text_batch=np.asarray(text, np.int32),
                 im_batch=im_out, mask_batch=(mask_out > 0),
                 sent_batch=[sent])
        written += 1
    return written


def generate_trainmeta(meta_expressions_path: str, mask_dir: str,
                       out_path: str) -> int:
    """Scan YouTube-VOS meta_expressions.json + PNG masks; keep only frames
    where the referred object's palette color is present; write
    [im, mask, exp, obj_id] records (generate_trainmeta.py:29-48)."""
    with open(meta_expressions_path) as f:
        meta = json.load(f)["videos"]
    records = []
    for vid, vdata in sorted(meta.items()):
        frames = vdata["frames"]
        for eid, edata in sorted(vdata["expressions"].items()):
            obj_id = str(edata["obj_id"])
            color = np.asarray(OBJECT_COLOR[obj_id], np.uint8)
            for frame in frames:
                mask_rel = f"{vid}/{frame}.png"
                mask_path = os.path.join(mask_dir, mask_rel)
                if not os.path.isfile(mask_path):
                    continue
                mask = _imread(mask_path)[:, :, :3]
                if np.any(np.all(mask == color, axis=-1)):
                    records.append([f"{vid}/{frame}.jpg", mask_rel,
                                    edata["exp"], obj_id])
    with open(out_path, "w") as f:
        json.dump(records, f)
    return len(records)


def generate_black_submission(meta_expressions_path: str, out_dir: str,
                              height: int = 720, width: int = 1280) -> int:
    """All-black PNG scaffolding for every video/expression/frame
    (generate_black.py:13-37)."""
    from PIL import Image
    with open(meta_expressions_path) as f:
        meta = json.load(f)["videos"]
    black = Image.fromarray(np.zeros((height, width), np.uint8))
    n = 0
    for vid, vdata in sorted(meta.items()):
        for eid in sorted(vdata["expressions"]):
            d = os.path.join(out_dir, vid, eid)
            os.makedirs(d, exist_ok=True)
            for frame in vdata["frames"]:
                black.save(os.path.join(d, f"{frame}.png"))
                n += 1
    return n


def main(argv=None):
    """CLI mirroring the reference surface (build_batches.py:190-213) with
    the COCO/UNC/Gref path enabled."""
    import argparse
    ap = argparse.ArgumentParser("cmpc_refseg_torch batch builder")
    ap.add_argument("-d", default="referit",
                    choices=("referit", "unc", "unc+", "Gref", "refvos"))
    ap.add_argument("-t", default="trainval",
                    help="setname: trainval/train/val/test/testA/testB")
    ap.add_argument("-imdir", default="", help="image folder (refvos)")
    ap.add_argument("-maskdir", default="", help="mask folder (refvos)")
    ap.add_argument("-meta", default="", help="meta_expressions.json (refvos)")
    ap.add_argument("-savedir", default="", help="export directory (refvos)")
    ap.add_argument("-inrange", nargs="+", type=int)
    ap.add_argument("-data_root", default="./data")
    ap.add_argument("-out_root", default=".")
    ap.add_argument("-T", type=int, default=20)
    ap.add_argument("-H", type=int, default=320)
    ap.add_argument("-W", type=int, default=320)
    args = ap.parse_args(argv)

    if args.d == "referit":
        n = build_referit_batches(args.t, args.T, args.H, args.W,
                                  data_root=args.data_root,
                                  out_root=os.path.join(args.out_root,
                                                        "referit"))
    elif args.d == "refvos":
        rng = (range(args.inrange[0], args.inrange[1])
               if args.inrange else None)
        n = build_refvos_batches(
            args.t, args.T, args.H, args.W, im_dir=args.imdir,
            mask_dir=args.maskdir, meta_expressions=args.meta,
            save_dir=args.savedir or args.out_root, inrange=rng,
            vocab_file=os.path.join(args.data_root, "vocabulary_Gref.txt"))
    else:
        n = build_coco_batches(args.d, args.t, args.T, args.H, args.W,
                               data_root=args.data_root,
                               out_root=args.out_root)
    print(f"wrote {n} batches")


if __name__ == "__main__":
    main()
