"""The port's data readers and builders against the JAX package's, on the
CPU.  Both are numpy host code, so the comparisons are exact:

- the readers' sample orders (epoch permutations, shard strides, the
  multi-host trim) equal JAX's, read for read, for seeds 0-2 and
  shard_count 1-3 over a sample count no shard_count divides;
- `ProcessPrefetchReader` (2 spawned workers) reads the samples of JAX's
  epochs, each as often, up to its in-flight depth (the order in which
  the workers finish is free);
- `RefVOSDataset`, `RefVOSReader`, `RefVOSBertReader` and `H5Reader` give
  equal arrays, on the PIL path, the fast-decode path and with anchors;
- the COCO mask codecs and the polygon rasterizer give equal arrays;
- each builder writes the same files (npz arrays equal, json equal, PNGs
  equal), on fixtures of tests/test_builders.py's kind;
- the image and text helpers equal JAX's;
- importing the port's data modules (what a spawned reader worker
  imports) loads no torch.
"""

import importlib
import json
import os
import pickle
import subprocess
import sys
from collections import Counter
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from cmpc_refseg_torch.data import builders as tb
from cmpc_refseg_torch.data import coco_mask as tcm
from cmpc_refseg_torch.data import image as timg
from cmpc_refseg_torch.data import reader as tr
from cmpc_refseg_torch.data import refvos as tv
from cmpc_refseg_torch.data import text as ttext
from cmpc_refseg_torch.data.anchors import DEFAULT_ANCHORS
from cmpc_refseg_torch.data.h5_reader import H5Reader as TH5Reader
from cmpc_refseg_tpu.data import builders as jb
from cmpc_refseg_tpu.data import coco_mask as jcm
from cmpc_refseg_tpu.data import image as jimg
from cmpc_refseg_tpu.data import reader as jr
from cmpc_refseg_tpu.data import refvos as jv
from cmpc_refseg_tpu.data import text as jtext
from cmpc_refseg_tpu.data.h5_reader import H5Reader as JH5Reader

REPO = Path(__file__).resolve().parent.parent
N_SAMPLES = 7                 # divisible by no shard_count of 2-3


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# import: no torch in a reader worker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [
    "data.reader", "data.refvos", "data.builders", "data.coco_mask",
    "data.h5_reader", "data.text", "data.image", "data.anchors", "cli",
    "utils.logging", "utils.profiling", "data.a2d", "cli_video",
    "infer_video", "utils.save_image_worker"])
def test_module_imports_no_torch(module):
    """The modules a spawned reader worker imports (its dataset's and the
    main module's) load no torch."""
    code = (f"import sys; import cmpc_refseg_torch.{module}; "
            "sys.exit(int('torch' in sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr or "torch was imported"


# ---------------------------------------------------------------------------
# readers: sample orders
# ---------------------------------------------------------------------------

def _reads(reader, n):
    return [int(reader.read()["i"]) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shard_count", [1, 2, 3])
def test_prefetch_reader_orders_match_jax(seed, shard_count):
    """Three epochs of each shard, read for read, shuffled and not."""
    for shard_index in range(shard_count):
        for shuffle in (True, False):
            kw = dict(shuffle=shuffle, seed=seed, shard_index=shard_index,
                      shard_count=shard_count)
            readers = [m.PrefetchReader(N_SAMPLES, lambda i: {"i": i}, **kw)
                       for m in (tr, jr)]
            n = 3 * (N_SAMPLES // shard_count)
            got, want = (_reads(r, n) for r in readers)
            assert got == want
            assert readers[0].n_epoch == readers[1].n_epoch == 3


@pytest.fixture
def npz_dir(tmp_path):
    for i in range(N_SAMPLES):
        np.savez(tmp_path / f"unc_val_{i}.npz", i=np.int64(i),
                 im_batch=np.full((3, 4, 3), i, np.uint8))
    return str(tmp_path)


@pytest.mark.parametrize("seed, shard_count", [(0, 1), (1, 2), (2, 3)])
def test_npz_reader_orders_and_batches_match_jax(npz_dir, seed, shard_count):
    kw = dict(seed=seed, shard_index=shard_count - 1,
              shard_count=shard_count,
              id2name={str(i): f"{i}.jpg" for i in range(N_SAMPLES)})
    readers = [m.NpzReader(npz_dir, "unc_val", **kw) for m in (tr, jr)]
    assert readers[0].num_samples == readers[1].num_samples == N_SAMPLES
    for _ in range(4):
        _assert_same(*(r.read_batch(2) for r in readers))
    batches = [next(m.batch_iterator(r, 3, ["i"]))
               for m, r in zip((tr, jr), readers)]
    _assert_same(*batches)


@pytest.mark.parametrize("bad", [dict(shard_index=2, shard_count=2),
                                 dict(shard_index=0, shard_count=8)])
def test_sharding_rejections_match_jax(bad):
    for m in (tr, jr):
        with pytest.raises(ValueError):
            m.PrefetchReader(N_SAMPLES, lambda i: {"i": i}, **bad)


def test_worker_errors_propagate():
    def boom(i):
        raise KeyError(i)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        tr.PrefetchReader(3, boom).read()


# ---------------------------------------------------------------------------
# RefVOS: datasets and readers
# ---------------------------------------------------------------------------

def _refvos_tree(root, n=N_SAMPLES, native=(96, 128), palette_mask=False):
    """JPEG frames of smooth content and (RGB or palette) PNG masks, one
    expression per frame, each its own sentence "a thing <i>"."""
    from PIL import Image
    os.makedirs(os.path.join(root, "J", "v"), exist_ok=True)
    os.makedirs(os.path.join(root, "A", "v"), exist_ok=True)
    rng = np.random.default_rng(1)
    h, w = native
    meta = []
    for i in range(n):
        small = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
        im = np.asarray(Image.fromarray(small).resize((w, h),
                                                      Image.BILINEAR))
        Image.fromarray(im).save(os.path.join(root, "J", "v", f"f{i}.jpg"),
                                 quality=90)
        m = np.zeros((h, w), np.uint8)
        m[h // 4 + i:h // 2 + 2 * i, w // 4:w // 2 + 3 * i] = 1
        if palette_mask:
            pm = Image.fromarray(m, mode="P")
            pm.putpalette([0, 0, 0] + list(tv.OBJECT_COLOR["1"])
                          + [0] * (254 * 3))
            pm.save(os.path.join(root, "A", "v", f"f{i}.png"))
        else:
            rgb = np.zeros((h, w, 3), np.uint8)
            rgb[m > 0] = tv.OBJECT_COLOR["1"]
            Image.fromarray(rgb).save(os.path.join(root, "A", "v",
                                                   f"f{i}.png"))
        meta.append([f"v/f{i}.jpg", f"v/f{i}.png", f"a thing {i}", "1"])
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(["<pad>", "<go>", "<eos>", "a", "thing", "<unk>"]))
    return (os.path.join(root, "J"), os.path.join(root, "A"),
            os.path.join(root, "meta.json"), os.path.join(root, "vocab.txt"))


@pytest.mark.parametrize("fast_decode", [False, True])
@pytest.mark.parametrize("anchors", [False, True])
@pytest.mark.parametrize("palette_mask", [False, True])
def test_refvos_dataset_matches_jax(tmp_path, fast_decode, anchors,
                                    palette_mask):
    paths = _refvos_tree(str(tmp_path), n=3, palette_mask=palette_mask)
    kw = dict(T=6, input_h=40, input_w=32, fast_decode=fast_decode,
              anchors=DEFAULT_ANCHORS if anchors else None)
    datasets = [m.RefVOSDataset(*paths, **kw) for m in (tv, jv)]
    assert len(datasets[0]) == len(datasets[1]) == 3
    for i in range(3):
        got, want = (d.load(i) for d in datasets)
        _assert_same(got, want)
        assert ("label_bbox" in got) == anchors


def test_refvos_reader_matches_jax(tmp_path):
    paths = _refvos_tree(str(tmp_path))
    readers = [m.RefVOSReader(*paths, T=6, input_h=32, input_w=32, seed=1)
               for m in (tv, jv)]
    for _ in range(3):
        _assert_same(*(r.read_collated(3) for r in readers))
    _assert_same(*(r.read_batch() for r in readers))
    readers[0].close()


def test_refvos_preprocess_sample_matches_jax():
    rng = np.random.default_rng(3)
    im = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    mask = np.zeros((50, 70, 3), np.uint8)
    mask[10:30, 5:40] = tv.OBJECT_COLOR["2"]
    vocab = {"<pad>": 0, "<go>": 1, "<eos>": 2, "<unk>": 3, "big": 4}
    for anchors in (None, DEFAULT_ANCHORS):
        _assert_same(*(m.preprocess_sample(im, mask, "a big cat.", "2",
                                           vocab, 5, 32, 48, anchors)
                       for m in (tv, jv)))
    assert tv.OBJECT_COLOR == jv.OBJECT_COLOR
    assert tv._resized_geom(720, 1280, 320, 320) == \
        jv._resized_geom(720, 1280, 320, 320)


def _warm_refvos_dataset(module_name, *args):
    """A RefVOSDataset that has loaded one sample.  A worker's first load
    pays for the image path's lazy imports (~0.16 s against ~2 ms for each
    later one on the CPU), so a cold worker would hold its index while a
    warm one runs far past the in-flight depth."""
    dataset = importlib.import_module(module_name).RefVOSDataset(*args)
    dataset.load(0)
    return dataset


def test_process_prefetch_reader_epochs_match_jax(tmp_path):
    """2 spawned workers, shard 0 of 2, 10 epochs: every sample read is one
    the shard's epochs hold (JAX's single-thread order), as often.
    Completion order across the workers is free, so a sample may arrive
    up to the in-flight depth (the index queue, the workers, the output
    queue: 8 here) before or after its place in that order; each worker
    loads one sample before it takes an index, so that no first load's
    imports stand in that depth."""
    paths = _refvos_tree(str(tmp_path))
    kw = dict(seed=2, shard_index=0, shard_count=2)
    n, depth = 30, 8
    order = jr.PrefetchReader(N_SAMPLES, lambda i: {"i": i}, **kw)
    want = [f"a thing {i}" for i in _reads(order, n + depth)]
    for m, r in ((tv, tr), (jv, jr)):
        factory = partial(_warm_refvos_dataset, m.__name__, *paths, 6, 16,
                          16, None)
        reader = r.ProcessPrefetchReader(factory, N_SAMPLES, num_workers=2,
                                         prefetch_num=2, **kw)
        try:
            got = Counter(str(s) for s in reader.read_batch(
                n, keys=["sent_batch"])["sent_batch"])
            assert reader.n_epoch == n // 3
        finally:
            reader.close()
        assert not got - Counter(want), m
        assert not Counter(want[:n - depth]) - got, m


def test_process_worker_error_propagates(tmp_path):
    factory = partial(tv.RefVOSDataset, str(tmp_path), str(tmp_path),
                      str(tmp_path / "missing.json"), "v.txt")
    r = tr.ProcessPrefetchReader(factory, 2, num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            r.read()
    finally:
        r.close()


def _bert_tree(root, n=3):
    """tests/test_readers.py's BERT fixture, with n frames and features of
    2-8 words."""
    from PIL import Image
    im_dir, mask_dir, bert_dir = (os.path.join(root, d)
                                  for d in ("J", "A", "bert"))
    for d in (im_dir, mask_dir):
        os.makedirs(os.path.join(d, "vid0"))
    os.makedirs(bert_dir)
    rng = np.random.default_rng(0)
    meta = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
                        ).save(os.path.join(im_dir, "vid0", f"f{i}.jpg"))
        mask = np.zeros((24, 32, 3), np.uint8)
        mask[6:18, 8 + i:24] = tv.OBJECT_COLOR["1"]
        Image.fromarray(mask).save(os.path.join(mask_dir, "vid0",
                                                f"f{i}.png"))
        t = 2 + 3 * i
        np.savez(os.path.join(bert_dir, f"vid0_{i}.npz"),
                 feature=rng.standard_normal((t, 16)).astype(np.float32),
                 mask=(np.arange(t) < t - 1).astype(np.float32))
        meta.append([f"vid0/f{i}.jpg", f"vid0/f{i}.png", "a red thing", "1",
                     str(i)])
    meta_path = os.path.join(root, "meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return im_dir, mask_dir, bert_dir, meta_path


def test_refvos_bert_reader_matches_jax(tmp_path):
    paths = _bert_tree(str(tmp_path))
    readers = [m.RefVOSBertReader(*paths, T=6, input_h=32, input_w=32,
                                  seed=4) for m in (tv, jv)]
    for _ in range(2):
        _assert_same(*(r.read_collated(2) for r in readers))
    _assert_same(*(r.read_batch() for r in readers))


def test_h5_reader_matches_jax(tmp_path):
    import h5py
    rng = np.random.default_rng(5)
    q, im = str(tmp_path / "q.h5"), str(tmp_path / "im.h5")
    with h5py.File(q, "w") as f:
        f["answers"] = rng.integers(0, 2, (5, 8, 8)).astype(np.uint8)
        f["image_idxs"] = np.array([2, 0, 1, 1, 2])
        f["refexps"] = rng.integers(0, 20, (5, 6)).astype(np.int32)
    with h5py.File(im, "w") as f:
        f["images"] = rng.integers(0, 255, (3, 8, 8, 3)).astype(np.uint8)
    readers = [m(q, im, seed=7) for m in (TH5Reader, JH5Reader)]
    assert readers[0].num_batch == readers[1].num_batch == 5
    for _ in range(7):
        _assert_same(*(r.read_batch() for r in readers))


# ---------------------------------------------------------------------------
# COCO masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_mask_codecs_match_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(5, 40)), int(rng.integers(5, 40))
    mask = rng.random((h, w)) > rng.uniform(0.2, 0.8)
    counts = tcm.rle_counts_from_mask(mask)
    assert counts == jcm.rle_counts_from_mask(mask)
    s = tcm.rle_string_from_counts(counts)
    assert s == jcm.rle_string_from_counts(counts)
    assert tcm.rle_counts_from_string(s) == jcm.rle_counts_from_string(s)
    big = rng.integers(0, 100000, 25).tolist()
    assert tcm.rle_string_from_counts(big) == jcm.rle_string_from_counts(big)
    np.testing.assert_array_equal(tcm.mask_from_rle_counts(counts, h, w),
                                  jcm.mask_from_rle_counts(counts, h, w))
    polys = [list(rng.uniform(0, min(h, w), 2 * int(rng.integers(2, 7))))
             for _ in range(3)]
    np.testing.assert_array_equal(tcm.mask_from_polygons(polys, h, w),
                                  jcm.mask_from_polygons(polys, h, w))
    for seg in ({"counts": counts, "size": [h, w]},
                {"counts": s, "size": [h, w]}, polys):
        got = tcm.decode_segmentation(seg, h, w)
        np.testing.assert_array_equal(got, jcm.decode_segmentation(seg, h, w))


# ---------------------------------------------------------------------------
# image and text helpers
# ---------------------------------------------------------------------------

def test_image_helpers_match_jax():
    rng = np.random.default_rng(8)
    im = rng.uniform(0, 255, (37, 45, 3)).astype(np.float32)
    masks = np.zeros((3, 37, 45), bool)
    masks[0, 5:20, 3:30] = True
    masks[1, 30:36, 40:44] = True           # masks[2] stays empty
    np.testing.assert_array_equal(timg.bboxes_from_masks(masks),
                                  jimg.bboxes_from_masks(masks))
    np.testing.assert_array_equal(timg.bboxes_from_masks(masks[0]),
                                  jimg.bboxes_from_masks(masks[0]))
    boxes = jimg.bboxes_from_masks(masks[:2])
    mean = timg.IMAGE_MEAN_BGR
    np.testing.assert_array_equal(
        timg.crop_bboxes_subtract_mean(im, boxes, 16, mean),
        jimg.crop_bboxes_subtract_mean(im, boxes, 16, mean))
    np.testing.assert_array_equal(
        timg.crop_masks_subtract_mean(im, masks[:2], 16, mean),
        jimg.crop_masks_subtract_mean(im, masks[:2], 16, mean))
    u8 = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    for x in (u8, im / 255):
        np.testing.assert_array_equal(
            timg.brightness(x, is_random=False, gamma=0.7, gain=1.1),
            jimg.brightness(x, is_random=False, gamma=0.7, gain=1.1))
        np.testing.assert_array_equal(
            timg.brightness(x, rng=np.random.default_rng(3)),
            jimg.brightness(x, rng=np.random.default_rng(3)))


@pytest.mark.parametrize("sentence", ["The man on the LEFT.", "",
                                      "a b c d e f g h i j", "unknown words"])
def test_preprocess_sentence_matches_jax(sentence):
    vocab = {"<pad>": 0, "<go>": 1, "<eos>": 2, "<unk>": 3, "the": 4,
             "man": 5, "on": 6, "left": 7, "a": 8, "b": 9}
    for t in (4, 8):
        assert ttext.preprocess_sentence(sentence, vocab, t) == \
            jtext.preprocess_sentence(sentence, vocab, t)
        assert ttext.preprocess_sentence_lstm(sentence, vocab, t) == \
            jtext.preprocess_sentence_lstm(sentence, vocab, t)


# ---------------------------------------------------------------------------
# builders: the same files
# ---------------------------------------------------------------------------

def _assert_same_files(a: str, b: str):
    """Two directory trees with the same files: npz arrays equal, json
    equal, images decoded equal."""
    from PIL import Image
    files = [sorted(str(p.relative_to(d)) for p in Path(d).rglob("*")
                    if p.is_file()) for d in (a, b)]
    assert files[0] == files[1] and files[0]
    for rel in files[0]:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npz"):
            with np.load(pa) as x, np.load(pb) as y:
                _assert_same(dict(x), dict(y))
        elif rel.endswith(".json"):
            with open(pa) as x, open(pb) as y:
                assert json.load(x) == json.load(y), rel
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)),
                                          np.asarray(Image.open(pb)))
        else:
            assert Path(pa).read_bytes() == Path(pb).read_bytes(), rel


@pytest.fixture
def ytvos(tmp_path):
    """tests/test_builders.py's meta_expressions fixture (object 1 in frame
    f0 only), with frames and a Gref vocabulary."""
    from PIL import Image
    root = str(tmp_path)
    mask_dir = os.path.join(root, "Annotations")
    im_dir = os.path.join(root, "JPEGImages")
    os.makedirs(os.path.join(mask_dir, "v1"))
    os.makedirs(os.path.join(im_dir, "v1"))
    m0 = np.zeros((24, 32, 3), np.uint8)
    m0[4:12, 4:12] = tv.OBJECT_COLOR["1"]
    Image.fromarray(m0).save(os.path.join(mask_dir, "v1", "f0.png"))
    Image.fromarray(np.zeros((24, 32, 3), np.uint8)).save(
        os.path.join(mask_dir, "v1", "f1.png"))
    rng = np.random.default_rng(0)
    for f in ("f0", "f1"):
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
                        ).save(os.path.join(im_dir, "v1", f + ".jpg"))
    meta = {"videos": {"v1": {
        "expressions": {"0": {"exp": "a thing", "obj_id": 1}},
        "frames": ["f0", "f1"]}}}
    meta_path = os.path.join(root, "meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "vocabulary_Gref.txt"), "w") as f:
        f.write("\n".join(["<pad>", "<go>", "<eos>", "<unk>", "a",
                           "thing"]) + "\n")
    return dict(root=root, meta=meta_path, mask_dir=mask_dir, im_dir=im_dir)


def test_generate_trainmeta_and_black_match_jax(ytvos):
    out = {}
    for name, m in (("t", tb), ("j", jb)):
        d = os.path.join(ytvos["root"], name)
        os.makedirs(d)
        assert m.generate_trainmeta(ytvos["meta"], ytvos["mask_dir"],
                                    os.path.join(d, "train_meta.json")) == 1
        assert m.generate_black_submission(ytvos["meta"],
                                           os.path.join(d, "sub"),
                                           height=8, width=10) == 2
        out[name] = d
    _assert_same_files(out["t"], out["j"])


@pytest.mark.parametrize("setname", ["train", "val"])
def test_refvos_builders_match_jax(ytvos, setname):
    out = {}
    for name, m in (("t", tb), ("j", jb)):
        d = os.path.join(ytvos["root"], f"out_{name}")
        n = m.build_refvos_batches(
            setname, 6, 16, 16, im_dir=ytvos["im_dir"],
            mask_dir=ytvos["mask_dir"], meta_expressions=ytvos["meta"],
            save_dir=d, vocab_file=os.path.join(ytvos["root"],
                                                "vocabulary_Gref.txt"))
        assert n == 1
        m.build_refvos_sample(
            os.path.join(ytvos["im_dir"], "v1", "f0.jpg"),
            os.path.join(ytvos["mask_dir"], "v1", "f0.png"), "a thing", "1",
            {"<pad>": 0, "<unk>": 3, "a": 4, "thing": 5}, 6, 16, 16,
            os.path.join(d, "sample.npz"))
        out[name] = d
    _assert_same_files(out["t"], out["j"])


def test_builders_main_matches_jax(ytvos):
    out = {}
    for name, m in (("t", tb), ("j", jb)):
        d = os.path.join(ytvos["root"], f"cli_{name}")
        m.main(["-d", "refvos", "-t", "val", "-imdir", ytvos["im_dir"],
                "-maskdir", ytvos["mask_dir"], "-meta", ytvos["meta"],
                "-savedir", d, "-data_root", ytvos["root"], "-T", "6",
                "-H", "16", "-W", "16", "-inrange", "0", "2"])
        out[name] = d
    _assert_same_files(out["t"], out["j"])


@pytest.fixture
def referit(tmp_path):
    """tests/test_builders.py's ReferIt fixture."""
    from PIL import Image
    from scipy.io import savemat
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "referit", "images"))
    os.makedirs(os.path.join(root, "referit", "mask"))
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)
                    ).save(os.path.join(root, "referit", "images", "7.jpg"))
    seg = np.ones((30, 40), np.int16)
    seg[10:20, 10:30] = 0
    savemat(os.path.join(root, "referit", "mask", "7_1.mat"),
            {"segimg_t": seg})
    for split in ("trainval", "test"):
        with open(os.path.join(root, "referit",
                               f"referit_query_{split}.json"), "w") as f:
            json.dump({"7_1": ["the thing", "a thing"]}, f)
    with open(os.path.join(root, "vocabulary_referit.txt"), "w") as f:
        f.write("\n".join(["<pad>", "<go>", "<eos>", "the", "a", "thing",
                           "<unk>"]))
    return root


@pytest.mark.parametrize("setname", ["trainval", "test"])
def test_referit_builder_matches_jax(referit, setname):
    out = {}
    for name, m in (("t", tb), ("j", jb)):
        d = os.path.join(referit, f"out_{name}")
        assert m.build_referit_batches(setname, 8, 16, 16, data_root=referit,
                                       out_root=d) == 2
        out[name] = d
    _assert_same_files(out["t"], out["j"])


@pytest.fixture
def refer(tmp_path):
    """tests/test_builders.py's REFER fixture: refs(unc).p, instances.json
    (one polygon, one RLE string and one RLE count list), COCO jpgs."""
    from PIL import Image
    root = str(tmp_path)
    ddir = os.path.join(root, "refer", "refcoco")
    os.makedirs(ddir)
    im_dir = os.path.join(root, "coco", "images", "train2014")
    os.makedirs(im_dir)
    with open(os.path.join(root, "vocabulary_Gref.txt"), "w") as f:
        f.write("\n".join(["<pad>", "<go>", "<eos>", "<unk>", "the", "red",
                           "box", "a", "dog"]) + "\n")
    rng = np.random.default_rng(0)
    refs, annotations, images_meta = [], [], []
    for i, split in enumerate(["train", "val", "val"]):
        h, w = 30 + i, 40 + i
        img_id = 100 + i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(im_dir, f"COCO_train2014_{img_id:012d}.jpg"))
        images_meta.append({"id": img_id, "height": h, "width": w})
        mask = np.zeros((h, w), bool)
        mask[5:h - 6, 5:w - 6 - i] = True
        counts = jcm.rle_counts_from_mask(mask)
        seg = [[[5, 5, w - 6, 5, w - 6, h - 6, 5, h - 6]],
               {"counts": jcm.rle_string_from_counts(counts),
                "size": [h, w]},
               {"counts": counts, "size": [h, w]}][i]
        annotations.append({"id": 1000 + i, "image_id": img_id,
                            "segmentation": seg})
        refs.append({"ref_id": i, "ann_id": 1000 + i, "image_id": img_id,
                     "split": split,
                     "sentences": [{"sent": "the red box"},
                                   {"sent": "a dog"}][:i + 1]})
    with open(os.path.join(ddir, "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(ddir, "instances.json"), "w") as f:
        json.dump({"images": images_meta, "annotations": annotations}, f)
    return root


@pytest.mark.parametrize("setname, n", [("train", 1), ("val", 4)])
def test_coco_builder_matches_jax(refer, setname, n):
    out = {}
    for name, m in (("t", tb), ("j", jb)):
        d = os.path.join(refer, f"out_{name}")
        assert m.build_coco_batches("unc", setname, T=6, input_H=32,
                                    input_W=32, data_root=refer,
                                    out_root=d) == n
        out[name] = d
    _assert_same_files(out["t"], out["j"])
    refs = [m.load_refer_dataset(os.path.join(refer, "refer"), "unc")
            for m in (tb, jb)]
    assert refs[0] == refs[1]
    with pytest.raises(ValueError, match="Unknown dataset"):
        tb.load_refer_dataset(refer, "coco")
