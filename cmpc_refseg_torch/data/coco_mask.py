"""COCO segmentation decoding (polygons + RLE) without pycocotools (the JAX
package's data/coco_mask.py, a copy).

The reference's UNC/Gref/COCO batch builder (build_batches.py:79-124,
commented out upstream but the lineage of the eval npz batches) decodes
annotation masks with `pycocotools.mask.frPyObjects` + `decode`.  This module
reimplements the three COCO segmentation encodings from the documented
format so the builder runs without the external C extension:

- polygon lists  [[x0, y0, x1, y1, ...], ...]      -> filled rasterization
- uncompressed RLE  {"counts": [int, ...], "size": [h, w]}
- compressed RLE    {"counts": "<ascii string>",  "size": [h, w]}
  (COCO's LEB128-style packing: 6-bit chars offset by 48 — 5 value bits +
  1 continuation bit, sign-extended, counts delta-coded against counts[i-2])

COCO RLE is column-major (Fortran order) and starts with a run of zeros.
"""

from __future__ import annotations

import numpy as np


def rle_counts_from_string(s: str) -> list:
    """Decode COCO's compressed RLE count string to a list of run lengths."""
    counts = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))   # sign-extend the last chunk
            k += 1
        if len(counts) > 2:
            x += counts[-2]                # delta vs the same-parity run
        counts.append(x)
    return counts


def rle_string_from_counts(counts) -> str:
    """Inverse of rle_counts_from_string (for tests / writing annotations)."""
    out = []
    counts = list(counts)
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            # arithmetic shift keeps sign; stop when remaining bits mirror
            # the chunk's sign bit
            more = not (x == 0 and not (chunk & 0x10)
                        or x == -1 and (chunk & 0x10))
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


def mask_from_rle_counts(counts, h: int, w: int) -> np.ndarray:
    """Runs (column-major, zeros first) -> bool [h, w] mask."""
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for c in counts:
        c = int(c)
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    return flat.reshape((w, h)).T    # Fortran order


def rle_counts_from_mask(mask: np.ndarray) -> list:
    """bool [h, w] mask -> column-major run lengths (zeros first)."""
    flat = np.asarray(mask, bool).T.reshape(-1)
    counts = []
    run_val = False
    run_len = 0
    for v in flat:
        if v == run_val:
            run_len += 1
        else:
            counts.append(run_len)
            run_val = v
            run_len = 1
    counts.append(run_len)
    return counts


def mask_from_polygons(polygons, h: int, w: int) -> np.ndarray:
    """Filled polygon rasterization -> bool [h, w]; union over polygons.

    Matches pycocotools' integer rasterization closely enough for batch
    building (the reference never relies on sub-pixel edges: masks are
    thresholded `> 0` downstream, build_batches.py:122)."""
    from PIL import Image, ImageDraw
    out = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(out)
    for poly in polygons:
        pts = [(float(poly[i]), float(poly[i + 1]))
               for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(out, dtype=bool)


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """COCO annotation 'segmentation' (any encoding) -> bool [h, w].
    Mirrors frPyObjects + decode + max over objects
    (build_batches.py:104-106)."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, str):
            counts = rle_counts_from_string(counts)
        sh, sw = seg.get("size", (h, w))
        return mask_from_rle_counts(counts, int(sh), int(sw))
    return mask_from_polygons(seg, h, w)
