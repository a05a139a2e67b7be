"""Small file helpers (reference util/io.py; the JAX package's
utils/io.py).  Kept for parity with that module: no entry point of the
port reads a file through them yet (`read_anchors` will feed a v5+ run on
the reference's anchors.txt)."""

from __future__ import annotations

import json

import numpy as np


def load_str_list(fname):
    with open(fname) as f:
        return [line.strip() for line in f]


def save_str_list(str_list, fname):
    with open(fname, "w") as f:
        f.write("\n".join(str_list) + "\n")


def load_json(fname):
    with open(fname) as f:
        return json.load(f)


def save_json(obj, fname):
    with open(fname, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)


def read_anchors(anchor_path: str) -> np.ndarray:
    """An anchor file of space-separated 'w,h' pairs on one line (reference
    util/io.py:36-43, e.g. data/anchors.txt '4.38,4.50 28.66,17.64 ...');
    pairs on separate lines are read too.  Returns [N, 2] float32."""
    with open(anchor_path) as f:
        tokens = f.read().split()
    return np.asarray([[float(x) for x in tok.split(",")] for tok in tokens],
                      dtype=np.float32).reshape(-1, 2)
