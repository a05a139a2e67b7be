"""HDF5 dataset reader (reference: util/h5_reader.py — answers/image_idxs/
refexps per-question store + image array, with background prefetch; the
JAX package's data/h5_reader.py, a copy).  h5py is imported when a reader
is made."""

from __future__ import annotations

import numpy as np

from cmpc_refseg_torch.data.reader import PrefetchReader


class H5Reader:
    def __init__(self, question_h5_path: str, image_h5_path: str,
                 shuffle=True, prefetch_num: int = 8, seed: int = 0):
        import h5py
        self._qf = h5py.File(question_h5_path, "r")
        self._imf = h5py.File(image_h5_path, "r")
        self.answers = self._qf["answers"]
        self.image_idxs = self._qf["image_idxs"]
        self.refexps = self._qf["refexps"]
        self.images = self._imf["images"]
        n = len(self.answers)
        self._reader = PrefetchReader(n, self._load, shuffle, prefetch_num,
                                      seed)
        self.num_batch = n

    def _load(self, i: int) -> dict:
        return {
            "answer": np.asarray(self.answers[i]),
            "refexp": np.asarray(self.refexps[i]),
            "image": np.asarray(self.images[self.image_idxs[i]]),
        }

    def read_batch(self) -> dict:
        return self._reader.read()
