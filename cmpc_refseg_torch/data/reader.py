"""Batch readers with background prefetch (the JAX package's
data/reader.py, a copy: framework-free host code, numpy only).

Reference pattern: a daemon thread fills a bounded queue from disk while the
train loop consumes (util/data_reader.py:8-66, util/data_reader_refvos.py:48-110).
The device step runs asynchronously while the host decodes the next batch.
Adds what the reference lacks: batch COLLATION to [B, ...] arrays (the
reference assembles batches in the train loop, one sess.run feed per sample —
trainval_model.py:82-96) and deterministic epoch seeding.  The epoch
permutation, the shard stride and the multi-host trim are the JAX
package's, draw for draw.

Nothing here imports torch: `ProcessPrefetchReader`'s spawned workers
import this module and their dataset's, and must not pay torch's import
or touch a CUDA device.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def _shard_length(num_samples: int, shard_count: int) -> int:
    """Per-shard epoch length under multi-host striding.

    The epoch permutation is TRIMMED to the largest multiple of
    `shard_count` before striding so every process sees exactly the same
    number of samples per epoch and re-draws the shared-seed permutation in
    lockstep.  Without the trim, shards of a non-divisible dataset advance
    epochs at different read counts and from the first epoch boundary on
    stride DIFFERENT permutations — silently duplicating/skipping samples
    across hosts."""
    n = num_samples - num_samples % shard_count
    return n // shard_count


def _validate_sharding(num_samples: int, shard_index: int, shard_count: int):
    if not (0 <= shard_index < shard_count):
        raise ValueError(f"shard_index {shard_index} out of range for "
                         f"shard_count {shard_count}")
    if _shard_length(num_samples, shard_count) == 0:
        raise ValueError(
            f"shard_count {shard_count} exceeds dataset size {num_samples}: "
            "every shard's trimmed epoch would be empty")


class PrefetchReader:
    """Generic sample reader: `load_fn(index) -> dict of np arrays`,
    shuffled per epoch, prefetched by daemon threads.

    ``num_workers=1`` (default) preserves exact epoch ordering (the
    reference's single prefetch thread, util/data_reader.py:8-27).  With
    more workers, decode/resize parallelize across an index queue — needed
    to keep a device fed — at the cost of within-epoch completion-order
    nondeterminism (each epoch still covers every sample exactly once).
    """

    def __init__(self, num_samples: int, load_fn: Callable[[int], dict],
                 shuffle: bool = True, prefetch_num: int = 8, seed: int = 0,
                 num_workers: int = 1, shard_index: int = 0,
                 shard_count: int = 1):
        """`shard_index`/`shard_count`: multi-host data sharding.  Every
        process draws the SAME per-epoch permutation (same seed) and walks
        only its `shard_index::shard_count` stride of it, so the processes
        jointly cover each epoch exactly once with disjoint samples (the
        per-process slice of SURVEY.md section 5.8's global batch).  When
        num_samples is not divisible by shard_count, the trailing
        ``num_samples % shard_count`` samples of each epoch's permutation
        are dropped (standard multi-host trim) so all processes advance
        epochs in lockstep."""
        _validate_sharding(num_samples, shard_index, shard_count)
        self.num_samples = num_samples
        self.load_fn = load_fn
        self.shuffle = shuffle
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.n_batch = 0
        self.n_epoch = 0
        self._rng = np.random.default_rng(seed)
        self._queue: "queue.Queue[dict]" = queue.Queue(maxsize=prefetch_num)
        if num_workers <= 1:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        else:
            self._idx_queue: "queue.Queue[int]" = queue.Queue(
                maxsize=max(prefetch_num, 2 * num_workers))
            threading.Thread(target=self._feed_indices, daemon=True).start()
            for _ in range(num_workers):
                threading.Thread(target=self._worker, daemon=True).start()

    def _epoch_order(self) -> np.ndarray:
        order = (self._rng.permutation(self.num_samples) if self.shuffle
                 else np.arange(self.num_samples))
        usable = self.num_samples - self.num_samples % self.shard_count
        return order[:usable][self.shard_index::self.shard_count]

    def _feed_indices(self):
        order = self._epoch_order()
        pos = 0
        while True:
            self._idx_queue.put(int(order[pos]), block=True)
            pos = (pos + 1) % len(order)
            if pos == 0:
                order = self._epoch_order()

    def _worker(self):
        while True:
            idx = self._idx_queue.get(block=True)
            try:
                sample = self.load_fn(idx)
            except BaseException as e:
                self._queue.put(e, block=True)
                return
            self._queue.put(sample, block=True)

    def _run(self):
        order = self._epoch_order()
        pos = 0
        while True:
            try:
                sample = self.load_fn(int(order[pos]))
            except BaseException as e:  # propagate to the consumer —
                # a silently dead worker deadlocks read() forever
                self._queue.put(e, block=True)
                return
            self._queue.put(sample, block=True)
            pos = (pos + 1) % len(order)
            if pos == 0:
                order = self._epoch_order()

    def read(self) -> dict:
        sample = self._queue.get(block=True)
        if isinstance(sample, BaseException):
            raise RuntimeError(
                f"prefetch worker failed: {sample!r}") from sample
        local_n = _shard_length(self.num_samples, self.shard_count)
        self.n_batch = (self.n_batch + 1) % local_n
        self.n_epoch += (self.n_batch == 0)
        return sample

    def read_batch(self, batch_size: int, keys: Optional[Sequence[str]] = None
                   ) -> dict:
        """Collate `batch_size` samples into stacked [B, ...] arrays."""
        samples = [self.read() for _ in range(batch_size)]
        keys = keys or samples[0].keys()
        out = {}
        for k in keys:
            vals = [np.asarray(s[k]) for s in samples]
            out[k] = np.stack(vals, axis=0)
        return out


class NpzReader(PrefetchReader):
    """Offline-batch reader over per-sample .npz files written by the batch
    builders (reference: util/data_reader.py reading build_batches.py output
    '<folder>/<prefix>_<n>.npz')."""

    def __init__(self, data_folder: str, data_prefix: str, shuffle=True,
                 prefetch_num: int = 8, seed: int = 0, id2name=None,
                 shard_index: int = 0, shard_count: int = 1):
        """`id2name`: optional {str(sample_id): image_name} map attached to
        each sample as 'img_name' (reference util/data_reader_ignore.py:8-23,
        used by visualization scripts to name their dumps)."""
        self.data_folder = data_folder
        self.data_prefix = data_prefix
        self.id2name = id2name
        n = 0
        while os.path.isfile(self._path(n)):
            n += 1
        if n == 0:
            raise RuntimeError(f"no batches found at {data_folder}/"
                               f"{data_prefix}_*.npz")
        super().__init__(n, self._load, shuffle, prefetch_num, seed,
                         shard_index=shard_index, shard_count=shard_count)

    def _path(self, i: int) -> str:
        return os.path.join(self.data_folder, f"{self.data_prefix}_{i}.npz")

    def _load(self, i: int) -> dict:
        with np.load(self._path(i), allow_pickle=True) as z:
            out = {k: z[k] for k in z.files}
        if self.id2name is not None:
            out["img_name"] = self.id2name[str(i)]
        return out


def batch_iterator(reader: PrefetchReader, batch_size: int,
                   keys: Optional[Sequence[str]] = None) -> Iterator[dict]:
    while True:
        yield reader.read_batch(batch_size, keys)


class ProcessPrefetchReader:
    """Multi-PROCESS sample loader: decode/resize are GIL-bound in Python
    threads (measured: threads scale NEGATIVELY), so feeding a device at
    hundreds of samples/s requires worker processes.

    `dataset_factory` is a picklable zero-arg callable returning an object
    with `load(i) -> dict` and `__len__`; each spawned worker constructs its
    own instance (no live-object pickling, no inherited torch or CUDA
    state — spawn, not fork).  Epoch order is produced in the parent; completion
    order across workers is nondeterministic.
    """

    def __init__(self, dataset_factory, num_samples: int, shuffle=True,
                 num_workers: int = 4, prefetch_num: int = 32, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        import multiprocessing as mp
        _validate_sharding(num_samples, shard_index, shard_count)
        ctx = mp.get_context("spawn")
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.n_batch = 0
        self.n_epoch = 0
        self._rng = np.random.default_rng(seed)
        self._out = ctx.Queue(maxsize=prefetch_num)
        self._idx = ctx.Queue(maxsize=max(prefetch_num, 2 * num_workers))
        self._procs = [
            ctx.Process(target=_process_worker_main,
                        args=(dataset_factory, self._idx, self._out),
                        daemon=True)
            for _ in range(num_workers)]
        for p in self._procs:
            p.start()
        threading.Thread(target=self._feed, daemon=True).start()

    def _epoch_order(self) -> np.ndarray:
        order = (self._rng.permutation(self.num_samples) if self.shuffle
                 else np.arange(self.num_samples))
        usable = self.num_samples - self.num_samples % self.shard_count
        return order[:usable][self.shard_index::self.shard_count]

    def _feed(self):
        order = self._epoch_order()
        pos = 0
        while True:
            self._idx.put(int(order[pos]), block=True)
            pos = (pos + 1) % len(order)
            if pos == 0:
                order = self._epoch_order()

    def read(self) -> dict:
        sample = self._out.get(block=True)
        if isinstance(sample, str) and sample.startswith("__error__"):
            raise RuntimeError(f"prefetch worker failed: {sample[9:]}")
        local_n = _shard_length(self.num_samples, self.shard_count)
        self.n_batch = (self.n_batch + 1) % local_n
        self.n_epoch += (self.n_batch == 0)
        return sample

    def read_batch(self, batch_size: int,
                   keys: Optional[Sequence[str]] = None) -> dict:
        samples = [self.read() for _ in range(batch_size)]
        keys = keys or samples[0].keys()
        return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0)
                for k in keys}

    def close(self):
        """Terminate the workers and wait for them to exit."""
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=10)


def _process_worker_main(dataset_factory, idx_q, out_q):
    try:
        import cv2
        cv2.setNumThreads(1)   # one process = one core; avoid oversubscribe
    except Exception:
        pass
    try:
        ds = dataset_factory()
    except BaseException as e:
        out_q.put(f"__error__{e!r}")
        return
    while True:
        i = idx_q.get(block=True)
        try:
            out_q.put(ds.load(i))
        except BaseException as e:
            out_q.put(f"__error__{e!r}")
            return
