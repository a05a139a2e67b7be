"""Async image writer, the port's copy of the JAX package's (reference:
util/save_image_worker.py — daemon thread + queue for non-blocking PNG
writes during video-set inference, test.py:249,329)."""

from __future__ import annotations

import os
import queue
import threading

import numpy as np


class SaveImageWorker:
    def __init__(self, maxsize: int = 64):
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from PIL import Image
        while True:
            item = self._queue.get(block=True)
            if item is None:
                self._queue.task_done()
                break
            path, array = item
            os.makedirs(os.path.dirname(path), exist_ok=True)
            arr = np.asarray(array)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(path)
            self._queue.task_done()

    def save_image(self, path: str, array) -> None:
        self._queue.put((path, array), block=True)

    def flush(self) -> None:
        self._queue.join()
