"""Training observability: JSONL metric stream + optional TensorBoard (the
JAX package's utils/logging.py, a copy: the same `metrics.jsonl` records).

The reference logs scalars to TensorBoard (CMPC_model.py:481-492, writer at
trainval_model.py:64-65) and prints an eval table.  Here metrics go to a
JSONL file (machine-readable, survives without TB) and optionally to
tensorboardX when available.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, use_tensorboard=True):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": int(step), "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
