"""Tracing and profiling (the counterpart of the JAX package's
utils/profiling.py).

The reference's only observability is manual wall-clock deltas through a
``MovingAverage`` window (util/functions.py:4-40, used at
trainval_model.py:78-79,118-120) and a per-sample average inference-time
print (trainval_model.py:205,260,287).  Here:

* :class:`StepTimer` — per-step wall-clock stats with warmup exclusion and
  a MovingAverage window, for train/eval loop hot-path timing (a copy).
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (host and, on CUDA, device timelines) into a directory.
* :func:`annotate` — a named ``torch.profiler.record_function`` scope, so
  host-side phases (input pipeline, checkpoint, eval) show in the trace.
* :func:`device_memory_stats` — per-device CUDA memory snapshot.

torch is imported by the functions that need it, not by the module.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

from cmpc_refseg_torch.utils.moving_average import MovingAverage


class StepTimer:
    """Wall-clock step timing with warmup exclusion.

    The first ``warmup`` laps (kernel builds, allocator growth) are
    recorded separately so the steady-state rate is not polluted by them.
    """

    def __init__(self, window_size: int = 100, warmup: int = 1):
        self.window = MovingAverage(window_size)
        self.warmup = warmup
        self.laps = 0
        self.warmup_time = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.lap()
        return False

    def start(self):
        self._t0 = time.perf_counter()

    def lap(self) -> float:
        """Record one step; returns its duration in seconds."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.lap() before start()")
        dt = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        if self.laps < self.warmup:
            self.warmup_time += dt
        else:
            self.window.add(dt)
        self.laps += 1
        return dt

    @property
    def mean_step_time(self) -> float:
        return self.window.get() if len(self.window) else 0.0

    @property
    def steps_per_sec(self) -> float:
        t = self.mean_step_time
        return 1.0 / t if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.laps,
            "mean_step_time_s": self.mean_step_time,
            "steps_per_sec": self.steps_per_sec,
            "warmup_steps": min(self.laps, self.warmup),
            "warmup_time_s": self.warmup_time,
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (host activity,
    and the device's where CUDA is available) and write its Chrome trace
    to ``<log_dir>/trace.json`` (chrome://tracing, Perfetto).  Yields the
    profiler, whose ``key_averages()`` hold the block's ops and kernels
    once it has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named host-side annotation scope appearing in captured traces."""
    from torch.profiler import record_function

    return record_function(name)


def device_memory_stats() -> dict:
    """{'cuda:i': torch.cuda.memory_stats(i)} for each CUDA device whose
    allocator has stats; {} without CUDA, as the JAX package's returns on
    a CPU backend."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = dict(torch.cuda.memory_stats(i))
        if stats:
            out[f"cuda:{i}"] = stats
    return out
