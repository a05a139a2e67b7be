"""Tracing and profiling.

The reference's only observability is manual wall-clock deltas through a
``MovingAverage`` window (util/functions.py:4-40, used at
trainval_model.py:78-79,118-120) and a per-sample average inference-time
print (trainval_model.py:205,260,287).  Here:

* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (host and, on CUDA, device timelines) into a directory.
* :func:`span` — a named stage of the program (``cmpc.forward``,
  ``cmpc.step`` and the stages inside them), recorded only while a
  ``torch.profiler`` records.

Spans.  Tracing is on exactly when a profiler records: there is no switch.
Then a span is a ``torch.profiler.record_function`` range, a host user
annotation on the profiler's clock, the clock of the device's kernels and
copies, so an idle stretch of the device can be put down to the stage the
host was in.  A span's parent is the span around it in time (the autograd
engine launches the backward's kernels from its own thread, inside
``cmpc.backward``); the profiler keeps the spans with its trace.  Off, a
span is one call and one check of a C flag, and returns one shared no-op
context.  The names, read by ``benchmark/spans.py``:

* ``cmpc.forward`` (``api.Model.forward``) and ``cmpc.step`` (the train
  step of ``train.trainer.make_train_step``): one call.
* ``cmpc.feed``: the batch moved to the device (and, in a step, expanded
  from uint8 and augmented).
* ``cmpc.backbone``, ``cmpc.text``, ``cmpc.head``, ``cmpc.fusion``,
  ``cmpc.decode``: the forward's stages (``models/model.py``,
  ``models/video.py``).
* ``cmpc.loss``, ``cmpc.backward``, ``cmpc.update``: the step's loss, its
  backward and the optimizer's update.

torch is imported by the functions that need it, not by the module.
"""

from __future__ import annotations

import contextlib
import os

_OFF = contextlib.nullcontext()
_recording = None    # torch.autograd._profiler_enabled, bound on first use


def span(name: str):
    """The stage `name` as a context: a ``record_function`` range while a
    ``torch.profiler`` records, else the shared no-op context."""
    global _recording
    if _recording is None:
        from torch.autograd import _profiler_enabled
        _recording = _profiler_enabled
    if not _recording():
        return _OFF
    from torch.profiler import record_function
    return record_function(name)


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
