"""Reduction of a torch.profiler trace of the traced sub-window to what the
per-layer metrics and the result's `breakdown` read.

`Trace` holds the device operations (kernels, copies and sets) with their
intervals in seconds, the host's calls with theirs, and the window's
interval.  Busy time is the union of the device intervals inside the
window, so overlapping operations count once; an idle gap is a stretch of
the window in which no device operation ran, named by the host call
running at its start.
"""

from __future__ import annotations

import re

# copied from cmpc_refseg_torch/utils/profile_forward.py's CATEGORIES
PORT = re.compile(r"mutan_|spa_affinity|graph_msg|graph_update|se_sum|"
                  r"convlstm_")
CONV = re.compile(r"conv|cudnn|implicit_gemm|xmma_fprop|dgrad", re.I)
GEMM = re.compile(r"gemm|gemv|cutlass|cublas|sm90_xmma", re.I)
NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")


def category(name: str) -> str:
    if "cmpc::" in name or PORT.search(name):
        return "port"
    if CONV.search(name):
        return "conv"
    if GEMM.search(name):
        return "gemm"
    return "other"


def merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, device_ops, host_ops, window, calls):
        """device_ops, host_ops: [(name, start_s, end_s)]; window:
        (start_s, end_s); calls: the calls profiled."""
        w0, w1 = window
        self.window = window
        self.calls = calls
        self.device_ops = [(n, max(s, w0), min(e, w1))
                           for n, s, e in device_ops if e > w0 and s < w1]
        self.host_ops = host_ops

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merge((s, e) for _, s, e in
                                           self.device_ops))

    def kernels(self):
        return [op for op in self.device_ops if not NOT_KERNEL.match(op[0])]

    def kernel_seconds(self, cat=None) -> float:
        return sum(e - s for n, s, e in self.kernels()
                   if cat is None or category(n) == cat)

    def top_ops(self, k=10):
        by = {}
        for n, s, e in self.device_ops:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n[:200], v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k=10):
        """The k longest idle stretches of the window, each named by the
        innermost host call running at its start."""
        busy = merge((s, e) for _, s, e in self.device_ops)
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        return [[self.host_at(g[0]), g[1] - g[0]] for g in gaps]

    def host_at(self, t) -> str:
        best = None
        for n, s, e in self.host_ops:
            if s <= t < e and (best is None or s >= best[1]):
                best = (n, s)
        return best[0][:200] if best else "no host call"


def from_profiler(prof, calls: int) -> Trace:
    """A Trace from a finished torch.profiler.profile of CUDA activity
    alone (the device's operations and the host's CUDA runtime calls; CPU
    activity, aten ops, slows a host-bound call by up to 70% and would
    inflate the idle share) around `calls` calls and the synchronize that
    ends them.  The window runs from the first event to the last."""
    device, host, host_names = [], [], set()
    for ev in prof.events():
        iv = (ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if str(ev.device_type).endswith("CUDA"):
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, *iv))
        else:
            host_names.add(ev.name)
            host.append((ev.name, *iv))
    # a record_function range shows on the device's rows too, under its
    # host name: only kernels, copies and sets are device operations
    device = [op for op in device if op[0] not in host_names]
    spans = [iv for _, *iv in device + host]
    if not spans:
        raise RuntimeError("the trace holds no event")
    window = (min(s for s, _ in spans), max(e for _, e in spans))
    return Trace(device, host, window, calls)
