"""device: the share of the traced window in which no operation ran on the
device (kernels, copies and sets; their union, from the profiler's
trace)."""


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
