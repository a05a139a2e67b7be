"""Samples (images and expressions, or clips and expressions) whose masks
reached the host in the window, over the window's seconds (host clock,
from the first call's start to the last answer)."""


def read(ctx):
    return ctx.calls * ctx.batch / ctx.seconds if ctx.calls else None
