"""Samples of every train step completed in the window, over the window's
seconds (host clock, from the first step's start to the last loss read
back)."""


def read(ctx):
    return ctx.calls * ctx.batch / ctx.seconds if ctx.calls else None
