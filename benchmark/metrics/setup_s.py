"""Process start to the first timed call (host clock): imports, building
or loading the CUDA libraries, the weights, the inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s
