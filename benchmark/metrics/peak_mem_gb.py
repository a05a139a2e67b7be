"""torch.cuda.max_memory_allocated() over the warmed, timed window, in GB
(1e9 bytes): it decides the batch a user can fit."""


def read(ctx):
    return ctx.peak_bytes / 1e9
