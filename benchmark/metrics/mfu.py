"""whole step: model FLOPs a sample (the reference's forward, and for
training the head's backward, counted by FlopCounterMode) times the
window's samples per second, over the bf16 tensor-core peak."""


def read(ctx):
    if not ctx.flops_per_sample or not ctx.samples_per_s:
        return None
    return 100.0 * ctx.flops_per_sample * ctx.samples_per_s \
        / ctx.peaks.BF16_FLOPS
