"""models: the share of device kernel time in kernels that are neither the
program's `cmpc::` kernels nor convolutions nor GEMMs (the patterns of
cmpc_refseg_torch/utils/profile_forward.py): the glue between them, such
as the backbone's folded-BN affine and the recompute's products."""


def read(ctx):
    total = ctx.trace.kernel_seconds()
    if total <= 0:
        return None
    return 100.0 * ctx.trace.kernel_seconds("other") / total
