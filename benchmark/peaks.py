"""The frozen table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates at the 700 W limit) and the least time of a piece of work."""

BF16_FLOPS = 989e12      # tensor-core bf16 peak
F32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bandwidth


def least_seconds(flops_mm, ops_f32, nbytes):
    """The larger of the bf16 products at the tensor-core peak, the f32
    elementwise work at the f32 peak (the two units overlap) and the bytes
    at the memory rate."""
    return max(flops_mm / BF16_FLOPS, ops_f32 / F32_FLOPS,
               nbytes / HBM_BYTES)
