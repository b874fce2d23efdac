"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def bound_s(nbytes: float, flops: float, flops_peak: float) -> float:
    """The least time the chip could take: bytes at HBM bandwidth or
    operations at ``flops_peak``, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_peak)
