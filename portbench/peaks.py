"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): float32 on the CUDA cores, counting a
fused multiply-add as two operations, and HBM3 bandwidth.  A share of a
roofline is stated against these, with the card's power limit printed
beside it."""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the float32 peak and the bytes at the memory peak."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
