"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

BF16_FLOPS = 989e12  # tensor cores, bf16 in, float32 accumulate
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the memory's peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
