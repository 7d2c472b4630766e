"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A frozen copy:
later changes to the program must not move the yardstick."""

BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores
HBM_BYTES = 3.35e12      # bytes/s


def least_seconds(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak and the bytes over the memory bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES)
