"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit)."""

BF16_FLOPS = 989e12     # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES = 3.35e12     # bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for `flops` bf16 operations
    moving `nbytes` bytes: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
