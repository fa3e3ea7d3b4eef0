"""The attention kernels' work from their operands' shapes (B, nh, n, hd):
softmax(q.k^T * s).v, the short-sequence kernel (`mha_vmem`) and the flash
forward alike, on bf16 q, k, v and output."""

from __future__ import annotations

BF16 = 2


def attention_flops(b: int, nh: int, n: int, hd: int) -> float:
    """Matmul operations (a multiply-add counts 2): the scores q.k^T and the
    probabilities times v, 2 n^2 hd each, per head."""
    return 4.0 * b * nh * n * n * hd


def attention_bytes(b: int, nh: int, n: int, hd: int) -> float:
    """q, k and v read once and the output written once."""
    return BF16 * 4.0 * b * nh * n * hd
