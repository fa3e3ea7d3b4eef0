"""The ADM attention block's work from its shapes: GroupNorm, the qkv
product, softmax attention per head, the output projection and the
residual, on bf16 operands."""

from __future__ import annotations

BF16 = 2


def block_flops(b: int, c: int, n: int) -> float:
    """Matmul operations (a multiply-add counts 2) of one call at batch b,
    c channels and n = h * w tokens: qkv 2 n c 3c, scores and the
    probabilities times v 2 * 2 n^2 c (over all heads), proj 2 n c^2."""
    return b * (2.0 * n * c * 3 * c + 4.0 * n * n * c + 2.0 * n * c * c)


def block_bytes(b: int, c: int, n: int) -> float:
    """Each input read once and each output written once: x (b, n, c), the
    GroupNorm's scale and shift, the qkv weight (3c, c) and bias, the proj
    weight (c, c) and bias, and the output (b, n, c)."""
    return BF16 * (2.0 * b * n * c + 2 * c + 3 * c * c + 3 * c + c * c + c)
