"""Bias + activation (counterpart of ddmi_tpu/ops/fused.py).

GroupNorm is torch's own `nn.GroupNorm` / `F.group_norm`, which takes its
statistics in fp32 for bf16 inputs.  `group_norm_stats_mxu`, a TPU
workaround (statistics on the matrix unit), has no counterpart.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2, scale: float = SQRT2):
    """bias-add over the trailing channel dim + LeakyReLU * scale."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.ndim - 1) + (-1,))
    return F.leaky_relu(x, negative_slope) * scale


def scaled_leaky_relu(x, negative_slope: float = 0.2):
    """LeakyReLU * sqrt(2) without bias."""
    return F.leaky_relu(x, negative_slope) * SQRT2
