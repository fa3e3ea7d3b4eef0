"""Bias + activation and channels-last GroupNorm (counterpart of
ddmi_tpu/ops/fused.py).

The port's UNets and VAEs normalise with torch's own `nn.GroupNorm`, which
takes its statistics in fp32 for bf16 inputs.  `group_norm_stats_mxu`,
`group_norm` and `FastGroupNorm` are the JAX package's channels-last
GroupNorm with its `{scale, bias}` parameters: on the TPU the statistics
ran as products with a ones vector on the matrix unit; here they are fp32
means in plain PyTorch, with the same fast-variance formula, E[x^2] -
E[x]^2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2, scale: float = SQRT2):
    """bias-add over the trailing channel dim + LeakyReLU * scale."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.ndim - 1) + (-1,))
    return F.leaky_relu(x, negative_slope) * scale


def scaled_leaky_relu(x, negative_slope: float = 0.2):
    """LeakyReLU * sqrt(2) without bias."""
    return F.leaky_relu(x, negative_slope) * SQRT2


def group_norm_stats_mxu(x: torch.Tensor, num_groups: int):
    """x (B, *spatial, C) -> (mean, var), each (B, num_groups) fp32: the
    per-channel first and second moments over the spatial positions in
    fp32, averaged over each group's channels, var = E[x^2] - E[x]^2."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.reshape(B, -1, C).float()
    m1 = xf.mean(1)
    m2 = (xf * xf).mean(1)
    gm1 = m1.reshape(B, num_groups, C // num_groups).mean(-1)
    gm2 = m2.reshape(B, num_groups, C // num_groups).mean(-1)
    return gm1, gm2 - gm1 ** 2


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Channels-last GroupNorm on `group_norm_stats_mxu`'s statistics; the
    statistics are cast to x's dtype before they are applied, as in JAX."""
    mean, var = group_norm_stats_mxu(x, num_groups)
    C = x.shape[-1]
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (C,)
    per_ch = lambda g: g.repeat_interleave(C // num_groups, dim=-1).reshape(shape)
    inv = per_ch(torch.rsqrt(var + eps)).to(x.dtype)
    mu = per_ch(mean).to(x.dtype)
    return (x - mu) * inv * scale.to(x.dtype) + bias.to(x.dtype)


class FastGroupNorm(nn.Module):
    """`group_norm` as a module with flax GroupNorm's parameters, `scale`
    (ones) and `bias` (zeros), each (C,)."""

    def __init__(self, num_channels: int, num_groups: int = 32, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return group_norm(x, self.scale, self.bias, self.num_groups, self.epsilon)
