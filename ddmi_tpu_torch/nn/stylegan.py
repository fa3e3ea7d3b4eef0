"""StyleGAN2-style modulated 1x1 convolutions on token layouts (counterpart
of ddmi_tpu/nn/stylegan.py, the pieces the image INR uses: kernel size 1, no
up/downsampling).

Parameters carry the reference repo's names and layouts
(models/d2c_vae/blocks.py): `conv.weight` (1, O, I, 1, 1),
`conv.modulation.weight` (I, style_dim), `noise.weight` (1,),
`activate.bias` (O,), `skip.0.weight` (O, I, 1, 1), `torgb.bias`
(1, O, 1, 1).  Modulation uses the input-scaling form
conv(x, w * s) == conv(x * s, w), as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.ops.fused import fused_leaky_relu


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        half = self.dim // 2
        emb = math.log(10000) / (half - 1)
        emb = torch.exp(torch.arange(half, device=x.device, dtype=torch.float32) * -emb)
        emb = x.float()[:, None] * emb[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class EqualLinear(nn.Module):
    """Equalized-LR linear: weight (out, in) ~ N(0, 1), scaled at run time by
    1 / sqrt(in)."""

    def __init__(self, in_dim: int, out_dim: int, bias_init: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = 1 / math.sqrt(in_dim)

    def forward(self, x):
        return x @ (self.weight * self.scale).t().to(x.dtype) + self.bias.to(x.dtype)


class ModulatedConv(nn.Module):
    """Style-modulated (de)modulated 1x1 conv over tokens (b, n, in)."""

    def __init__(self, in_ch: int, out_ch: int, style_dim: int, demodulate: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, out_ch, in_ch, 1, 1))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.scale = 1 / math.sqrt(in_ch)
        self.demodulate = demodulate

    def forward(self, x, style):
        w = self.weight[0, :, :, 0, 0]  # (out, in)
        s = self.modulation(style)  # (b, in)
        out = (x * s[:, None, :]) @ (w * self.scale).t().to(x.dtype)
        if self.demodulate:
            w2 = ((self.scale * w) ** 2).to(s.dtype)
            demod = torch.rsqrt(torch.einsum("bi,oi->bo", s**2, w2) + 1e-8)
            out = out * demod[:, None, :]
        return out


class NoiseInjection(nn.Module):
    """x + w * N(0, 1), one draw per token; w zero at init.  The draw is made
    in fp32 and then cast, as the reference's torch.randn is fp32.

    `generator` is a torch.Generator to draw from, or an iterator that
    yields the draws themselves, (..., n, 1) fp32 each, in the order the
    module tree calls its NoiseInjections (conv1..conv3 of net_res1, then
    of net_res2, ...): a caller that holds another framework's draws feeds
    them this way."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, generator=None):
        shape = x.shape[:-1] + (1,)
        if generator is None or isinstance(generator, torch.Generator):
            noise = torch.randn(shape, generator=generator, device=x.device,
                                dtype=torch.float32)
        else:
            noise = next(generator).to(x.device, torch.float32).expand(shape)
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class FusedLeakyReLU(nn.Module):
    """Learned per-channel bias + LeakyReLU(0.2) * sqrt(2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias.to(x.dtype))


class StyledConv(nn.Module):
    """ModulatedConv + noise + fused bias-LeakyReLU."""

    def __init__(self, in_ch: int, out_ch: int, style_dim: int, demodulate: bool = True):
        super().__init__()
        self.conv = ModulatedConv(in_ch, out_ch, style_dim, demodulate)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)

    def forward(self, x, style, generator=None):
        return self.activate(self.noise(self.conv(x, style), generator))


class ToRGB(nn.Module):
    """1x1 modulated conv (no demodulation) + bias; no upsampled skip."""

    def __init__(self, in_ch: int, out_ch: int, style_dim: int):
        super().__init__()
        self.conv = ModulatedConv(in_ch, out_ch, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, out_ch, 1, 1))

    def forward(self, x, style):
        return self.conv(x, style) + self.bias.reshape(-1).to(x.dtype)


class EqualConv1x1(nn.Module):
    """Equalized-LR 1x1 conv without bias, applied to tokens (b, n, in)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, 1, 1))
        self.scale = 1 / math.sqrt(in_ch)

    def forward(self, x):
        return x @ (self.weight[:, :, 0, 0] * self.scale).t().to(x.dtype)


class ConvLayer(nn.Sequential):
    """The skip ConvLayer of a StyledResBlock: one bias-free equalized 1x1
    conv, no activation (state key `skip.0.weight`)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(EqualConv1x1(in_ch, out_ch))


class StyledResBlock(nn.Module):
    """conv1 -> conv2 -> conv3, each styled; (out + skip) / sqrt(2)."""

    def __init__(self, in_ch: int, out_ch: int, style_dim: int):
        super().__init__()
        self.conv1 = StyledConv(in_ch, out_ch, style_dim)
        self.conv2 = StyledConv(out_ch, out_ch, style_dim)
        self.conv3 = StyledConv(out_ch, out_ch, style_dim)
        self.skip = ConvLayer(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x, style, generator=None):
        out = self.conv1(x, style, generator)
        out = self.conv2(out, style, generator)
        out = self.conv3(out, style, generator)
        skip = self.skip(x) if self.skip is not None else x
        return (out + skip) / math.sqrt(2)


def gelu_tanh(x):
    """GELU in its tanh form, the default of jax.nn.gelu."""
    return F.gelu(x, approximate="tanh")


class ResnetBlockFC(nn.Module):
    """Fully connected residual block (counterpart of
    ddmi_tpu/nn/stylegan.py::ResnetBlockFC; reference blocks.py): fc_1 is
    zero-initialised, and a bias-free `shortcut` maps the input when the
    widths differ."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        nn.init.zeros_(self.fc_1.weight)
        self.shortcut = (
            nn.Linear(size_in, size_out, bias=False) if size_in != size_out else None
        )

    def forward(self, x):
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + dx
