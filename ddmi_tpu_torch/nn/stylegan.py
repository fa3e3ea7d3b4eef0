"""StyleGAN2-style modulated convolutions (counterpart of
ddmi_tpu/nn/stylegan.py).

Channels last throughout, as in JAX: a kernel-size-1 conv without
resampling takes tokens (b, ..., in), which is all the image INR uses; a
k x k conv, the up- and downsampling ones, `EqualConv2d` and a k > 1
`ConvLayer` take NHWC planes (b, h, w, in) and run as `F.conv2d` /
`F.conv_transpose2d` inside.

Parameters carry the reference repo's names and layouts
(models/d2c_vae/blocks.py): `conv.weight` (1, O, I, k, k),
`conv.modulation.weight` (I, style_dim), `noise.weight` (1,),
`activate.bias` (O,), `skip.0.weight` (O, I, 1, 1), `torgb.bias`
(1, O, 1, 1), an EqualConv2d's `weight` (O, I, k, k) and `bias` (O,).
Modulation uses the input-scaling form conv(x, w * s) == conv(x * s, w),
as the JAX package does.  The upsampling conv is JAX's: a stride-2
transposed conv that correlates the zero-stuffed input with the kernel as
stored (torch's `conv_transpose2d` takes the kernel flipped for that), then
the FIR blur at 4x gain; the downsampling one blurs, then convolves at
stride 2.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.ops.fused import fused_leaky_relu, scaled_leaky_relu
from ddmi_tpu_torch.ops.upfirdn import blur, make_fir_kernel, upsample_2d

BLUR_KERNEL = (1, 3, 3, 1)  # the FIR taps of the resampling convs and ToRGB's skip

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
    """Style-modulated (de)modulated conv: forward(x, style (b, style_dim)).
    kernel_size 1 without resampling takes tokens (b, ..., in); otherwise x
    is NHWC (b, h, w, in), and `upsample` doubles or `downsample` halves its
    size with the (1, 3, 3, 1) FIR filter."""

    def __init__(self, in_ch: int, out_ch: int, style_dim: int, demodulate: bool = True,
                 kernel_size: int = 1, upsample: bool = False, downsample: bool = False):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn(1, out_ch, in_ch, k, k))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.scale = 1 / math.sqrt(in_ch * k * k)
        self.demodulate, self.kernel_size = demodulate, k
        self.upsample, self.downsample = upsample, downsample

    def forward(self, x, style):
        k = self.kernel_size
        w = self.weight[0]  # (out, in, k, k)
        s = self.modulation(style)  # (b, in)
        bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (-1,)
        xs = x * s.reshape(bshape)
        if k == 1 and not (self.upsample or self.downsample):
            out = xs @ (w[:, :, 0, 0] * self.scale).t().to(x.dtype)
        else:
            ws = (w * self.scale).to(x.dtype)
            fir = make_fir_kernel(BLUR_KERNEL, device=x.device)
            nb = len(BLUR_KERNEL)
            if self.upsample:
                out = F.conv_transpose2d(xs.permute(0, 3, 1, 2),
                                         torch.flip(ws, (2, 3)).transpose(0, 1), stride=2,
                                         output_padding=max(0, 2 - k))  # JAX's VALID size
                p = (nb - 2) - (k - 1)
                out = blur(out.permute(0, 2, 3, 1), fir * 4, pad=((p + 1) // 2 + 1, p // 2 + 1))
            elif self.downsample:
                p = (nb - 2) + (k - 1)
                xb = blur(xs, fir, pad=((p + 1) // 2, p // 2))
                out = F.conv2d(xb.permute(0, 3, 1, 2), ws, stride=2).permute(0, 2, 3, 1)
            else:
                out = F.conv2d(xs.permute(0, 3, 1, 2), ws, padding=k // 2).permute(0, 2, 3, 1)
        if self.demodulate:
            w2 = ((self.scale * w) ** 2).sum((2, 3)).to(s.dtype)  # (out, in)
            demod = torch.rsqrt(torch.einsum("bi,oi->bo", s**2, w2) + 1e-8)
            out = out * demod.reshape(bshape)
        return out


class EqualConv2d(nn.Module):
    """Equalized-LR conv on NHWC planes: weight (out, in, k, k) ~ N(0, 1),
    scaled at run time by 1 / sqrt(in * k^2); bias (out,) zeros."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.scale = 1 / math.sqrt(in_ch * kernel_size ** 2)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        out = F.conv2d(x.permute(0, 3, 1, 2), (self.weight * self.scale).to(x.dtype),
                       stride=self.stride, padding=self.padding).permute(0, 2, 3, 1)
        return out if self.bias is None else out + self.bias.to(x.dtype)


class NoiseInjection(nn.Module):
    """x + w * N(0, 1), one draw per token; w zero at init.  The draw is made
    in fp32 and then cast, as the reference's torch.randn is fp32.

    `generator` is a torch.Generator to draw from, an object whose
    `draw(shape)` makes the draw (a rank's rows of the global batch's), or
    an iterator that yields the draws themselves, (..., n, 1) fp32 each, in the order the
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
        elif hasattr(generator, "draw"):  # parallel/mesh.py::RowDraws
            noise = generator.draw(shape).to(x.device)
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
    """1x1 modulated conv (no demodulation) + bias; given `skip` (NHWC), the
    skip FIR-upsampled 2x is added."""

    def __init__(self, in_ch: int, out_ch: int, style_dim: int):
        super().__init__()
        self.conv = ModulatedConv(in_ch, out_ch, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, out_ch, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.reshape(-1).to(x.dtype)
        if skip is not None:
            out = out + upsample_2d(skip, make_fir_kernel(BLUR_KERNEL, device=skip.device))
        return out


class EqualConv1x1(nn.Module):
    """Equalized-LR 1x1 conv, applied to tokens or NHWC planes (b, ..., in);
    bias-free unless asked."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.scale = 1 / math.sqrt(in_ch)

    def forward(self, x):
        out = x @ (self.weight[:, :, 0, 0] * self.scale).t().to(x.dtype)
        return out if self.bias is None else out + self.bias.to(x.dtype)


class ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return scaled_leaky_relu(x)


class ConvLayer(nn.Sequential):
    """The reference ConvLayer: an equalized conv (1x1 on tokens or planes,
    k x k with 'same' padding on NHWC planes), then with `activate` a fused
    bias-LeakyReLU (`bias`) or a scaled LeakyReLU.  The defaults are the
    StyledResBlock skip's (1x1, no bias, no activation: state key
    `skip.0.weight`); the JAX module's are kernel_size 1, activate and bias
    on."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, activate: bool = False,
                 bias: bool = False):
        conv_bias = bias and not activate
        if kernel_size == 1:
            conv = EqualConv1x1(in_ch, out_ch, bias=conv_bias)
        else:
            conv = EqualConv2d(in_ch, out_ch, kernel_size, padding=(kernel_size - 1) // 2,
                               bias=conv_bias)
        layers = [conv]
        if activate:
            layers.append(FusedLeakyReLU(out_ch) if bias else ScaledLeakyReLU())
        super().__init__(*layers)


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
