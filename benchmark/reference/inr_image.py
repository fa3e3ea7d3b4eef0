"""The image INR (DDMI's scale-aware MLP of StyleGAN2-style modulated
convolutions over tokens): each pixel's token is the HDBF planes sampled
bilinearly at its centre (align_corners=False, border), with the scale
injection si = anchor / resolution appended; a sinusoidal style MLP of si
modulates and demodulates every 1x1 conv; NoiseInjection adds one seeded
draw per token (reference/philox.py) before each fused bias-LeakyReLU(0.2)
x sqrt(2).  State keys are the reference checkpoints' (`time_mlp.{1,3}`,
`net_res{1..4}.conv{1,2,3}.{conv.weight, conv.modulation.*, noise.weight,
activate.bias}`, `net_res{1..3}.skip.0.weight`, `torgb.*`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import philox
from benchmark.reference.numerics import FP32, Numerics


class EqualLinear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))


class ModConv(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, cout, cin, 1, 1))
        self.modulation = EqualLinear(style_dim, cin)

    def forward(self, x, style, nx: Numerics, demodulate: bool = True):
        cin = self.weight.shape[2]
        mod = self.modulation
        s = nx.linear(style, mod.weight.float() / math.sqrt(mod.weight.shape[1]), mod.bias)
        w = self.weight[0, :, :, 0, 0].float() / math.sqrt(cin)                 # (out, in)
        out = nx.linear(x * s[:, None, :], w)
        if demodulate:
            out = out * torch.rsqrt(s ** 2 @ (w ** 2).t() + 1e-8)[:, None, :]
        return out


class Noise(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))


class Act(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(c))


class StyledConv(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int):
        super().__init__()
        self.conv = ModConv(cin, cout, style_dim)
        self.noise = Noise()
        self.activate = Act(cout)

    def forward(self, x, style, draw, nx: Numerics):
        h = self.conv(x, style, nx) + self.noise.weight.float() * draw[..., None]
        return F.leaky_relu(h + self.activate.bias.float(), 0.2) * math.sqrt(2.0)


class Skip(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))


class StyledResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int):
        super().__init__()
        self.conv1 = StyledConv(cin, cout, style_dim)
        self.conv2 = StyledConv(cout, cout, style_dim)
        self.conv3 = StyledConv(cout, cout, style_dim)
        self.skip = nn.Sequential(Skip(cin, cout)) if cin != cout else None

    def forward(self, x, style, draws, nx: Numerics):
        h = self.conv1(x, style, draws[..., 0], nx)
        h = self.conv2(h, style, draws[..., 1], nx)
        h = self.conv3(h, style, draws[..., 2], nx)
        if self.skip is not None:
            w = self.skip[0].weight[:, :, 0, 0].float()
            x = nx.linear(x, w / math.sqrt(w.shape[1]))
        return (h + x) / math.sqrt(2.0)


class ToRGB(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int):
        super().__init__()
        self.conv = ModConv(cin, cout, style_dim)
        self.bias = nn.Parameter(torch.empty(1, cout, 1, 1))

    def forward(self, x, style, nx: Numerics):
        return self.conv(x, style, nx, demodulate=False) + self.bias.float().reshape(-1)


class INRImage(nn.Module):
    """`m` is an mlpconfig dict: in_ch, out_ch, ch, latent_dim."""

    N_CONV = 12

    def __init__(self, m: dict):
        super().__init__()
        ch, in0 = m["ch"], m["latent_dim"] + m["in_ch"]
        self.in_ch, self.ch = m["in_ch"], ch
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(ch // 4, ch), nn.Identity(),
                                      nn.Linear(ch, ch))
        self.net_res1 = StyledResBlock(in0, ch, ch)
        self.net_res2 = StyledResBlock(ch + in0, ch, ch)
        self.net_res3 = StyledResBlock(ch + in0, ch, ch)
        self.net_res4 = StyledResBlock(ch, ch, ch)
        self.torgb = ToRGB(ch, m["out_ch"], ch)

    def style(self, si: float, nx: Numerics, device) -> torch.Tensor:
        half = self.ch // 8
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                          * -(math.log(10000) / (half - 1)))
        e = si * freqs
        e = torch.cat([e.sin(), e.cos()])[None]
        l1, l2 = self.time_mlp[1], self.time_mlp[3]
        return nx.linear(F.gelu(nx.linear(e, l1.weight, l1.bias), approximate="tanh"),
                         l2.weight, l2.bias)

    def forward(self, hdbf, res: int, si: float, seed: int, position: int,
                nx: Numerics = FP32) -> torch.Tensor:
        """hdbf: three planes (1, latent, h, w) of one sample, coarse to fine;
        -> (res * res, out_ch), the tokens of a res x res render, row-major;
        its noise is that of sample `position` in a batch keyed by `seed`."""
        dev = hdbf[0].device
        e = (res - 1) / res
        lin = torch.linspace(-e, e, res, device=dev)
        grid = torch.stack(torch.meshgrid(lin, lin, indexing="ij")[::-1], -1)[None]
        n = res * res

        def tokens(plane):
            t = F.grid_sample(plane.float(), grid, mode="bilinear", padding_mode="border",
                              align_corners=False)
            t = t[0].reshape(t.shape[1], n).t()
            return torch.cat([t, torch.full((n, self.in_ch), float(si), device=dev)], -1)

        draws = philox.noise(seed, position * n, n, self.N_CONV, device=dev).reshape(n, 4, 3)
        style = self.style(si, nx, dev)
        x0, xm, xh = (tokens(p) for p in hdbf)
        h = self.net_res1(x0[None], style, draws[:, 0], nx)
        h = self.net_res2(torch.cat([h, xm[None]], -1), style, draws[:, 1], nx)
        h = self.net_res3(torch.cat([h, xh[None]], -1), style, draws[:, 2], nx)
        h = self.net_res4(h, style, draws[:, 3], nx)
        return self.torgb(h, style, nx)[0]
