"""The ADM UNet denoiser (guided-diffusion's `UNetModel`, as configured by
DDMI's `configs/ldm/*.yaml`): timestep-embedded residual blocks, multi-head
self-attention over the flattened feature map with head-major qkv channels
(`QKVAttentionLegacy`), strided-conv downsampling and nearest-neighbour
upsampling, skip connections from the down path to the up path.  Float32;
the products go through a `Numerics`.  The state keys are the reference
checkpoints' (`time_embed.{0,2}`, `input_blocks.*`, `middle_block.*`,
`output_blocks.*`, `out.{0,2}`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.numerics import FP32, Numerics


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(), gn.eps)


class ResBlock(nn.Module):
    def __init__(self, channels: int, emb_channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
                                       nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out_channels, eps=1e-5), nn.SiLU(),
                                        nn.Identity(),
                                        nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else nn.Conv2d(channels, out_channels, 1))

    def forward(self, x, emb, nx: Numerics):
        conv_in, conv_out = self.in_layers[2], self.out_layers[3]
        h = nx.conv2d(F.silu(group_norm(self.in_layers[0], x)), conv_in.weight, conv_in.bias,
                      padding=1)
        lin = self.emb_layers[1]
        h = h + nx.linear(F.silu(emb), lin.weight, lin.bias)[:, :, None, None]
        h = nx.conv2d(F.silu(group_norm(self.out_layers[0], h)), conv_out.weight,
                      conv_out.bias, padding=1)
        skip = self.skip_connection
        if isinstance(skip, nn.Conv2d):
            x = nx.conv2d(x, skip.weight, skip.bias)
        return x + h


class AttentionBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(32, channels, eps=1e-5)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, emb, nx: Numerics):
        B, C, H, W = x.shape
        nh, n = self.num_heads, H * W
        hd = C // nh
        h = group_norm(self.norm, x).reshape(B, C, n).transpose(1, 2)          # (B, n, C)
        qkv = nx.linear(h, self.qkv.weight[:, :, 0], self.qkv.bias)            # (B, n, 3C)
        qkv = qkv.transpose(1, 2).reshape(B, nh, 3, hd, n)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]                     # (B, nh, hd, n)
        s = nx.matmul(q.transpose(-1, -2), k) * hd ** -0.5                     # (B, nh, n, n)
        p = torch.softmax(s, dim=-1)
        a = nx.matmul(p, v.transpose(-1, -2))                                   # (B, nh, n, hd)
        a = a.transpose(-1, -2).reshape(B, C, n).transpose(1, 2)                # (B, n, C)
        out = nx.linear(a, self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x, emb, nx: Numerics):
        return nx.conv2d(x, self.op.weight, self.op.bias, stride=2, padding=1)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, emb, nx: Numerics):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return nx.conv2d(x, self.conv.weight, self.conv.bias, padding=1)


class StemConv(nn.Conv2d):
    """The first input block's 3x3 conv."""

    def forward(self, x, emb, nx: Numerics):
        return nx.conv2d(x, self.weight, self.bias, padding=1)


class Blocks(nn.Sequential):
    def forward(self, x, emb, nx: Numerics):
        for layer in self:
            x = layer(x, emb, nx)
        return x


class UNet(nn.Module):
    """x (b, in_channels, h, w), t (b,) -> (b, out_channels, h, w) float32.
    `u` is a unetconfig dict: model_channels, in_channels, out_channels,
    num_res_blocks, attention_resolutions, channel_mult, num_head_channels."""

    def __init__(self, u: dict):
        super().__init__()
        mc = u["model_channels"]
        ted = 4 * mc
        self.mc = mc
        heads = lambda ch: max(1, ch // u["num_head_channels"])
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        self.input_blocks = nn.ModuleList(
            [Blocks(StemConv(u["in_channels"], mc, 3, padding=1))])
        chans, ch, ds = [mc], mc, 1
        mults = u["channel_mult"]
        for level, mult in enumerate(mults):
            for _ in range(u["num_res_blocks"]):
                layers = [ResBlock(ch, ted, mult * mc)]
                ch = mult * mc
                if ds in u["attention_resolutions"]:
                    layers.append(AttentionBlock(ch, heads(ch)))
                self.input_blocks.append(Blocks(*layers))
                chans.append(ch)
            if level != len(mults) - 1:
                self.input_blocks.append(Blocks(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = Blocks(ResBlock(ch, ted, ch), AttentionBlock(ch, heads(ch)),
                                   ResBlock(ch, ted, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(mults))):
            for i in range(u["num_res_blocks"] + 1):
                layers = [ResBlock(ch + chans.pop(), ted, mult * mc)]
                ch = mult * mc
                if ds in u["attention_resolutions"]:
                    layers.append(AttentionBlock(ch, heads(ch)))
                if level and i == u["num_res_blocks"]:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Blocks(*layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
                                 nn.Conv2d(ch, u["out_channels"], 3, padding=1))

    def forward(self, x, t, nx: Numerics = FP32):
        l1, l2 = self.time_embed[0], self.time_embed[2]
        emb = nx.linear(F.silu(nx.linear(timestep_embedding(t, self.mc), l1.weight, l1.bias)),
                        l2.weight, l2.bias)
        h, hs = x.float(), []
        for block in self.input_blocks:
            h = block(h, emb, nx)
            hs.append(h)
        h = self.middle_block(h, emb, nx)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, nx)
        conv = self.out[2]
        return nx.conv2d(F.silu(group_norm(self.out[0], h)), conv.weight, conv.bias, padding=1)
