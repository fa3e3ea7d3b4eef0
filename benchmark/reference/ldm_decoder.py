"""The latent decoders: the D2C-VAE image decoder, which emits the HDBF
plane pyramid (`Autoencoder.decode`), and the triplane decoder of the NeRF
configs, whose three planes share every weight and mix through a channel
concat at `inter_attn_resolutions` and at the bottleneck.  Float32; the
products go through a `Numerics`.  State keys are the reference
checkpoints' (`post_quant_conv`, `decoder.*`; `post_quant_conv_{xy,yz,xz}`
for the triplane)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.adm_unet import group_norm
from benchmark.reference.numerics import FP32, Numerics


def Norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


def conv(nx: Numerics, layer: nn.Conv2d, x, **kw):
    return nx.conv2d(x, layer.weight, layer.bias, **kw)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = Norm(cin), nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = Norm(cout), nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, nx: Numerics):
        h = conv(nx, self.conv1, F.silu(group_norm(self.norm1, x)), padding=1)
        h = conv(nx, self.conv2, F.silu(group_norm(self.norm2, h)), padding=1)
        if self.nin_shortcut is not None:
            x = conv(nx, self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1 q, k, v and proj convs."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = Norm(c)
        self.q, self.k, self.v = (nn.Conv2d(c, c, 1) for _ in range(3))
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, nx: Numerics):
        B, C, H, W = x.shape
        h = group_norm(self.norm, x)
        q, k, v = (conv(nx, m, h).reshape(B, C, H * W) for m in (self.q, self.k, self.v))
        p = torch.softmax(nx.matmul(q.transpose(1, 2), k) * C ** -0.5, dim=-1)   # (B, n, n)
        out = nx.matmul(p, v.transpose(1, 2)).transpose(1, 2).reshape(B, C, H, W)
        return x + conv(nx, self.proj_out, out)


def upsample(nx: Numerics, layer: nn.Conv2d, x):
    return conv(nx, layer, F.interpolate(x, scale_factor=2, mode="nearest"), padding=1)


class _Up(nn.Module):
    def __init__(self, conv_layer):
        super().__init__()
        self.conv = conv_layer


def _levels(dd: dict, inter: bool):
    """The decoder's levels, coarse to fine in build order, as modules."""
    n = len(dd["ch_mult"])
    curr = dd["resolution"] // 2 ** (n - 1)
    block_in = dd["ch"] * dd["ch_mult"][-1]
    levels = {}
    for i in reversed(range(n)):
        lvl = nn.Module()
        block_out = dd["ch"] * dd["ch_mult"][i]
        lvl.block = nn.ModuleList()
        lvl.attn = nn.ModuleList()
        for _ in range(dd["num_res_blocks"] + 1):
            lvl.block.append(ResnetBlock(block_in, block_out))
            block_in = block_out
            if curr in dd["attn_resolutions"]:
                lvl.attn.append(AttnBlock(block_in))
        if inter:
            c3 = 3 * block_in
            lvl.inter_attn = (nn.ModuleList([ResnetBlock(c3, c3), AttnBlock(c3),
                                             ResnetBlock(c3, c3)])
                              if curr in dd["inter_attn_resolutions"] else None)
        lvl.hdbf = (nn.Sequential(nn.Conv2d(block_in, dd["out_ch"], 1))
                    if curr in dd["hdbf_resolutions"] else None)
        lvl.upsample = _Up(nn.Conv2d(block_in, block_in, 3, padding=1)) if i != 0 else None
        if i != 0:
            curr *= 2
        levels[i] = lvl
    return [levels[i] for i in range(n)], block_in


def _run_level(lvl, h, nx, taps):
    for j, blk in enumerate(lvl.block):
        h = blk(h, nx)
        if len(lvl.attn):
            h = lvl.attn[j](h, nx)
    if getattr(lvl, "inter_attn", None) is not None:
        h = inter_plane(h, *lvl.inter_attn, nx=nx)
    if lvl.hdbf is not None:
        taps.append(conv(nx, lvl.hdbf[0], h))
    if lvl.upsample is not None:
        h = upsample(nx, lvl.upsample.conv, h)
    return h


def inter_plane(h, block_a, attn, block_b, nx: Numerics):
    """Planes stacked plane-major on the batch axis (3b, c, H, W) mixed
    through a channel concat (b, 3c, H, W), then split back."""
    x = torch.cat(h.chunk(3, dim=0), dim=1)
    x = block_b(attn(block_a(x, nx), nx), nx)
    return torch.cat(x.chunk(3, dim=1), dim=0)


class ImageDecoder(nn.Module):
    """z (b, embed_dim, r, r) -> the HDBF pyramid, coarse to fine: a 1x1 tap
    at each of `hdbf_resolutions` and the final 3x3 output conv.  `dd` is a
    ddconfig dict."""

    def __init__(self, dd: dict, embed_dim: int):
        super().__init__()
        self.post_quant_conv = nn.Conv2d(embed_dim, dd["z_channels"], 1)
        dec = nn.Module()
        block_in = dd["ch"] * dd["ch_mult"][-1]
        dec.conv_in = nn.Conv2d(dd["z_channels"], block_in, 3, padding=1)
        dec.mid = nn.Module()
        dec.mid.block_1 = ResnetBlock(block_in, block_in)
        dec.mid.attn_1 = AttnBlock(block_in)
        dec.mid.block_2 = ResnetBlock(block_in, block_in)
        up, block_in = _levels(dd, inter=False)
        dec.up = nn.ModuleList(up)
        dec.norm_out = Norm(block_in)
        dec.conv_out = nn.Conv2d(block_in, dd["out_ch"], 3, padding=1)
        self.decoder = dec

    def forward(self, z, nx: Numerics = FP32):
        d = self.decoder
        h = conv(nx, d.conv_in, conv(nx, self.post_quant_conv, z.float()), padding=1)
        h = d.mid.block_2(d.mid.attn_1(d.mid.block_1(h, nx), nx), nx)
        taps = []
        for i in reversed(range(len(d.up))):
            h = _run_level(d.up[i], h, nx, taps)
        taps.append(conv(nx, d.conv_out, F.silu(group_norm(d.norm_out, h)), padding=1))
        return taps


class TriplaneDecoder(nn.Module):
    """z (b, 3 * embed_dim, r, r), channels [xy | xz | yz] -> the finest
    plane of each decoded pyramid, {"xy", "yz", "xz"} (b, out_ch, R, R)."""

    def __init__(self, dd: dict, embed_dim: int):
        super().__init__()
        self.embed_dim = embed_dim
        for plane in ("xy", "yz", "xz"):
            setattr(self, f"post_quant_conv_{plane}", nn.Conv2d(embed_dim, dd["z_channels"], 1))
        dec = nn.Module()
        block_in = dd["ch"] * dd["ch_mult"][-1]
        dec.conv_in = nn.Conv2d(dd["z_channels"], block_in, 3, padding=1)
        dec.mid = nn.Module()
        dec.mid.block_1 = ResnetBlock(block_in, block_in)
        dec.mid.attn_1 = AttnBlock(block_in)
        dec.mid.block_2 = ResnetBlock(block_in, block_in)
        dec.mid.block_3 = ResnetBlock(3 * block_in, 3 * block_in)
        dec.mid.block_4 = ResnetBlock(3 * block_in, 3 * block_in)
        dec.mid_attn = AttnBlock(3 * block_in)
        up, block_in = _levels(dd, inter=True)
        dec.up = nn.ModuleList(up)
        dec.norm_out = Norm(block_in)
        dec.conv_out = nn.Conv2d(block_in, dd["out_ch"], 3, padding=1)
        self.decoder = dec

    def forward(self, z, nx: Numerics = FP32):
        e, d, z = self.embed_dim, self.decoder, z.float()
        b = z.shape[0]
        xy = conv(nx, self.post_quant_conv_xy, z[:, :e])
        xz = conv(nx, self.post_quant_conv_xz, z[:, e : 2 * e])
        yz = conv(nx, self.post_quant_conv_yz, z[:, 2 * e :])
        h = conv(nx, d.conv_in, torch.cat([xy, yz, xz], dim=0), padding=1)
        h = d.mid.block_2(d.mid.attn_1(d.mid.block_1(h, nx), nx), nx)
        h = inter_plane(h, d.mid.block_3, d.mid_attn, d.mid.block_4, nx=nx)
        taps = []
        for i in reversed(range(len(d.up))):
            h = _run_level(d.up[i], h, nx, taps)
        out = conv(nx, d.conv_out, F.silu(group_norm(d.norm_out, h)), padding=1)
        return {k: out[i * b : (i + 1) * b] for i, k in enumerate(("xy", "yz", "xz"))}
