"""Video D2C-VAE, decode half (counterpart of ddmi_tpu/nn/video_vae.py):
the shared-weight triplane decoder with cross-plane 1D attention
(reference VideoDecoder_light) and the VITAutoencoder's `post_*` layers.

Latent tokens are [xy | xt | yt]; the decoded pyramids come out in the order
(xy, yt, xt), as in the JAX package.  Planes are NCHW; the t axis of the xt
and yt planes is never upsampled.  State keys follow the reference:
`decoder.conv_in`, `decoder.mid.{block_1,attn_1,block_2}`, `decoder.mid_attn`,
`decoder.up.{i}.{block,attn,inter_attn.0,hdbf.0,upsample.conv}`,
`decoder.norm_out`, `decoder.conv_out`, and `post_{xy,xt,yt}` (1x1 Conv2d).
The TimeSformer encoder waits for the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.attention1d import AttnBlock1DExpand
from ddmi_tpu_torch.nn.unet_triplane import cross_plane
from ddmi_tpu_torch.nn.vae import Norm, ResnetBlock, _make_attn


class SharedUpsample(nn.Module):
    """Nearest upsample by per-axis factors, then one 3x3 conv shared by all
    three planes."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, scale: Tuple[int, int] = (2, 2)):
        return self.conv(F.interpolate(x, scale_factor=scale, mode="nearest"))


def _tmap(fn, yt, xt):
    """A shared-weight module on the two time planes, stacked on the batch
    axis into one call."""
    out = fn(torch.cat([yt, xt], dim=0))
    b = yt.shape[0]
    return out[:b], out[b:]


class VideoDecoder(nn.Module):
    """(xy, yt, xt) NCHW latent planes -> three HDBF pyramids (xy, yt, xt),
    each coarse to fine."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.ch_mult)
        curr = cfg.resolution // 2 ** (n - 1)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = _make_attn(block_in, cfg.attn_type)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        self.mid_attn = AttnBlock1DExpand(block_in)
        levels = {}
        for i in reversed(range(n)):
            lvl = nn.Module()
            block_out = cfg.ch * cfg.ch_mult[i]
            lvl.block = nn.ModuleList()
            lvl.attn = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                lvl.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr in cfg.attn_resolutions:
                    lvl.attn.append(_make_attn(block_in, cfg.attn_type))
            lvl.inter_attn = (
                nn.ModuleList([AttnBlock1DExpand(block_in)])
                if curr in cfg.inter_attn_resolutions else None
            )
            lvl.hdbf = (
                nn.Sequential(nn.Conv2d(block_in, cfg.out_ch, 1))
                if curr in cfg.hdbf_resolutions else None
            )
            lvl.upsample = SharedUpsample(block_in) if i != 0 else None
            if i != 0:
                curr *= 2
            levels[i] = lvl
        self.up = nn.ModuleList([levels[i] for i in range(n)])
        self.norm_out = Norm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, planes):
        xy, yt, xt = planes
        xy = self.conv_in(xy)
        yt, xt = _tmap(self.conv_in, yt, xt)

        def mid(h):
            h = self.mid.block_1(h)
            if self.mid.attn_1 is not None:
                h = self.mid.attn_1(h)
            return self.mid.block_2(h)

        xy = mid(xy)
        yt, xt = _tmap(mid, yt, xt)
        xy, xt, yt = cross_plane(self.mid_attn, (xy, xt, yt))

        hdbf_xy, hdbf_yt, hdbf_xt = [], [], []
        for i in reversed(range(len(self.up))):
            lvl = self.up[i]
            for j, blk in enumerate(lvl.block):
                xy = blk(xy)
                yt, xt = _tmap(blk, yt, xt)
                if len(lvl.attn):
                    xy = lvl.attn[j](xy)
                    yt, xt = _tmap(lvl.attn[j], yt, xt)
            if lvl.inter_attn is not None:
                xy, xt, yt = cross_plane(lvl.inter_attn[0], (xy, xt, yt))
            if lvl.hdbf is not None:
                hdbf_xy.append(lvl.hdbf(xy))
                t_yt, t_xt = _tmap(lvl.hdbf, yt, xt)
                hdbf_yt.append(t_yt)
                hdbf_xt.append(t_xt)
            if lvl.upsample is not None:
                xy = lvl.upsample(xy, (2, 2))
                yt, xt = _tmap(lambda p: lvl.upsample(p, (1, 2)), yt, xt)

        def head(h):
            return self.conv_out(F.silu(self.norm_out(h)))

        hdbf_xy.append(head(xy))
        t_yt, t_xt = _tmap(head, yt, xt)
        hdbf_yt.append(t_yt)
        hdbf_xt.append(t_xt)
        return hdbf_xy, hdbf_yt, hdbf_xt


class VideoAutoencoder(nn.Module):
    """The decode half of the reference VITAutoencoder: `post_*` 1x1 convs
    from the embed dim to z_channels per plane, then the triplane decoder."""

    def __init__(self, cfg, embed_dim: int = 64, frames: int = 16):
        super().__init__()
        self.down_res = cfg.resolution // 8
        self.frames = frames // cfg.splits
        self.decoder = VideoDecoder(cfg)
        self.post_xy = nn.Conv2d(embed_dim, cfg.z_channels, 1)
        self.post_xt = nn.Conv2d(embed_dim, cfg.z_channels, 1)
        self.post_yt = nn.Conv2d(embed_dim, cfg.z_channels, 1)

    def decode(self, z):
        """z (b, n, embed_dim) tokens [xy | xt | yt] -> (hdbf_xy, hdbf_yt,
        hdbf_xt)."""
        r, t, b = self.down_res, self.frames, z.shape[0]

        def post(conv, tok, h, w):
            out = F.linear(tok, conv.weight[:, :, 0, 0], conv.bias)
            return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)

        xy = post(self.post_xy, z[:, : r * r], r, r)
        xt = post(self.post_xt, z[:, r * r : r * (r + t)], t, r)
        yt = post(self.post_yt, z[:, r * (r + t) :], t, r)
        return self.decoder((xy, yt, xt))
