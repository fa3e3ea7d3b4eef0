"""Video D2C-VAE (counterpart of ddmi_tpu/nn/video_vae.py; reference
VITAutoencoder and VideoDecoder_light): the TimeSformer encoder whose
patch tokens are pooled per axis into three plane posteriors, and the
shared-weight triplane decoder with cross-plane 1D attention.

Video enters (b, t, h, w, c).  The xy plane pools the time axis, the plane
named 'yt' pools the h axis and 'xt' the w axis (the reference's labels).
Posteriors come back in the order (xy, yt, xt), NCHW: xy (b, E, r, r), yt
and xt (b, E, t, r).  Latent tokens are [xy | xt | yt]; the decoded
pyramids come out in the order (xy, yt, xt).  Planes are NCHW; the t axis
of the xt and yt planes is never upsampled.  State keys follow the
reference: `encoder.*` (nn/vit.py), `{xy,xt,yt}_token`,
`{xy,xt,yt}_pos_embedding`, `{xy,xt,yt}_quant_attn.*`, `pre_{xy,xt,yt}`
and `post_{xy,xt,yt}` (1x1 Conv2d, applied as linear maps over
channel-last tokens), `decoder.conv_in`,
`decoder.mid.{block_1,attn_1,block_2}`, `decoder.mid_attn`,
`decoder.up.{i}.{block,attn,inter_attn.0,hdbf.0,upsample.conv}`,
`decoder.norm_out`, `decoder.conv_out`.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.attention1d import AttnBlock1DExpand
from ddmi_tpu_torch.nn.distributions import DiagonalGaussian
from ddmi_tpu_torch.nn.unet_triplane import cat_tokens, cross_plane
from ddmi_tpu_torch.nn.vae import Norm, ResnetBlock, _make_attn
from ddmi_tpu_torch.nn.vit import TimeSformerEncoder, Transformer

PLANES = ("xy", "xt", "yt")
XATTN = "decoder.xattn"  # the span of each cross-plane attention (core/tracing.py)
ENCODE_HALF = ("encoder",) + tuple(f"{p}_{part}" for p in PLANES
                                   for part in ("token", "pos_embedding", "quant_attn")) + tuple(
    f"pre_{p}" for p in PLANES)


def is_encode_key(key: str) -> bool:
    """Whether a VideoAutoencoder state key belongs to the encode half."""
    return key.split(".")[0] in ENCODE_HALF


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
        xy, xt, yt = cross_plane(self.mid_attn, (xy, xt, yt), XATTN)

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
                xy, xt, yt = cross_plane(lvl.inter_attn[0], (xy, xt, yt), XATTN)
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


def cat_planes(xy, xt, yt) -> torch.Tensor:
    """NCHW planes -> (b, n, c) tokens [xy | xt | yt]."""
    return cat_tokens((xy, xt, yt))


class VideoAutoencoder(nn.Module):
    """The reference VITAutoencoder: `encode` (TimeSformer, per-axis
    class-token pooling, `pre_*` moments) -> three posteriors; `decode`
    (`post_*` from the embed dim to z_channels per plane, then the triplane
    decoder).  The TimeSformer's depth 8, heads 8 and dim_head 64 and the
    pooling transformers' depth 4, heads 4, dim_head tc / 8 and MLP 512 are
    the module's, not the config's; the patch is 4 at resolution 128.
    Without `with_encoder` the module holds the decode half alone (the
    sampling paths)."""

    def __init__(self, cfg, embed_dim: int = 64, frames: int = 16, with_encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.down_res = r = cfg.resolution // 8
        self.frames = f = frames // cfg.splits
        if with_encoder:
            tc = cfg.timesformer_channels
            self.encoder = TimeSformerEncoder(
                dim=tc, depth=8, patch_size=4 if cfg.resolution == 128 else cfg.patch_size)
            moments = 2 * embed_dim if cfg.double_z else embed_dim
            for plane, n in zip(PLANES, (f, r, r)):
                setattr(self, f"{plane}_token", nn.Parameter(torch.randn(1, 1, tc)))
                setattr(self, f"{plane}_pos_embedding", nn.Parameter(torch.randn(1, n + 1, tc)))
                setattr(self, f"{plane}_quant_attn",
                        Transformer(tc, depth=4, heads=4, dim_head=tc // 8, mlp_dim=512))
                setattr(self, f"pre_{plane}", nn.Conv2d(tc, moments, 1))
        self.decoder = VideoDecoder(cfg)
        self.post_xy = nn.Conv2d(embed_dim, cfg.z_channels, 1)
        self.post_xt = nn.Conv2d(embed_dim, cfg.z_channels, 1)
        self.post_yt = nn.Conv2d(embed_dim, cfg.z_channels, 1)

    @staticmethod
    def _linear(conv: nn.Conv2d, tok: torch.Tensor) -> torch.Tensor:
        return F.linear(tok, conv.weight[:, :, 0, 0], conv.bias)

    def _pool(self, tokens, plane: str) -> torch.Tensor:
        """Append the class token last, add the positions, transform, and
        read position 0 (the reference reads index 0 after attention)."""
        g, n, tc = tokens.shape
        cls = getattr(self, f"{plane}_token").expand(g, 1, tc)
        pos = getattr(self, f"{plane}_pos_embedding")[:, : n + 1]
        return getattr(self, f"{plane}_quant_attn")(torch.cat([tokens, cls], dim=1) + pos)[:, 0]

    def _posterior(self, plane: str, tok: torch.Tensor) -> DiagonalGaussian:
        """(b, h, w, tc) pooled tokens -> the posterior of NCHW moments."""
        moments = self._linear(getattr(self, f"pre_{plane}"), tok)
        return DiagonalGaussian.from_moments(moments.permute(0, 3, 1, 2))

    def encode(self, video: torch.Tensor) -> Tuple[DiagonalGaussian, ...]:
        """video (b, t, h, w, 3) in [-1, 1] -> posteriors (xy, yt, xt)."""
        b, t = video.shape[:2]
        r = self.down_res
        x = self.encoder(video)
        tc = x.shape[-1]
        x = x.reshape(b, t, r, r, tc)
        xy = self._pool(x.permute(0, 2, 3, 1, 4).reshape(b * r * r, t, tc), "xy")
        yt = self._pool(x.transpose(2, 3).reshape(b * t * r, r, tc), "yt")
        xt = self._pool(x.reshape(b * t * r, r, tc), "xt")
        return (self._posterior("xy", xy.reshape(b, r, r, tc)),
                self._posterior("yt", yt.reshape(b, t, r, tc)),
                self._posterior("xt", xt.reshape(b, t, r, tc)))

    def decode(self, z):
        """z (b, n, embed_dim) tokens [xy | xt | yt] -> (hdbf_xy, hdbf_yt,
        hdbf_xt)."""
        r, t, b = self.down_res, self.frames, z.shape[0]

        def post(conv, tok, h, w):
            return self._linear(conv, tok).reshape(b, h, w, -1).permute(0, 3, 1, 2)

        xy = post(self.post_xy, z[:, : r * r], r, r)
        xt = post(self.post_xt, z[:, r * r : r * (r + t)], t, r)
        yt = post(self.post_yt, z[:, r * (r + t) :], t, r)
        return self.decoder((xy, yt, xt))

    def forward(self, video, eps: List[torch.Tensor], sample_posterior: bool = True):
        """encode -> sample (xy, yt, xt) with the standard-normal fp32 `eps`
        of the posteriors' shapes (the modes when not sample_posterior) ->
        [xy | xt | yt] tokens -> decode.  -> (pyramids, posteriors)."""
        posts = self.encode(video)
        if sample_posterior:
            xy, yt, xt = (p.sample(e) for p, e in zip(posts, eps))
        else:
            xy, yt, xt = (p.mode() for p in posts)
        return self.decode(cat_planes(xy, xt, yt)), posts

    def jax_layout(self) -> List[Tuple[str, Tuple[str, ...], str]]:
        """[(port module key, JAX parameter path, kind)] for every 4-D
        convolution ("conv") and GroupNorm ("gn") of the JAX VideoAutoencoder,
        the spectral-norm regulariser's view (core/sn_reg.py).  The
        TimeSformer's, the pooling transformers', the 1D attentions' q, k, v,
        proj_out and the pre_* / post_* layers are Dense in JAX (2-D
        kernels), so only their GroupNorms enter.  With `attn_type: linear`
        the decoder's attentions are LinAttnBlock_{n} (a bias-free `to_qkv`
        and `to_out`, no norm)."""
        cfg = self.cfg
        out: List[Tuple[str, Tuple[str, ...], str]] = []
        dec = ("decoder",)
        linear = cfg.attn_type == "linear"
        attn_name = "LinAttnBlock" if linear else "AttnBlock"

        def resnet(key, path, blk):
            out.extend([(key + ".norm1", path + ("Norm_0", "GroupNorm_0"), "gn"),
                        (key + ".conv1", path + ("Conv_0",), "conv"),
                        (key + ".norm2", path + ("Norm_1", "GroupNorm_0"), "gn"),
                        (key + ".conv2", path + ("Conv_1",), "conv")])
            if blk.nin_shortcut is not None:
                out.append((key + ".nin_shortcut", path + ("nin_shortcut",), "conv"))

        def attn(key, path):
            if linear:
                out.extend([(key + ".to_qkv", path + ("to_qkv",), "conv_nobias"),
                            (key + ".to_out", path + ("to_out",), "conv")])
                return
            out.append((key + ".norm", path + ("Norm_0", "GroupNorm_0"), "gn"))
            out.extend((f"{key}.{n}", path + (n,), "conv") for n in ("q", "k", "v", "proj_out"))

        def attn1d(key, path):
            out.append((key + ".norm", path + ("GroupNormTokens_0", "GroupNorm_0"), "gn"))

        d = self.decoder
        out.append(("decoder.conv_in", dec + ("conv_in",), "conv"))
        resnet("decoder.mid.block_1", dec + ("mid_block1",), d.mid.block_1)
        ab = 0
        if d.mid.attn_1 is not None:
            attn("decoder.mid.attn_1", dec + (f"{attn_name}_0",))
            ab = 1
        resnet("decoder.mid.block_2", dec + ("mid_block2",), d.mid.block_2)
        attn1d("decoder.mid_attn", dec + ("mid_inter_attn",))
        curr = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
        for i in reversed(range(len(d.up))):
            lvl = d.up[i]
            for j, blk in enumerate(lvl.block):
                resnet(f"decoder.up.{i}.block.{j}", dec + (f"up_{i}_{j}",), blk)
                if len(lvl.attn):
                    attn(f"decoder.up.{i}.attn.{j}", dec + (f"{attn_name}_{ab}",))
                    ab += 1
            if lvl.inter_attn is not None:
                attn1d(f"decoder.up.{i}.inter_attn.0", dec + (f"inter_attn_{i}",))
            if lvl.hdbf is not None:
                out.append((f"decoder.up.{i}.hdbf.0", dec + (f"hdbf_{curr}",), "conv"))
            if lvl.upsample is not None:
                out.append((f"decoder.up.{i}.upsample.conv", dec + (f"upsample_{i}", "Conv_0"),
                            "conv"))
                curr *= 2
        out.append(("decoder.norm_out", dec + ("norm_out", "GroupNorm_0"), "gn"))
        out.append(("decoder.conv_out", dec + ("conv_out",), "conv"))
        return out
