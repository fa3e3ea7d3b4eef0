"""Triplane VAE for occupancy and NeRF (counterpart of
ddmi_tpu/nn/triplane_vae.py: `InterPlaneBlock`, `TriplaneEncoder`,
`TriplaneDecoder`, `TriplaneAutoencoder.encode` and `.decode`).

The three planes (xy, yz, xz) share every weight, so they run stacked on the
batch axis, (3b, C, H, W), plane-major.  At `inter_attn_resolutions` and at
the bottleneck the planes mix through a channel concat: ResnetBlock(3c),
spatial attention over 3c channels, ResnetBlock(3c), split back.  The
attention is the dense `AttnBlock` of nn/vae.py, as in the JAX package, which
runs it as an einsum and not as a kernel (at 64^2 it is n = 4096, hd 192).

State keys follow the reference Encoder_triplane, Decoder_triplane and
Autoencoder3D: `encoder.conv_in`, `encoder.down.{i}.{block,attn,
inter_attn.{0,1,2},downsample.conv}`, `encoder.mid.{block_1,attn_1,block_2,
block_3,block_4}`, `encoder.mid_attn`, `encoder.norm_out`,
`encoder.conv_out`; `decoder.conv_in`,
`decoder.mid.{block_1,attn_1,block_2,block_3,block_4}`, `decoder.mid_attn`
(the bottleneck mix's attention sits at the top level, between mid.block_3
and mid.block_4), `decoder.up.{i}.{block,attn,inter_attn.{0,1,2},hdbf.0,
upsample.conv}`, `decoder.norm_out`, `decoder.conv_out`; and the 1x1 convs
`quant_conv_{xy,yz,xz}` and `post_quant_conv_{xy,yz,xz}` (Dense layers in
the JAX package).  `jax_layout` names the JAX package's parameter path of
every convolution, Dense and GroupNorm, which the weight bridge and the
spectral-norm regulariser (core/sn_reg.py) read.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.distributions import DiagonalGaussian
from ddmi_tpu_torch.nn.vae import Downsample, Norm, ResnetBlock, Upsample, _make_attn


def inter_plane(h: torch.Tensor, block_a, attn, block_b) -> torch.Tensor:
    """Channel-concat plane mixing of plane-major stacked planes (3b, c, H,
    W): ResnetBlock(3c) -> attention(3c) -> ResnetBlock(3c) -> split."""
    x = torch.cat(h.chunk(3, dim=0), dim=1)
    x = block_a(x)
    if attn is not None:
        x = attn(x)
    x = block_b(x)
    return torch.cat(x.chunk(3, dim=1), dim=0)


def _inter_triple(c: int, attn_type: str) -> nn.ModuleList:
    """[ResnetBlock(3c), attention(3c) or Identity, ResnetBlock(3c)]."""
    c3 = 3 * c
    return nn.ModuleList([ResnetBlock(c3, c3), _make_attn(c3, attn_type) or nn.Identity(),
                          ResnetBlock(c3, c3)])


def _mid(cfg, block_in: int) -> nn.Module:
    """The bottleneck: block_1, attn_1, block_2 per plane, then block_3 and
    block_4 of the channel-concat mix (its attention is the owner's
    `mid_attn`)."""
    mid = nn.Module()
    mid.block_1 = ResnetBlock(block_in, block_in)
    mid.attn_1 = _make_attn(block_in, cfg.attn_type)
    mid.block_2 = ResnetBlock(block_in, block_in)
    mid.block_3 = ResnetBlock(3 * block_in, 3 * block_in)
    mid.block_4 = ResnetBlock(3 * block_in, 3 * block_in)
    return mid


def _run_mid(owner, h: torch.Tensor) -> torch.Tensor:
    h = owner.mid.block_1(h)
    if owner.mid.attn_1 is not None:
        h = owner.mid.attn_1(h)
    h = owner.mid.block_2(h)
    return inter_plane(h, owner.mid.block_3, owner.mid_attn, owner.mid.block_4)


class TriplaneEncoder(nn.Module):
    """(xy, yz, xz) NCHW feature planes -> three NCHW moment planes (2 *
    z_channels each), the planes stacked on the batch axis through shared
    weights and mixed at `inter_attn_resolutions` and at the bottleneck."""

    def __init__(self, cfg):
        super().__init__()
        if not cfg.double_z:
            raise NotImplementedError("the triplane encoder needs double_z")
        self.cfg = cfg
        curr = cfg.resolution
        n = len(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        block_in = cfg.ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            lvl = nn.Module()
            block_out = cfg.ch * mult
            lvl.block = nn.ModuleList()
            lvl.attn = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                lvl.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr in cfg.attn_resolutions:
                    lvl.attn.append(_make_attn(block_in, cfg.attn_type))
            lvl.inter_attn = (_inter_triple(block_in, cfg.attn_type)
                              if curr in cfg.inter_attn_resolutions else None)
            lvl.downsample = Downsample(block_in) if i != n - 1 else None
            if i != n - 1:
                curr //= 2
            self.down.append(lvl)
        self.mid = _mid(cfg, block_in)
        self.mid_attn = _make_attn(3 * block_in, cfg.attn_type)
        self.norm_out = Norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels, 3, padding=1)

    def forward(self, planes):
        b = planes[0].shape[0]
        h = self.conv_in(torch.cat(list(planes), dim=0))
        for lvl in self.down:
            for j, blk in enumerate(lvl.block):
                h = blk(h)
                if len(lvl.attn):
                    h = lvl.attn[j](h)
            if lvl.inter_attn is not None:
                h = inter_plane(h, *lvl.inter_attn)
            if lvl.downsample is not None:
                h = lvl.downsample(h)
        h = _run_mid(self, h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return tuple(h[k * b : (k + 1) * b] for k in range(3))


class TriplaneDecoder(nn.Module):
    """(xy, yz, xz) NCHW latent planes -> three HDBF pyramids (xy, yz, xz),
    each coarse to fine (one level when hdbf_resolutions is empty)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.ch_mult)
        curr = cfg.resolution // 2 ** (n - 1)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _mid(cfg, block_in)
        self.mid_attn = _make_attn(3 * block_in, cfg.attn_type)
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
            lvl.inter_attn = (_inter_triple(block_in, cfg.attn_type)
                              if curr in cfg.inter_attn_resolutions else None)
            lvl.hdbf = (
                nn.Sequential(nn.Conv2d(block_in, cfg.out_ch, 1))
                if curr in cfg.hdbf_resolutions else None
            )
            lvl.upsample = Upsample(block_in) if i != 0 else None
            if i != 0:
                curr *= 2
            levels[i] = lvl
        self.up = nn.ModuleList([levels[i] for i in range(n)])
        self.norm_out = Norm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, planes):
        b = planes[0].shape[0]
        h = _run_mid(self, self.conv_in(torch.cat(list(planes), dim=0)))
        taps = []
        for i in reversed(range(len(self.up))):
            lvl = self.up[i]
            for j, blk in enumerate(lvl.block):
                h = blk(h)
                if len(lvl.attn):
                    h = lvl.attn[j](h)
            if lvl.inter_attn is not None:
                h = inter_plane(h, *lvl.inter_attn)
            if lvl.hdbf is not None:
                taps.append(lvl.hdbf(h))
            if lvl.upsample is not None:
                h = lvl.upsample(h)
        taps.append(self.conv_out(F.silu(self.norm_out(h))))
        return tuple([t[k * b : (k + 1) * b] for t in taps] for k in range(3))


class TriplaneAutoencoder(nn.Module):
    """The reference Autoencoder3D: the decode half, and with `with_encoder`
    the encoder and the quant convs too (the NeRF sampling path loads no
    encoder weights)."""

    def __init__(self, cfg, embed_dim: int = 64, with_encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed_dim = embed_dim
        if with_encoder:
            self.add_encoder()
        self.decoder = TriplaneDecoder(cfg)
        for plane in ("xy", "yz", "xz"):
            setattr(self, f"post_quant_conv_{plane}", nn.Conv2d(embed_dim, cfg.z_channels, 1))

    def add_encoder(self) -> None:
        """Build the encoder and the quant convs (drawing their initial
        weights from the global generator)."""
        self.encoder = TriplaneEncoder(self.cfg)
        for plane in ("xy", "yz", "xz"):
            setattr(self, f"quant_conv_{plane}",
                    nn.Conv2d(2 * self.cfg.z_channels, 2 * self.embed_dim, 1))

    def encode(self, planes):
        """(xy, yz, xz) NCHW feature planes -> their three DiagonalGaussian
        posteriors, in that order."""
        hs = self.encoder(planes)
        return tuple(
            DiagonalGaussian.from_moments(getattr(self, f"quant_conv_{plane}")(h))
            for plane, h in zip(("xy", "yz", "xz"), hs))

    def decode(self, z: torch.Tensor):
        """z (b, 3 * embed_dim, r, r), channels [xy | xz | yz] -> (pyr_xy,
        pyr_yz, pyr_xz).  The slice order differs from the plane order, as
        in the reference and the JAX package."""
        e = self.embed_dim
        xy = self.post_quant_conv_xy(z[:, :e])
        xz = self.post_quant_conv_xz(z[:, e : 2 * e])
        yz = self.post_quant_conv_yz(z[:, 2 * e :])
        return self.decoder((xy, yz, xz))

    def forward(self, planes, eps: Sequence[torch.Tensor]):
        """The whole autoencoder (JAX `TriplaneAutoencoder.__call__` with
        sample_posterior): encode the (xy, yz, xz) feature planes, sample
        each posterior with its standard-normal fp32 `eps` (plane order),
        pack [xy | xz | yz] and decode.  -> ((pyr_xy, pyr_yz, pyr_xz),
        posteriors)."""
        posts = self.encode(planes)
        xy, yz, xz = (p.sample(e) for p, e in zip(posts, eps))
        return self.decode(torch.cat([xy, xz, yz], dim=1)), posts

    def jax_layout(self) -> List[Tuple[str, Tuple[str, ...], str]]:
        """`jax_layout` of this autoencoder's config (core/sn_reg.py reads
        it); the encoder's entries only when it has one."""
        out = jax_layout(self.cfg, self.embed_dim)
        if not hasattr(self, "encoder"):
            out = [e for e in out if e[0].startswith(("decoder.", "post_quant_conv"))]
        return out


def jax_layout(cfg, embed_dim: int = 64) -> List[Tuple[str, Tuple[str, ...], str]]:
    """[(port module key, JAX parameter path, kind)] for every convolution
    ("conv": a 4-D kernel and a bias), Dense layer ("dense": the quant and
    post-quant 1x1 convs, (in, out) kernels in the JAX package, which the
    spectral-norm regulariser does not read) and GroupNorm ("gn") of the
    TriplaneAutoencoder with its encoder.  The JAX package names the
    ResnetBlocks (down_{i}_{j}, up_{i}_{j}, mid_block1/2), the inter-plane
    blocks (inter_{i}, mid_inter: block_a, AttnBlock_0, block_b), the
    resamplers (downsample_{i}, upsample_{i}) and the HDBF taps
    (hdbf_{res}); flax numbers the per-plane AttnBlocks of the encoder and
    of the decoder in creation order (the decoder's bottleneck one first).
    With `attn_type: linear` every attention is a LinAttnBlock
    (LinAttnBlock_{n}: a bias-free `to_qkv` and `to_out`, no norm)."""
    if cfg.attn_type not in ("vanilla", "vanilla-multihead", "linear", "none"):
        raise NotImplementedError(f"attn_type {cfg.attn_type!r} is not ported")
    out: List[Tuple[str, Tuple[str, ...], str]] = []
    has_attn = cfg.attn_type != "none"
    linear = cfg.attn_type == "linear"
    attn_name = "LinAttnBlock" if linear else "AttnBlock"

    def resnet(key, path, cin, cout):
        out.extend([(key + ".norm1", path + ("Norm_0", "GroupNorm_0"), "gn"),
                    (key + ".conv1", path + ("Conv_0",), "conv"),
                    (key + ".norm2", path + ("Norm_1", "GroupNorm_0"), "gn"),
                    (key + ".conv2", path + ("Conv_1",), "conv")])
        if cin != cout:
            out.append((key + ".nin_shortcut", path + ("nin_shortcut",), "conv"))

    def attn(key, path):
        if linear:
            out.extend([(key + ".to_qkv", path + ("to_qkv",), "conv_nobias"),
                        (key + ".to_out", path + ("to_out",), "conv")])
            return
        out.append((key + ".norm", path + ("Norm_0", "GroupNorm_0"), "gn"))
        out.extend((f"{key}.{n}", path + (n,), "conv") for n in ("q", "k", "v", "proj_out"))

    def inter(key_a, key_attn, key_b, path, c):
        resnet(key_a, path + ("block_a",), 3 * c, 3 * c)
        if has_attn:
            attn(key_attn, path + (f"{attn_name}_0",))
        resnet(key_b, path + ("block_b",), 3 * c, 3 * c)

    def mid(owner, path, c, ab):
        resnet(f"{owner}.mid.block_1", path + ("mid_block1",), c, c)
        if has_attn:
            attn(f"{owner}.mid.attn_1", path + (f"{attn_name}_{ab}",))
        resnet(f"{owner}.mid.block_2", path + ("mid_block2",), c, c)
        inter(f"{owner}.mid.block_3", f"{owner}.mid_attn", f"{owner}.mid.block_4",
              path + ("mid_inter",), c)

    n = len(cfg.ch_mult)
    enc = ("encoder",)
    out.append(("encoder.conv_in", enc + ("conv_in",), "conv"))
    ab, curr, block_in = 0, cfg.resolution, cfg.ch
    for i in range(n):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            resnet(f"encoder.down.{i}.block.{j}", enc + (f"down_{i}_{j}",), block_in, block_out)
            block_in = block_out
            if curr in cfg.attn_resolutions and has_attn:
                attn(f"encoder.down.{i}.attn.{j}", enc + (f"{attn_name}_{ab}",))
                ab += 1
        if curr in cfg.inter_attn_resolutions:
            key = f"encoder.down.{i}.inter_attn"
            inter(key + ".0", key + ".1", key + ".2", enc + (f"inter_{i}",), block_in)
        if i != n - 1:
            out.append((f"encoder.down.{i}.downsample.conv",
                        enc + (f"downsample_{i}", "Conv_0"), "conv"))
            curr //= 2
    mid("encoder", enc, block_in, ab)
    out.append(("encoder.norm_out", enc + ("norm_out", "GroupNorm_0"), "gn"))
    out.append(("encoder.conv_out", enc + ("conv_out",), "conv"))

    dec = ("decoder",)
    out.append(("decoder.conv_in", dec + ("conv_in",), "conv"))
    curr, block_in = cfg.resolution // 2 ** (n - 1), cfg.ch * cfg.ch_mult[-1]
    mid("decoder", dec, block_in, 0)
    ab = int(has_attn)
    for i in reversed(range(n)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            resnet(f"decoder.up.{i}.block.{j}", dec + (f"up_{i}_{j}",), block_in, block_out)
            block_in = block_out
            if curr in cfg.attn_resolutions and has_attn:
                attn(f"decoder.up.{i}.attn.{j}", dec + (f"{attn_name}_{ab}",))
                ab += 1
        if curr in cfg.inter_attn_resolutions:
            key = f"decoder.up.{i}.inter_attn"
            inter(key + ".0", key + ".1", key + ".2", dec + (f"inter_{i}",), block_in)
        if curr in cfg.hdbf_resolutions:
            out.append((f"decoder.up.{i}.hdbf.0", dec + (f"hdbf_{curr}",), "conv"))
        if i != 0:
            out.append((f"decoder.up.{i}.upsample.conv", dec + (f"upsample_{i}", "Conv_0"),
                        "conv"))
            curr *= 2
    out.append(("decoder.norm_out", dec + ("norm_out", "GroupNorm_0"), "gn"))
    out.append(("decoder.conv_out", dec + ("conv_out",), "conv"))
    for plane in ("xy", "yz", "xz"):
        out.append((f"quant_conv_{plane}", (f"quant_{plane}",), "dense"))
        out.append((f"post_quant_conv_{plane}", (f"post_{plane}",), "dense"))
    return out
