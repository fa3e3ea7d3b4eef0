"""D2C-VAE: the conv encoder to a diagonal-Gaussian posterior and the
decoder emitting the HDBF plane pyramid (counterpart of ddmi_tpu/nn/vae.py).

State keys follow the reference `autoencoder_unet` Autoencoder: the Encoder
(`encoder.conv_in`, `encoder.down.{i}.{block,attn,downsample}`,
`encoder.mid.{block_1,attn_1,block_2}`, `encoder.norm_out`,
`encoder.conv_out`), `quant_conv`, the Decoder (`decoder.conv_in`,
`decoder.mid.*`, `decoder.up.{i}.{block,attn,hdbf,upsample}`,
`decoder.norm_out`, `decoder.conv_out`) and `post_quant_conv`.
`jax_layout` names the JAX package's parameter path of every convolution
and GroupNorm, which the weight bridge and the spectral-norm regulariser
(core/sn_reg.py, whose matrices JAX orders by path) read.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.distributions import DiagonalGaussian


def Norm(channels: int) -> nn.GroupNorm:
    """GroupNorm(32, eps=1e-6) as used throughout the LDM VAE."""
    return nn.GroupNorm(32, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    """Two GN-SiLU-conv steps and a residual (dropout is inactive when
    sampling)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = Norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = Norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Spatial self-attention, single-head or with `num_heads` head-major
    channel groups (plain PyTorch: not a TPU kernel in the JAX package).
    Scores are taken in the input dtype, softmax in fp32."""

    def __init__(self, channels: int, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.norm = Norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        nh = self.num_heads
        hd = C // nh
        h = self.norm(x)
        q = self.q(h).reshape(B, nh, hd, H * W).transpose(-1, -2)   # (B, nh, n, hd)
        k = self.k(h).reshape(B, nh, hd, H * W)                     # (B, nh, hd, n)
        v = self.v(h).reshape(B, nh, hd, H * W).transpose(-1, -2)   # (B, nh, n, hd)
        s = (q @ k).float() * hd**-0.5
        p = torch.softmax(s, dim=-1).to(v.dtype)
        del s
        out = (p @ v).transpose(-1, -2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Asymmetric (0, 1) pad, then a stride-2 valid 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class LinAttnBlock(nn.Module):
    """Linear attention (`attn_type: linear`; the reference's LinAttnBlock,
    heads 1, dim_head C): no pre-norm and no residual.  A bias-free
    `to_qkv` 1x1 conv gives qkv-major channels (q, then k, then v); k is
    softmaxed over the spatial axis, the context k v^T (C x C) is read out
    by q, and `to_out` (with bias) maps back.  The softmax and both
    contractions run in fp32, the output in the input's dtype."""

    def __init__(self, channels: int, heads: int = 1):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Conv2d(channels, 3 * channels, 1, bias=False)
        self.to_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        nh = self.heads
        qkv = self.to_qkv(x).reshape(B, 3, nh, C // nh, H * W).float()
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]            # (B, nh, d, n)
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(B, C, H, W).to(x.dtype))


def _make_attn(channels: int, attn_type: str):
    if attn_type == "vanilla":
        return AttnBlock(channels)
    if attn_type == "vanilla-multihead":
        return AttnBlock(channels, num_heads=16)
    if attn_type == "linear":
        return LinAttnBlock(channels)
    if attn_type == "none":
        return None
    raise NotImplementedError(f"attn_type {attn_type!r} is not ported")


class Encoder(nn.Module):
    """Downsampling conv encoder -> 2 * z_channels moments."""

    def __init__(self, cfg):
        super().__init__()
        if not cfg.double_z:
            raise NotImplementedError("the Autoencoder needs double_z")
        curr = cfg.resolution
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
            if i != len(cfg.ch_mult) - 1:
                lvl.downsample = Downsample(block_in)
                curr //= 2
            self.down.append(lvl)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = _make_attn(block_in, cfg.attn_type)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        self.norm_out = Norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for lvl in self.down:
            for j, blk in enumerate(lvl.block):
                h = blk(h)
                if len(lvl.attn):
                    h = lvl.attn[j](h)
            if hasattr(lvl, "downsample"):
                h = lvl.downsample(h)
        h = self.mid.block_1(h)
        if self.mid.attn_1 is not None:
            h = self.mid.attn_1(h)
        h = self.mid.block_2(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """Upsampling conv decoder -> HDBF planes, coarse to fine: a 1x1 tap at
    each resolution in `hdbf_resolutions` plus the final 3x3 output conv."""

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

    def forward(self, z) -> List[torch.Tensor]:
        hdbf = []
        h = self.mid.block_1(self.conv_in(z))
        if self.mid.attn_1 is not None:
            h = self.mid.attn_1(h)
        h = self.mid.block_2(h)
        for i in reversed(range(len(self.up))):
            lvl = self.up[i]
            for j, blk in enumerate(lvl.block):
                h = blk(h)
                if len(lvl.attn):
                    h = lvl.attn[j](h)
            if lvl.hdbf is not None:
                hdbf.append(lvl.hdbf(h))
            if lvl.upsample is not None:
                h = lvl.upsample(h)
        hdbf.append(self.conv_out(F.silu(self.norm_out(h))))
        return hdbf


class Autoencoder(nn.Module):
    """encode -> DiagonalGaussian over embed_dim latents (encoder, then
    quant_conv); decode -> HDBF list (post_quant_conv, then the decoder)."""

    def __init__(self, cfg, embed_dim: int = 64):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, cfg.z_channels, 1)

    def encode(self, x) -> DiagonalGaussian:
        """x (b, in_channels, res, res) -> the posterior over latents."""
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def decode(self, z) -> List[torch.Tensor]:
        return self.decoder(self.post_quant_conv(z))

    def jax_layout(self) -> List[Tuple[str, Tuple[str, ...], str]]:
        """`jax_layout` of this VAE's config (core/sn_reg.py reads it)."""
        return jax_layout(self.cfg)


def jax_layout(cfg) -> List[Tuple[str, Tuple[str, ...], str]]:
    """[(port module key, JAX parameter path, kind)] for every convolution
    ("conv", kernel and bias; "conv_nobias", kernel only) and GroupNorm
    ("gn") of the Autoencoder: flax numbers ResnetBlock / AttnBlock /
    LinAttnBlock / Downsample / Upsample instances per parent in call
    order, the decoder's levels from coarse to fine (the inverse of
    ddmi_tpu/interop/reference_ckpt.py::convert_vae)."""
    out: List[Tuple[str, Tuple[str, ...], str]] = []
    attn_name = "LinAttnBlock" if cfg.attn_type == "linear" else "AttnBlock"

    def resnet(key, path, cin, cout):
        out.extend([(key + ".norm1", path + ("Norm_0", "GroupNorm_0"), "gn"),
                    (key + ".conv1", path + ("Conv_0",), "conv"),
                    (key + ".norm2", path + ("Norm_1", "GroupNorm_0"), "gn"),
                    (key + ".conv2", path + ("Conv_1",), "conv")])
        if cin != cout:
            out.append((key + ".nin_shortcut", path + ("nin_shortcut",), "conv"))

    def attn(key, path):
        if cfg.attn_type == "linear":
            out.extend([(key + ".to_qkv", path + ("to_qkv",), "conv_nobias"),
                        (key + ".to_out", path + ("to_out",), "conv")])
        else:
            out.append((key + ".norm", path + ("Norm_0", "GroupNorm_0"), "gn"))
            out.extend((f"{key}.{n}", path + (n,), "conv") for n in ("q", "k", "v", "proj_out"))

    n = len(cfg.ch_mult)
    enc = ("encoder",)
    out.append(("encoder.conv_in", enc + ("conv_in",), "conv"))
    rb = ab = 0
    curr, block_in = cfg.resolution, cfg.ch
    for i in range(n):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            resnet(f"encoder.down.{i}.block.{j}", enc + (f"ResnetBlock_{rb}",), block_in,
                   block_out)
            rb, block_in = rb + 1, block_out
            if curr in cfg.attn_resolutions:
                attn(f"encoder.down.{i}.attn.{j}", enc + (f"{attn_name}_{ab}",))
                ab += 1
        if i != n - 1:
            out.append((f"encoder.down.{i}.downsample.conv",
                        enc + (f"Downsample_{i}", "Conv_0"), "conv"))
            curr //= 2
    resnet("encoder.mid.block_1", enc + (f"ResnetBlock_{rb}",), block_in, block_in)
    if cfg.attn_type != "none":
        attn("encoder.mid.attn_1", enc + (f"{attn_name}_{ab}",))
    resnet("encoder.mid.block_2", enc + (f"ResnetBlock_{rb + 1}",), block_in, block_in)
    out.append(("encoder.norm_out", enc + ("Norm_0", "GroupNorm_0"), "gn"))
    out.append(("encoder.conv_out", enc + ("conv_out",), "conv"))
    out.append(("quant_conv", ("quant_conv",), "conv"))

    dec = ("decoder",)
    out.append(("decoder.conv_in", dec + ("conv_in",), "conv"))
    rb = ab = up = 0
    curr, block_in = cfg.resolution // 2 ** (n - 1), cfg.ch * cfg.ch_mult[-1]
    resnet("decoder.mid.block_1", dec + (f"ResnetBlock_{rb}",), block_in, block_in)
    if cfg.attn_type != "none":
        attn("decoder.mid.attn_1", dec + (f"{attn_name}_{ab}",))
        ab += 1
    resnet("decoder.mid.block_2", dec + (f"ResnetBlock_{rb + 1}",), block_in, block_in)
    rb += 2
    for i in reversed(range(n)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            resnet(f"decoder.up.{i}.block.{j}", dec + (f"ResnetBlock_{rb}",), block_in,
                   block_out)
            rb, block_in = rb + 1, block_out
            if curr in cfg.attn_resolutions:
                attn(f"decoder.up.{i}.attn.{j}", dec + (f"{attn_name}_{ab}",))
                ab += 1
        if curr in cfg.hdbf_resolutions:
            out.append((f"decoder.up.{i}.hdbf.0", dec + (f"hdbf_{curr}",), "conv"))
        if i != 0:
            out.append((f"decoder.up.{i}.upsample.conv", dec + (f"Upsample_{up}", "Conv_0"),
                        "conv"))
            up += 1
            curr *= 2
    out.append(("decoder.norm_out", dec + ("Norm_0", "GroupNorm_0"), "gn"))
    out.append(("decoder.conv_out", dec + ("conv_out",), "conv"))
    out.append(("post_quant_conv", ("post_quant_conv",), "conv"))
    return out
