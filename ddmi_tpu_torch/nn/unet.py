"""ADM (guided-diffusion) UNet denoiser (counterpart of ddmi_tpu/nn/unet.py).

Module tree and state keys follow the reference `openaimodel.UNetModel`:
`time_embed.{0,2}`, `input_blocks.*`, `middle_block.*`, `output_blocks.*`,
`out.{0,2}`; ResBlocks have `in_layers`/`emb_layers`/`out_layers`/
`skip_connection`; attention has `norm`, a head-major `qkv` Conv1d and
`proj_out`.  Tensors are NCHW; on CUDA the UNet runs channels-last so that
the attention kernel's NHWC view of a feature map is free.  The triplane
(video) variant builds on this one in nn/unet_triplane.py.

The JAX UNet's three options: `use_scale_shift_norm` (the ResBlock's
embedding projection gives a scale and a shift for its second norm),
`num_classes` (`label_emb`, a label embedding added to the timestep
embedding; `forward(..., y=)`) and `use_spatial_transformer`
(SpatialTransformer blocks, nn/transformer.py, in place of the attention
blocks, attending to `forward(..., cond=)`).  Dropout is read but inactive,
as in the JAX UNet's deterministic apply.

Dtype plan (as the JAX UNet's): everything in the parameters' dtype (bf16
for sampling), GroupNorm statistics in fp32, and the final `out.2` conv in
fp32 on the fp32 cast of its input and weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.transformer import SpatialTransformer
from ddmi_tpu_torch.ops import attention, attn_block, flash_attention


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding [cos | sin], fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def qkv_permutation(num_heads: int, head_dim: int) -> np.ndarray:
    """qkv output channels: qkv-major position j <- head-major channel
    perm[j] (as ddmi_tpu/interop/reference_ckpt.py::qkv_permutation)."""
    idx = np.arange(3 * num_heads * head_dim).reshape(num_heads, 3, head_dim)
    return idx.transpose(1, 0, 2).reshape(-1)


class TimestepBlock(nn.Module):
    """A module whose forward takes the timestep embedding too."""


class TimestepEmbedSequential(nn.Sequential):
    def forward(self, x, emb, context=None):
        for layer in self:
            if isinstance(layer, TimestepBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class ResBlock(TimestepBlock):
    """Timestep-embedded residual block (GroupNorm eps 1e-5).  Dropout is
    inactive; `out_layers.2` keeps its place in the state keys.  With
    `use_scale_shift_norm` the embedding projection gives 2 C channels,
    (scale, shift), and the second norm's output becomes norm * (1 + scale)
    + shift; else the embedding is added before that norm."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            nn.GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
            nn.Conv2d(channels, out_channels, 3, padding=1),
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(32, out_channels, eps=1e-5), nn.SiLU(), nn.Identity(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
        )
        nn.init.zeros_(self.out_layers[3].weight)
        nn.init.zeros_(self.out_layers[3].bias)
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else nn.Conv2d(channels, out_channels, 1)
        )

    def forward(self, x, emb):
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).to(h.dtype)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = self.out_layers[3](self.out_layers[1](h))
        else:
            h = self.out_layers(h + emb_out)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Self-attention over the flattened feature map, through the JAX
    package's tiers in its order (ddmi_tpu/nn/unet.py::AttentionBlock).
    With no gradient recorded (the counterpart of JAX's inference traces):
    the fused block (ops/attn_block.py) where its predicate takes the shape,
    else GroupNorm + qkv in PyTorch and then mha_vmem (ops/attention.py),
    flash (ops/flash_attention.py, n >= 512) or dense attention.  With a
    gradient (training): flash for n >= 512, else dense attention (scores
    in the input dtype, fp32 softmax, probabilities cast back before P.V).
    On a CUDA tensor the kernel tiers launch the port's kernels (or raise
    for a shape a kernel does not take), on a CPU tensor they run their
    plain versions."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(32, channels, eps=1e-5)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x):
        B, C, H, W = x.shape
        nh = self.num_heads
        hd = C // nh
        n = H * W
        inference = not torch.is_grad_enabled()
        if inference and attn_block.jax_supported(n, C, nh):
            # the parameters as stored: the kernel reads the head-major qkv
            # weight and the proj weight in place (no copy per call)
            out = attn_block.attention_block(
                x.permute(0, 2, 3, 1), self.norm.weight, self.norm.bias, self.qkv.weight,
                self.qkv.bias, self.proj_out.weight, self.proj_out.bias, nh, hd**-0.5, 32,
                self.norm.eps,
            )
            return out.permute(0, 3, 1, 2)
        # head-major qkv channels (QKVAttentionLegacy): (B, nh, 3, hd, n)
        qkv = self.qkv(self.norm(x).reshape(B, C, n)).reshape(B, nh, 3, hd, n)
        q, k, v = (qkv[:, :, i].transpose(-1, -2).contiguous() for i in range(3))
        if inference and attention.supported(n, hd):
            out = attention.mha_vmem(q, k, v, hd**-0.5)
        elif n >= flash_attention.MIN_TOKENS:
            out = flash_attention.flash_attention(q, k, v, hd**-0.5)
        else:
            s = (q @ k.transpose(-1, -2)).float() * hd**-0.5
            out = torch.softmax(s, dim=-1).to(v.dtype) @ v
        out = out.transpose(-1, -2).reshape(B, C, n)
        return x + self.proj_out(out).reshape(B, C, H, W)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _num_heads(ch: int, cfg) -> int:
    if cfg.num_head_channels != -1:
        return max(1, ch // cfg.num_head_channels)
    return max(1, cfg.num_heads)


class UNet(nn.Module):
    """The denoiser: x (b, c_in, h, w), t (b,) -> (b, c_out, h, w) fp32.

    Encoder propagation (turbo sampling, arXiv:2312.09608), as the JAX
    UNet's: `return_cache=True` also returns the down path's features (the
    bottleneck input and the skip stack); a later call with `cache=` skips
    `input_blocks` (the stem and the down path) and runs the middle and up
    paths on the cached features under the current timestep embedding.
    Exact when x and t are the caching call's; across DDIM steps an
    approximation (diffusion/process.py::ddim_sample_encoder_reuse).

    `cond` (B, m, context_dim) is the spatial transformers' context, `y`
    (B,) the class labels; each raises ValueError where the config lacks
    (or needs) it, as the JAX UNet does."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        block = lambda cin, cout: ResBlock(cin, ted, cout, cfg.use_scale_shift_norm)

        def attn(ch):
            nh = _num_heads(ch, cfg)
            if cfg.use_spatial_transformer:
                return SpatialTransformer(ch, nh, ch // nh, cfg.transformer_depth,
                                          cfg.context_dim)
            return AttentionBlock(ch, nh)

        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, ted)
        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(nn.Conv2d(cfg.in_channels, mc, 3, padding=1))]
        )
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [block(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(block(ch, ch), attn(ch), block(ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [block(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(
            nn.GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
            nn.Conv2d(ch, cfg.out_channels, 3, padding=1),
        )
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)

    def embed(self, t, y=None, cond=None) -> torch.Tensor:
        """The timestep embedding, plus the label embedding of a
        class-conditional UNet; checks `cond` and `y` against the config."""
        c = self.cfg
        if cond is not None and not c.use_spatial_transformer:
            raise ValueError(
                "cond was passed but unetconfig.use_spatial_transformer is off - enable "
                "it (with context_dim) to get the cross-attention conditioning path")
        if c.use_spatial_transformer and c.context_dim is None:
            raise ValueError("use_spatial_transformer requires unetconfig.context_dim")
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(t, c.model_channels).to(dtype))
        if c.num_classes is not None:
            if y is None:
                raise ValueError("num_classes is set; class labels y required")
            emb = emb + self.label_emb(y)
        return emb

    def forward(self, x, t, cond=None, y=None, *, cache=None, return_cache: bool = False):
        emb = self.embed(t, y, cond)
        if cache is not None:
            h, hs = cache[0], list(cache[1])
        else:
            h = x.to(emb.dtype)
            if h.is_cuda:
                h = h.contiguous(memory_format=torch.channels_last)
            hs = []
            for module in self.input_blocks:
                h = module(h, emb, cond)
                hs.append(h)
        out_cache = (h, tuple(hs))
        h = self.middle_block(h, emb, cond)
        for module in self.output_blocks:
            h = module(torch.cat([h, hs.pop()], dim=1), emb, cond)
        h = self.out[1](self.out[0](h))
        conv = self.out[2]
        out = F.conv2d(h.float(), conv.weight.float(), conv.bias.float(), padding=1)
        return (out, out_cache) if return_cache else out
