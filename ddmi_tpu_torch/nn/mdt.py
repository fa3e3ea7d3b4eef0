"""MDTv2, the masked diffusion transformer (the `model.DiT: True` denoiser;
counterpart of ddmi_tpu/nn/mdt.py).

Patchify, adaLN transformer blocks with 2D relative-position-bias
attention, U-style skips (`en_inblocks` -> `en_outblocks` with skips, then
`de_blocks` skipping to the input tokens), masked-latent training with a
side interpolater, and a cross-plane mode for triplane latents.  The
module tree and state keys are the original repository's
`maskedtransformer.py`: `x_embedder.proj` (a p x p stride-p Conv2d),
`pos_embed`, `decoder_pos_embed`, `mask_token`, `t_embedder.mlp.{0,2}`,
`en_inblocks.i`, `en_outblocks.i`, `de_blocks.i`, `sideblocks.0`,
`final_layer.{adaLN_modulation.1,linear}`; per block `attn.qkv`,
`attn.proj`, `attn.rel_pos_bias.relative_position_bias_table`,
`mlp.fc1`, `mlp.fc2`, `adaLN_modulation.1` and `skip_linear`.  The
relative-position index is a derived, non-persistent buffer.

As in the JAX module, masked training keeps a static token count (the mean
mask ratio, mask_ratio + 0.1) and draws the kept set per sample from an
explicit (B, L) uniform `mask_noise`; the attention bias is added only
where its size matches the token count, so the cross-plane mode's 3L-token
blocks run without it.

Dtypes follow flax's promotion, as the JAX module computes under the bf16
policy: every Linear and the patch Conv2d compute in the promotion of
their input's and weight's dtypes (bf16 weights on an fp32 input compute
in fp32 on the bf16-rounded values), the LayerNorms (no affine, eps 1e-6)
take fp32 statistics and return the input's dtype, and the timestep
embedding is fp32.  So with bf16 weights and a bf16 input only the patch
embedding, the position add and the first norm run in bf16; the first
modulation meets the fp32 conditioning and the rest of the network
computes in fp32.  Attention is dense and in the compute dtype: scores
times the scale, plus the bias, softmax, then P.V (the JAX module reaches
no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.inr import promoted_linear
from ddmi_tpu_torch.nn.unet import timestep_embedding

# The timestep embedder's sinusoid width, whatever the hidden size.
FREQ_DIM = 256


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _rel_pos_index(h: int, w: int) -> np.ndarray:
    """Swin-style (h*w, h*w) index into the (2h-1)(2w-1)+3-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def _layer_norm(x):
    """LayerNorm with no affine, eps 1e-6: fp32 statistics, x's dtype out."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


def _adaln(seq: nn.Sequential, c):
    """adaLN_modulation = Sequential(SiLU, Linear) with flax's promotion."""
    return promoted_linear(seq[1], F.silu(c))


class RelativePositionBias(nn.Module):
    def __init__(self, window, num_heads: int):
        super().__init__()
        h, w = window
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * h - 1) * (2 * w - 1) + 3, num_heads) * 0.02)
        # torch.tensor, not from_numpy: a factory, so it lands on the
        # device a `with device:` block builds the module on
        self.register_buffer("relative_position_index", torch.tensor(_rel_pos_index(h, w)),
                             persistent=False)

    def forward(self, ids_keep: Optional[torch.Tensor] = None):
        """-> (1, nh, L, L), or with the per-sample kept ids (B, nk) the
        kept rows and columns of each sample, (B, nh, nk, nk)."""
        index = self.relative_position_index
        if ids_keep is None:
            return self.relative_position_bias_table[index].permute(2, 0, 1)[None]
        index = index[ids_keep[:, :, None], ids_keep[:, None, :]]
        return self.relative_position_bias_table[index].permute(0, 3, 1, 2)


class RPBAttention(nn.Module):
    """Multi-head attention with a learned relative position bias; qkv is
    split qkv-major, then head-major."""

    def __init__(self, dim: int, num_heads: int, window):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias = RelativePositionBias(window, num_heads)

    def forward(self, x, ids_keep=None):
        B, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = promoted_linear(self.qkv, x).reshape(B, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-1, -2)) * hd**-0.5
        bias = self.rel_pos_bias(ids_keep)
        if bias.shape[-1] == N:
            attn = attn + bias
        out = torch.softmax(attn, dim=-1) @ v
        return promoted_linear(self.proj, out.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return promoted_linear(self.fc2, F.gelu(promoted_linear(self.fc1, x), approximate="tanh"))


class MDTBlock(nn.Module):
    """adaLN transformer block (shift, scale, gate for attention, then for
    the MLP), with an optional skip fusion `skip_linear([x | skip])`."""

    def __init__(self, dim: int, num_heads: int, window, mlp_ratio: float = 4.0,
                 skip: bool = False):
        super().__init__()
        self.attn = RPBAttention(dim, num_heads, window)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 6 * dim))
        self.skip_linear = nn.Linear(2 * dim, dim) if skip else None
        nn.init.zeros_(self.adaLN_modulation[1].weight)
        nn.init.zeros_(self.adaLN_modulation[1].bias)

    def forward(self, x, c, skip=None, ids_keep=None):
        if self.skip_linear is not None:
            dt = torch.promote_types(x.dtype, skip.dtype)
            x = promoted_linear(self.skip_linear, torch.cat([x.to(dt), skip.to(dt)], dim=-1))
        sa_shift, sa_scale, sa_gate, mlp_shift, mlp_scale, mlp_gate = (
            _adaln(self.adaLN_modulation, c).chunk(6, dim=-1))
        h = modulate(_layer_norm(x), sa_shift, sa_scale)
        x = x + sa_gate[:, None] * self.attn(h, ids_keep)
        h = modulate(_layer_norm(x), mlp_shift, mlp_scale)
        return x + mlp_gate[:, None] * self.mlp(h)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_channels: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)

    def forward(self, x):
        """(B, C, H, W) -> (B, L, D) tokens, row-major over the patch grid."""
        dt = torch.promote_types(x.dtype, self.proj.weight.dtype)
        h = F.conv2d(x.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt),
                     stride=self.proj.stride)
        return h.flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQ_DIM, dim), nn.SiLU(), nn.Linear(dim, dim))

    def forward(self, t):
        h = F.silu(promoted_linear(self.mlp[0], timestep_embedding(t, FREQ_DIM)))
        return promoted_linear(self.mlp[2], h)


class FinalLayer(nn.Module):
    def __init__(self, dim: int, patch: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(dim, patch * patch * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 2 * dim))
        for layer in (self.linear, self.adaLN_modulation[1]):
            nn.init.zeros_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(self, x, c):
        shift, scale = _adaln(self.adaLN_modulation, c).chunk(2, dim=-1)
        return promoted_linear(self.linear, modulate(_layer_norm(x), shift, scale))


class MDTv2(nn.Module):
    """forward(x (B, C, H, W), t (B,), mask_noise=None) -> (B, C, H, W);
    in cross-plane mode x holds three planes along C (B, 3C, H, W).
    `mask_noise` (B, L) uniform draws (L the token count, 3 H W / p^2 in
    cross-plane mode) runs the masked training path; the module then has
    `mask_token` and `sideblocks` (cfg.mask_ratio set).  The output is in
    the compute dtype (fp32 whenever the conditioning is)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        p, D = cfg.patch_size, cfg.hidden_size
        hp = cfg.input_size // p
        L = hp * hp
        window = (hp, hp)
        self.x_embedder = PatchEmbed(p, cfg.in_channels, D)
        self.pos_embed = nn.Parameter(torch.randn(1, L, D) * 0.02)
        self.decoder_pos_embed = nn.Parameter(torch.randn(1, L, D) * 0.02)
        self.t_embedder = TimestepEmbedder(D)
        half_depth = (cfg.depth - cfg.decode_layer) // 2
        block = lambda skip: MDTBlock(D, cfg.num_heads, window, cfg.mlp_ratio, skip)
        self.en_inblocks = nn.ModuleList([block(False) for _ in range(half_depth)])
        self.en_outblocks = nn.ModuleList([block(True) for _ in range(half_depth)])
        self.de_blocks = nn.ModuleList([block(True) for _ in range(cfg.decode_layer)])
        if cfg.mask_ratio is not None:
            self.sideblocks = nn.ModuleList([block(False)])
            self.mask_token = nn.Parameter(torch.randn(1, 1, D) * 0.02)
        self.final_layer = FinalLayer(D, p, cfg.in_channels)

    def num_tokens(self) -> int:
        """L of `mask_noise`: the patches of one plane, times 3 in
        cross-plane mode."""
        c = self.cfg
        n = (c.input_size // c.patch_size) ** 2
        return 3 * n if c.cross_plane else n

    def keep_count(self) -> int:
        """The tokens the masked path keeps: L (1 - min(0.99, ratio + 0.1))."""
        ratio = min(0.99, self.cfg.mask_ratio + 0.1)
        return max(1, int(self.num_tokens() * (1 - ratio)))

    def forward(self, x, t, mask_noise: Optional[torch.Tensor] = None):
        c = self.cfg
        p = c.patch_size
        B, _, H, W = x.shape
        hp, wp = H // p, W // p
        D = c.hidden_size
        if c.cross_plane:
            tokens = torch.cat([self.x_embedder(pl) + self.pos_embed
                                for pl in x.chunk(3, dim=1)], dim=1)
        else:
            tokens = self.x_embedder(x) + self.pos_embed
        cvec = self.t_embedder(t)

        xx = input_skip = tokens
        ids_keep = None
        if mask_noise is not None:
            if c.mask_ratio is None:
                raise ValueError("mask_noise needs ditconfig.mask_ratio")
            Ltot = xx.shape[1]
            nk = self.keep_count()
            ids_shuffle = torch.argsort(mask_noise.to(x.device), dim=1, stable=True)
            ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
            ids_keep = ids_shuffle[:, :nk]
            xx = torch.gather(xx, 1, ids_keep[..., None].expand(-1, -1, D))
            mask = torch.ones(B, Ltot, device=x.device)
            mask[:, :nk] = 0.0
            mask = torch.gather(mask, 1, ids_restore)

        rpb_ids = None if c.cross_plane else ids_keep
        skips = []
        for blk in self.en_inblocks:
            xx = blk(xx, cvec, ids_keep=rpb_ids)
            skips.append(xx)
        for blk in self.en_outblocks:
            xx = blk(xx, cvec, skip=skips.pop(), ids_keep=rpb_ids)

        if ids_keep is not None:
            # the side interpolater: the kept tokens scattered back among
            # mask tokens, one side block, and the kept tokens restored
            pad = self.mask_token.expand(B, Ltot - xx.shape[1], D)
            x_ = torch.cat([xx, pad.to(xx.dtype)], dim=1)
            x_ = torch.gather(x_, 1, ids_restore[..., None].expand(-1, -1, D))
            x_ = x_ + self.decoder_pos_embed
            m = mask[..., None]
            xx = self.sideblocks[0](x_, cvec) * m + (1 - m) * x_
        elif c.cross_plane:
            xx = xx + self.decoder_pos_embed.repeat(1, 3, 1)
        else:
            xx = xx + self.decoder_pos_embed

        for blk in self.de_blocks:
            xx = blk(xx, cvec, skip=input_skip)

        def final(tok):
            h = self.final_layer(tok, cvec).reshape(B, hp, wp, p, p, c.in_channels)
            return h.permute(0, 5, 1, 3, 2, 4).reshape(B, c.in_channels, H, W)

        if c.cross_plane:
            return torch.cat([final(tok) for tok in xx.chunk(3, dim=1)], dim=1)
        return final(xx)

