"""TimeSformer building blocks of the video VAE's encoder (counterpart of
ddmi_tpu/nn/vit.py; reference models/d2c_vae/vit_modules.py): divided
space-time attention with rotary embeddings, and the pre-norm transformer
that pools each axis into a class token.

Video enters time-major (b, t, h, w, c), as in the JAX package.  State
keys follow the reference: `to_patch_embedding`, then per layer
`layers.{i}.{0,1,2}` = PreNorm(time attention), PreNorm(space attention),
PreNorm(GEGLU feed-forward), each `{norm, fn}` with `fn.to_qkv` (no bias),
`fn.to_out.0` and `fn.net.{0,3}`.  The rotary tables are computed, not
stored.  LayerNorms take flax's eps 1e-6.  q is scaled by dim_head^-0.5 in
its own dtype before the regrouping and the rotary; the fp32 rotary tables
then promote q and k to fp32 (JAX's promotion), while v keeps its dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ddmi_tpu_torch.ops import mea

LN_EPS = 1e-6


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...): interleaved pairs."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rot_emb(q, k, rot_emb):
    """Rotary embedding on the first rot_dim channels of q and k (..., n, d);
    sin, cos (1, n, rot_dim)."""
    sin, cos = rot_emb
    rot_dim = sin.shape[-1]

    def rot(t):
        t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
        t_rot = t_rot * cos + rotate_every_two(t_rot) * sin
        return torch.cat([t_rot, t_pass.to(t_rot.dtype)], dim=-1)

    return rot(q), rot(k)


def rotary_frame_emb(n: int, dim_head: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """1D rotary over the time axis -> fp32 (sin, cos), each (1, n, dim_head)."""
    inv_freqs = 1.0 / 10000 ** (torch.arange(0, dim_head, 2, device=device).float() / dim_head)
    freqs = torch.arange(n, device=device).float()[:, None] * inv_freqs[None]
    freqs = torch.cat([freqs, freqs], dim=-1)[None]
    return freqs.sin(), freqs.cos()


def rotary_axial_emb(h: int, w: int, dim_head: int, max_freq: int = 10, device=None):
    """2D axial rotary over the space axes -> fp32 (sin, cos), each (1, h * w,
    dim_head): scales 2^linspace(0, log2(max_freq / 2)), positions
    linspace(-1, 1), each sinusoid's value repeated for its pair."""
    n_scales = dim_head // 4
    scales = torch.logspace(0.0, math.log(max_freq / 2) / math.log(2), n_scales, base=2.0,
                            device=device)
    h_seq = torch.linspace(-1.0, 1.0, h, device=device)[:, None] * scales[None] * math.pi
    w_seq = torch.linspace(-1.0, 1.0, w, device=device)[:, None] * scales[None] * math.pi
    x_sinu = h_seq[:, None, :].expand(h, w, n_scales)
    y_sinu = w_seq[None, :, :].expand(h, w, n_scales)
    sin = torch.cat([x_sinu.sin(), y_sinu.sin()], dim=-1).reshape(h * w, -1)
    cos = torch.cat([x_sinu.cos(), y_sinu.cos()], dim=-1).reshape(h * w, -1)
    return (sin.repeat_interleave(2, dim=-1)[None], cos.repeat_interleave(2, dim=-1)[None])


def _attend(q, k, v):
    """q pre-scaled: the MEA with the TimeSformer's tiling, so the per-frame
    space attention (n = 1024 at 256^2) streams and the short time and
    pooling attentions stay dense."""
    return mea.attention(q, k, v, kv_chunk=1024, q_chunk=256, scale=1.0, dense_max=512)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn


class FeedForwardGEGLU(nn.Module):
    """Linear(dim, 2 * mult * dim) -> value * gelu(gate) (exact erf) ->
    Linear(mult * dim, dim); `net.1` and `net.2` hold the reference's GEGLU
    and dropout, which have no state."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult * 2), nn.Identity(), nn.Identity(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        a, gates = self.net[0](x).chunk(2, dim=-1)
        return self.net[3](a * F.gelu(gates))


class FeedForwardMLP(nn.Module):
    """Linear -> GELU (exact erf) -> Linear; `net.1`, `net.2` stateless."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.Identity(), nn.Identity(),
                                 nn.Linear(hidden_dim, dim))

    def forward(self, x):
        return self.net[3](F.gelu(self.net[0](x)))


class Attention(nn.Module):
    """to_qkv (no bias) and to_out.0 of a multi-head attention."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def qkv(self, x):
        """(b, n, dim) -> q (scaled), k, v, each (b, heads, n, dim_head)."""
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        return q * self.dim_head**-0.5, k, v

    def out(self, o):
        b, _, n, _ = o.shape
        return self.to_out[0](o.transpose(1, 2).reshape(b, n, -1))


class DividedAttention(Attention):
    """One attention over the time axis (within each spatial site) or the
    space axis (within each frame) of (b, f * n, dim) tokens, with rotary."""

    def forward(self, x, group: str, f: int, n: int, rot_emb=None):
        b, h, d = x.shape[0], self.heads, self.dim_head
        q, k, v = self.qkv(x)
        if group == "time":
            shape = lambda t: t.reshape(b, h, f, n, d).transpose(2, 3)
            unshape = lambda t: t.transpose(2, 3).reshape(b, h, f * n, d)
        else:
            shape = lambda t: t.reshape(b, h, f, n, d)
            unshape = lambda t: t.reshape(b, h, f * n, d)
        q, k, v = map(shape, (q, k, v))
        if rot_emb is not None:
            q, k = apply_rot_emb(q, k, rot_emb)
        return self.out(unshape(_attend(q, k, v)))


class TimeSformerLayer(nn.ModuleList):
    """[time attention, space attention, GEGLU], each pre-norm and added to
    the residual stream."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__([PreNorm(dim, DividedAttention(dim, heads, dim_head)),
                          PreNorm(dim, DividedAttention(dim, heads, dim_head)),
                          PreNorm(dim, FeedForwardGEGLU(dim))])

    def forward(self, x, f: int, n: int, frame_rot, image_rot):
        time, space, ff = self
        x = x + time.fn(time.norm(x), "time", f, n, frame_rot)
        x = x + space.fn(space.norm(x), "space", f, n, image_rot)
        return x + ff.fn(ff.norm(x))


def _remat(module: nn.Module, *args):
    """module(*args), under autograd through a non-reentrant checkpoint
    (the backward recomputes it); the parameters in use now (bf16 casts
    under the amp policy's functional_call) are captured, so the recompute
    reads the same ones."""
    if not torch.is_grad_enabled():
        return module(*args)
    params = dict(module.named_parameters())
    return checkpoint(functional_call, module, params, args, use_reentrant=False)


class TimeSformerEncoder(nn.Module):
    """(b, f, h, w, c) video -> (b, f * hp * wp, dim) patch tokens through
    `depth` divided space-time layers.  Each layer is checkpointed under
    autograd, as the JAX package's nn.remat: otherwise a layer keeps its
    attention tiles for the backward."""

    def __init__(self, dim: int = 512, patch_size: int = 8, depth: int = 8, heads: int = 8,
                 dim_head: int = 64, channels: int = 3):
        super().__init__()
        self.patch_size, self.dim_head = patch_size, dim_head
        self.to_patch_embedding = nn.Linear(patch_size * patch_size * channels, dim)
        self.layers = nn.ModuleList(TimeSformerLayer(dim, heads, dim_head) for _ in range(depth))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = video.shape
        p = self.patch_size
        hp, wp = h // p, w // p
        n = hp * wp
        x = video.reshape(b, f, hp, p, wp, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.to_patch_embedding(x.reshape(b, f * n, p * p * c))
        frame_rot = rotary_frame_emb(f, self.dim_head, video.device)
        image_rot = rotary_axial_emb(hp, wp, self.dim_head, device=video.device)
        for layer in self.layers:
            x = _remat(layer, x, f, n, frame_rot, image_rot)
        return x


class Transformer(nn.Module):
    """Pre-norm ViT transformer (the per-axis class-token pooling):
    `layers.{i}.0` attention, `layers.{i}.1` GELU MLP."""

    def __init__(self, dim: int, depth: int = 4, heads: int = 4, dim_head: int = 48,
                 mlp_dim: int = 512):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim, Attention(dim, heads, dim_head)),
                           PreNorm(dim, FeedForwardMLP(dim, mlp_dim))]) for _ in range(depth))

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn.fn.out(_attend(*attn.fn.qkv(attn.norm(x))))
            x = x + ff.fn(ff.norm(x))
        return x

