"""The context-conditioned spatial transformer of the UNet
(`unetconfig.use_spatial_transformer`; counterpart of
ddmi_tpu/nn/transformer.py).

Module tree and state keys follow the original LDM `attention.py`:
`norm` (GroupNorm, eps 1e-6), `proj_in` and `proj_out` (1x1 Conv2ds,
`proj_out` zero-initialised so that a new block is the identity), and
`transformer_blocks.i` with `norm1`-`norm3` (affine LayerNorms, eps 1e-6),
`attn1` (self-attention), `attn2` (attention to the context; to itself
when the context is None) with `to_q`, `to_k`, `to_v` (no bias) and
`to_out.0`, and the gated feed-forward `ff.net.0.proj` (GEGLU, exact GELU)
and `ff.net.2`.  Attention is dense: scores in the input dtype times the
scale, an fp32 softmax cast back to the values' dtype, then P.V; it
launches no kernel.  Dropout is inactive, as in the JAX module's
deterministic apply.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU(dim -> mult dim), then Linear back to dim; `net.1` is the
    (inactive) dropout."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def forward(self, x, context=None):
        ctx = x if context is None else context.to(x.dtype)
        h = self.heads
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        B, n, inner = q.shape
        d = inner // h
        q = q.reshape(B, n, h, d).transpose(1, 2)
        k = k.reshape(B, -1, h, d).transpose(1, 2)
        v = v.reshape(B, -1, h, d).transpose(1, 2)
        sim = (q @ k.transpose(-1, -2)).float() * d**-0.5
        out = torch.softmax(sim, dim=-1).to(v.dtype) @ v
        return self.to_out(out.transpose(1, 2).reshape(B, n, inner))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attention -> LN -> attention to the context -> LN -> gated
    feed-forward, each residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """x (B, C, H, W), context (B, m, context_dim) or None -> x + the
    transformer's output: GroupNorm, 1x1 in-projection, `depth`
    BasicTransformerBlocks over the H W tokens, zero-initialised 1x1
    out-projection."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)])
        self.proj_out = nn.Conv2d(inner, in_channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.transpose(1, 2).reshape(B, -1, H, W)
        return x + self.proj_out(h)
