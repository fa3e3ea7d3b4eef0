"""The triplane ADM UNet of DDMI's video model (`UNetModel_Triplane`, as
configured by `configs/ldm/skytimelapse.yaml`): the latent is a token
sequence [xy | xt | yt] of three planes; every stage runs the ADM UNet's
residual blocks, attention blocks and resamplers (reference/adm_unet.py,
imported) on each plane with the same weights, then a cross-plane 1D
attention (`AttnBlock1D`, the reference's MemoryEfficientAttnBlock1D) over
the tokens of all three planes: GroupNorm(32, eps 1e-6) over the tokens'
channels, q, k, v and proj_out as 1x1 projections, channels split into
heads head-major, exact softmax(q.k^T / sqrt(hd)).v.  Float32; the products
go through a `Numerics`.  State keys are the port's (the reference
checkpoints' as the port converts them): the ADM UNet's, plus
`input_attns.{i}` (index 0 holds nothing), `mid_attn` and `output_attns.{i}`.

Departures from the DDMI code: the planes are run one after another where
DDMI concatenates xt and yt on the batch axis (the same arithmetic), and the
attention takes its scores in blocks of query rows (`attention`) so that
long sequences fit, which changes no value.  In the fp8 control each block
of scores and probabilities is rounded under its own scale."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.adm_unet import UNet, group_norm, timestep_embedding
from benchmark.reference.numerics import FP32, Numerics

CROSS_PLANE_HEADS = 16
Q_BLOCK = 1024  # query rows per block of scores


def attention(q, k, v, nx: Numerics, block: int = Q_BLOCK) -> torch.Tensor:
    """softmax(q.k^T / sqrt(hd)).v over (B, nh, n, hd), `block` query rows at
    a time."""
    hd = q.shape[-1]
    kt = k.transpose(-1, -2)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for i in range(0, q.shape[-2], block):
        p = torch.softmax(nx.matmul(q[..., i : i + block, :], kt) * hd ** -0.5, dim=-1)
        out[..., i : i + block, :] = nx.matmul(p, v)
    return out


class AttnBlock1D(nn.Module):
    """x + proj_out(MHA(q, k, v of GN(x))) over (b, n, c) tokens.  With
    `expand`, q, k and v project c -> c * num_heads, every head c wide, and
    proj_out projects back (the video decoder's MemoryEfficientAttnBlock1D_
    expand)."""

    def __init__(self, channels: int, num_heads: int, expand: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = channels if expand else channels // num_heads
        inner = self.head_dim * num_heads
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.q = nn.Conv1d(channels, inner, 1)
        self.k = nn.Conv1d(channels, inner, 1)
        self.v = nn.Conv1d(channels, inner, 1)
        self.proj_out = nn.Conv1d(inner, channels, 1)

    def forward(self, x, nx: Numerics = FP32):
        B, N, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        h = group_norm(self.norm, x.transpose(1, 2)).transpose(1, 2)

        def heads(conv):
            out = nx.linear(h, conv.weight[:, :, 0], conv.bias)
            return out.reshape(B, N, nh, hd).transpose(1, 2)

        out = attention(heads(self.q), heads(self.k), heads(self.v), nx)
        out = out.transpose(1, 2).reshape(B, N, nh * hd)
        return x.float() + nx.linear(out, self.proj_out.weight[:, :, 0], self.proj_out.bias)


def split_tokens(h: torch.Tensor, shapes):
    """(b, n, c) tokens -> the NCHW planes of the given (h, w), in order."""
    b, _, c = h.shape
    out, ofs = [], 0
    for hh, ww in shapes:
        out.append(h[:, ofs : ofs + hh * ww].reshape(b, hh, ww, c).permute(0, 3, 1, 2))
        ofs += hh * ww
    return out


def cat_tokens(planes) -> torch.Tensor:
    """NCHW planes -> (b, n, c) tokens, plane after plane, row-major."""
    b, c = planes[0].shape[:2]
    return torch.cat([p.permute(0, 2, 3, 1).reshape(b, -1, c) for p in planes], dim=1)


def cross_plane(attn: AttnBlock1D, planes, nx: Numerics):
    return split_tokens(attn(cat_tokens(planes), nx), [p.shape[2:] for p in planes])


class TriplaneUNet(UNet):
    """x (b, n, in_channels) tokens [xy | xt | yt], t (b,) -> (b, n,
    out_channels) float32.  `u` is a unetconfig dict with `plane_sizes`, the
    three planes' (h, w)."""

    def __init__(self, u: dict):
        super().__init__(u)
        self.plane_sizes = [tuple(s) for s in u["plane_sizes"]]
        mc, nrb = u["model_channels"], u["num_res_blocks"]
        mults = u["channel_mult"]
        chans = [mc]
        for level, mult in enumerate(mults):
            chans += [mult * mc] * nrb
            if level != len(mults) - 1:
                chans.append(mult * mc)
        attn = lambda c: AttnBlock1D(c, CROSS_PLANE_HEADS)
        self.input_attns = nn.ModuleList([nn.Identity()] + [attn(c) for c in chans[1:]])
        self.mid_attn = attn(chans[-1])
        self.output_attns = nn.ModuleList(attn(mult * mc) for mult in reversed(mults)
                                          for _ in range(nrb + 1))

    def forward(self, x, t, nx: Numerics = FP32):
        l1, l2 = self.time_embed[0], self.time_embed[2]
        emb = nx.linear(F.silu(nx.linear(timestep_embedding(t, self.mc), l1.weight, l1.bias)),
                        l2.weight, l2.bias)
        planes, skips = split_tokens(x.float(), self.plane_sizes), []
        for i, (block, xattn) in enumerate(zip(self.input_blocks, self.input_attns)):
            planes = [block(p, emb, nx) for p in planes]
            if i:
                planes = cross_plane(xattn, planes, nx)
            skips.append(planes)
        planes = cross_plane(self.mid_attn, [self.middle_block(p, emb, nx) for p in planes], nx)
        for block, xattn in zip(self.output_blocks, self.output_attns):
            planes = [block(torch.cat([p, s], dim=1), emb, nx)
                      for p, s in zip(planes, skips.pop())]
            planes = cross_plane(xattn, planes, nx)
        conv = self.out[2]
        return cat_tokens([nx.conv2d(F.silu(group_norm(self.out[0], p)), conv.weight, conv.bias,
                                     padding=1) for p in planes])
