"""Triplane ADM UNet for video latent diffusion (counterpart of
ddmi_tpu/nn/unet_triplane.py).

The input is a token sequence [xy | xt | yt] of three latent planes.  Every
UNet stage runs the same 2D ResBlock / attention / resample weights on each
plane, then a cross-plane 1D attention over all tokens.  State keys follow
the reference UNetModel_Triplane: the ADM UNet's (nn/unet.py) plus
`input_attns.{i}` (index 0 has no parameters), `mid_attn` and
`output_attns.{i}`.

Planes are NCHW views of the token rows with channels-last strides, so the
convolutions take cuDNN's fast layout on the card and the attention kernels'
token views are free.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ddmi_tpu_torch.core.tracing import span
from ddmi_tpu_torch.nn.attention1d import AttnBlock1D
from ddmi_tpu_torch.nn.unet import UNet, timestep_embedding

CROSS_PLANE_HEADS = 16


def split_tokens(h: torch.Tensor, shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """(b, n, c) -> three NCHW planes of the given (h, w)."""
    b, _, c = h.shape
    out, ofs = [], 0
    for hh, ww in shapes:
        out.append(h[:, ofs : ofs + hh * ww].reshape(b, hh, ww, c).permute(0, 3, 1, 2))
        ofs += hh * ww
    return out


def cat_tokens(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """NCHW planes -> (b, n, c) tokens, plane after plane, row-major."""
    b, c = planes[0].shape[:2]
    return torch.cat([p.permute(0, 2, 3, 1).reshape(b, -1, c) for p in planes], dim=1)


def plane_map(fn, planes, emb=None):
    """Apply a shared-weight module to each plane, with xt and yt stacked on
    the batch axis into one call when their shapes match (every repo config:
    sky 32/32/16 gives xt, yt both (16, 32)), as the JAX package does."""
    xy, xt, yt = planes
    if xt.shape == yt.shape:
        st = torch.cat([xt, yt], dim=0)
        if emb is not None:
            o_xy, o_st = fn(xy, emb), fn(st, torch.cat([emb, emb], dim=0))
        else:
            o_xy, o_st = fn(xy), fn(st)
        b = xt.shape[0]
        return [o_xy, o_st[:b], o_st[b:]]
    if emb is not None:
        return [fn(p, emb) for p in planes]
    return [fn(p) for p in planes]


def cross_plane(attn: nn.Module, planes):
    """A 1D attention over the tokens of all three planes."""
    shapes = [p.shape[2:] for p in planes]
    return split_tokens(attn(cat_tokens(planes)), shapes)


class TriplaneUNet(UNet):
    """x (b, n, c_in) tokens [xy | xt | yt], t (b,) -> (b, n, c_out) fp32.
    cfg.plane_sizes gives the three planes' (h, w).  `cache=` and
    `return_cache=` split it as they split the UNet, with the cache
    (planes, skips) after the down path and its cross-plane attentions.
    Its ResBlocks take `use_scale_shift_norm`, as the JAX TriplaneUNet's;
    it has no context or label path (the JAX module builds neither), so a
    config that asks for one is refused."""

    def __init__(self, cfg):
        if cfg.use_spatial_transformer or cfg.num_classes is not None:
            raise ValueError("the triplane UNet takes no spatial transformer and no class "
                             "labels (unetconfig.use_spatial_transformer / num_classes)")
        super().__init__(cfg)
        if len(cfg.plane_sizes) != 3:
            raise ValueError("plane_sizes must give 3 (h, w) pairs")
        mc = cfg.model_channels
        chans = [mc]
        for level, mult in enumerate(cfg.channel_mult):
            chans += [mult * mc] * cfg.num_res_blocks
            if level != len(cfg.channel_mult) - 1:
                chans.append(mult * mc)
        self.input_attns = nn.ModuleList(
            [nn.Identity()] + [AttnBlock1D(c, CROSS_PLANE_HEADS) for c in chans[1:]]
        )
        self.mid_attn = AttnBlock1D(chans[-1], CROSS_PLANE_HEADS)
        self.output_attns = nn.ModuleList(
            AttnBlock1D(mult * mc, CROSS_PLANE_HEADS)
            for mult in reversed(cfg.channel_mult)
            for _ in range(cfg.num_res_blocks + 1)
        )

    def forward(self, x, t, *, cache=None, return_cache: bool = False):
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(t, self.cfg.model_channels).to(dtype))
        if cache is not None:
            planes, skips = list(cache[0]), [list(s) for s in cache[1]]
        else:
            planes = split_tokens(x.to(dtype), [tuple(s) for s in self.cfg.plane_sizes])
            skips = []
            for i, (module, xattn) in enumerate(zip(self.input_blocks, self.input_attns)):
                planes = plane_map(module, planes, emb)
                if i:
                    planes = cross_plane(xattn, planes)
                skips.append(planes)
        out_cache = (tuple(planes), tuple(tuple(s) for s in skips))
        planes = cross_plane(self.mid_attn, plane_map(self.middle_block, planes, emb))
        for module, xattn in zip(self.output_blocks, self.output_attns):
            planes = [torch.cat([p, s], dim=1) for p, s in zip(planes, skips.pop())]
            planes = cross_plane(xattn, plane_map(module, planes, emb))
        conv = self.out[2]

        def head(p):
            with span("sampler.norm"):
                h = self.out[1](self.out[0](p))
            return torch.nn.functional.conv2d(h.float(), conv.weight.float(),
                                              conv.bias.float(), padding=1)

        out = cat_tokens(plane_map(head, planes))
        return (out, out_cache) if return_cache else out
