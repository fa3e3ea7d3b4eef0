"""The decode half of DDMI's video D2C-VAE (`VITAutoencoder.decode` with
`VideoDecoder_light`, as configured by `configs/d2c-vae/skytimelapse.yaml`):
the latent tokens [xy | xt | yt] are projected per plane (`post_xy`,
`post_xt`, `post_yt`, 1x1) to NCHW planes, xy (r, r) and xt, yt (frames,
r); every layer of the decoder runs on each plane with the same weights,
and the planes mix through a cross-plane expanded attention
(`AttnBlock1DExpand`, the reference's MemoryEfficientAttnBlock1D_expand: 8
heads, each as wide as the channels) after the middle block and at each of
`inter_attn_resolutions`.  The xy plane is upsampled by 2 on both axes, the
time planes on their width alone.  Out come the HDBF pyramids (xy, yt, xt),
coarse to fine: a 1x1 tap at each of `hdbf_resolutions` and the 3x3 output
conv.  Float32; the products go through a `Numerics`.  State keys are the
port's: `post_{xy,xt,yt}`, `decoder.*`.

The residual blocks and the level layout are reference/ldm_decoder.py's;
the middle self-attention (`attn_type` vanilla-multihead) splits its
channels into 16 heads head-major.  Departures from the DDMI code: the
planes are run one after another where DDMI stacks the time planes on the
batch axis (the same arithmetic), and every attention takes its scores in
blocks of query rows (reference/triplane_unet.py::attention), so that the
73,728 tokens of a 256^2 x 16 clip fit in float32."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from benchmark.reference.adm_unet import group_norm
from benchmark.reference.ldm_decoder import AttnBlock, Norm, ResnetBlock, _levels, conv
from benchmark.reference.numerics import FP32, Numerics
from benchmark.reference.triplane_unet import AttnBlock1D, attention, cross_plane

XATTN_HEADS = 8
# the upsampling factors of the planes xy, xt, yt: the t axis is never upsampled
SCALES = ((2, 2), (1, 2), (1, 2))


class MultiheadAttnBlock(AttnBlock):
    """Spatial self-attention with 1x1 q, k, v and proj convs, its channels
    split into `num_heads` heads head-major (one head: ldm_decoder's)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__(c)
        self.num_heads = num_heads

    def forward(self, x, nx: Numerics):
        B, C, H, W = x.shape
        nh, n = self.num_heads, H * W
        h = group_norm(self.norm, x)
        q, k, v = (conv(nx, m, h).reshape(B, nh, C // nh, n).transpose(-1, -2)
                   for m in (self.q, self.k, self.v))
        out = attention(q, k, v, nx).transpose(-1, -2).reshape(B, C, H, W)
        return x + conv(nx, self.proj_out, out)


def heads_of(attn_type: str) -> int:
    if attn_type not in ("vanilla", "vanilla-multihead"):
        raise NotImplementedError(f"attn_type {attn_type!r}")
    return 16 if attn_type == "vanilla-multihead" else 1


class VideoDecoder(nn.Module):
    """z (b, r * r + 2 * frames * r, embed_dim) tokens [xy | xt | yt] ->
    (hdbf_xy, hdbf_yt, hdbf_xt), each a list of NCHW planes coarse to fine.
    `dd` is a ddconfig dict."""

    def __init__(self, dd: dict, embed_dim: int, frames: int):
        super().__init__()
        self.r, self.frames = dd["resolution"] // 8, frames
        for plane in ("xy", "xt", "yt"):
            setattr(self, f"post_{plane}", nn.Conv2d(embed_dim, dd["z_channels"], 1))
        heads = heads_of(dd["attn_type"])
        dec = nn.Module()
        block_in = dd["ch"] * dd["ch_mult"][-1]
        dec.conv_in = nn.Conv2d(dd["z_channels"], block_in, 3, padding=1)
        dec.mid = nn.Module()
        dec.mid.block_1 = ResnetBlock(block_in, block_in)
        dec.mid.attn_1 = MultiheadAttnBlock(block_in, heads)
        dec.mid.block_2 = ResnetBlock(block_in, block_in)
        dec.mid_attn = AttnBlock1D(block_in, XATTN_HEADS, expand=True)
        up, block_in = _levels(dd, inter=False)
        for i, lvl in enumerate(up):
            c = lvl.block[-1].conv2.out_channels
            lvl.attn = nn.ModuleList(MultiheadAttnBlock(c, heads) for _ in lvl.attn)
            lvl.inter_attn = (nn.ModuleList([AttnBlock1D(c, XATTN_HEADS, expand=True)])
                              if dd["resolution"] // 2 ** i in dd["inter_attn_resolutions"]
                              else None)
        dec.up = nn.ModuleList(up)
        dec.norm_out = Norm(block_in)
        dec.conv_out = nn.Conv2d(block_in, dd["out_ch"], 3, padding=1)
        self.decoder = dec

    def forward(self, z, nx: Numerics = FP32):
        r, t, b, d = self.r, self.frames, z.shape[0], self.decoder
        z = z.float()

        def post(layer, tok, h, w):
            out = nx.linear(tok, layer.weight[:, :, 0, 0], layer.bias)
            return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)

        planes = [post(self.post_xy, z[:, : r * r], r, r),
                  post(self.post_xt, z[:, r * r : r * (r + t)], t, r),
                  post(self.post_yt, z[:, r * (r + t) :], t, r)]
        planes = [conv(nx, d.conv_in, p, padding=1) for p in planes]
        planes = [d.mid.block_2(d.mid.attn_1(d.mid.block_1(p, nx), nx), nx) for p in planes]
        planes = cross_plane(d.mid_attn, planes, nx)
        taps = ([], [], [])
        for i in reversed(range(len(d.up))):
            lvl = d.up[i]
            for j, blk in enumerate(lvl.block):
                planes = [blk(p, nx) for p in planes]
                if len(lvl.attn):
                    planes = [lvl.attn[j](p, nx) for p in planes]
            if lvl.inter_attn is not None:
                planes = cross_plane(lvl.inter_attn[0], planes, nx)
            if lvl.hdbf is not None:
                for tap, p in zip(taps, planes):
                    tap.append(conv(nx, lvl.hdbf[0], p))
            if lvl.upsample is not None:
                planes = [conv(nx, lvl.upsample.conv,
                               F.interpolate(p, scale_factor=s, mode="nearest"), padding=1)
                          for p, s in zip(planes, SCALES)]
        for tap, p in zip(taps, planes):
            tap.append(conv(nx, d.conv_out, F.silu(group_norm(d.norm_out, p)), padding=1))
        hdbf_xy, hdbf_xt, hdbf_yt = taps
        return hdbf_xy, hdbf_yt, hdbf_xt
