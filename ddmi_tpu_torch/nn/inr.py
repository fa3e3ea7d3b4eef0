"""INR heads of the sampling paths (counterpart of ddmi_tpu/nn/inr.py):
the scale-aware image head `INRImage` and the video head `INRVideo`, both on
regular grids only (the separable sampling of ops/resample.py), the
occupancy head `INR3D` at arbitrary query points with its triplane lookup
(`normalize_coordinate`, `sample_plane_coords`, `triplane_pe_add`), and the
NeRF MLP `INRNeRF` with its `FreqEmbedding`.

The state keys are the reference MLPs' (models/d2c_vae/mlp.py): for
INRImage `time_mlp.{1,3}` for the style MLP, `net_res{1..4}` and `torgb`;
for INRVideo (MLPVideo) `net_res{1..4}` and `net_out`; for INR3D (MLP3D)
`net_p`, `net_res{1..4}` and `net_out`; for INRNeRF (MLPNeRF)
`xyz_encoding_{i}.0`, `xyz_encoding_final`, `dir_encoding.0`, `sigma` and
`rgb.0`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.stylegan import (
    ResnetBlockFC,
    SinusoidalPosEmb,
    StyledResBlock,
    ToRGB,
    gelu_tanh,
)
from ddmi_tpu_torch.ops.grid_sample import grid_sample_2d
from ddmi_tpu_torch.ops.resample import separable_grid_sample


class GELUTanh(nn.Module):
    def forward(self, x):
        return gelu_tanh(x)


class INRImage(nn.Module):
    """forward(hdbf [3 x (b, latent, h, w)], si, grid_1d=(xs, ys)) ->
    (b, len(ys) * len(xs), out_ch), tokens y-major (row-major over ys, xs).
    The scale si conditions every conv through a sinusoidal style MLP and
    enters every token as `in_ch` extra channels."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        ch, in0 = cfg.ch, cfg.latent_dim + cfg.in_ch
        dim = ch // 4
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, ch), GELUTanh(), nn.Linear(ch, ch)
        )
        self.net_res1 = StyledResBlock(in0, ch, ch)
        self.net_res2 = StyledResBlock(ch + in0, ch, ch)
        self.net_res3 = StyledResBlock(ch + in0, ch, ch)
        self.net_res4 = StyledResBlock(ch, ch, ch)
        self.torgb = ToRGB(ch, cfg.out_ch, ch)

    def style(self, si, b: int, device) -> torch.Tensor:
        """The style vector (b, ch) in fp32 for scale injection si."""
        scale_inj = torch.full((b,), float(si), dtype=torch.float32, device=device)
        l1, l2 = self.time_mlp[1], self.time_mlp[3]
        h = self.time_mlp[0](scale_inj)
        h = gelu_tanh(h @ l1.weight.float().t() + l1.bias.float())
        return h @ l2.weight.float().t() + l2.bias.float()

    def forward(self, hdbf: Sequence[torch.Tensor], si,
                grid_1d: Tuple[torch.Tensor, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert len(hdbf) == 3, "expects a 3-level HDBF pyramid"
        c = self.cfg
        b = hdbf[0].shape[0]
        dtype = hdbf[0].dtype
        xs, ys = grid_1d
        n = xs.shape[0] * ys.shape[0]

        def pe(plane):
            out = separable_grid_sample(plane, xs, ys, align_corners=False,
                                        padding_mode="border")
            return out.reshape(b, n, plane.shape[1])

        style = self.style(si, b, hdbf[0].device).to(dtype)
        scale_pix = torch.full((b, n, c.in_ch), float(si), dtype=dtype, device=hdbf[0].device)
        x = torch.cat([pe(hdbf[0]), scale_pix], -1)
        x_m = torch.cat([pe(hdbf[1]), scale_pix], -1)
        x_h = torch.cat([pe(hdbf[2]), scale_pix], -1)

        x = self.net_res1(x, style, generator)
        x = self.net_res2(torch.cat([x, x_m], -1), style, generator)
        x = self.net_res3(torch.cat([x, x_h], -1), style, generator)
        x = self.net_res4(x, style, generator)
        return self.torgb(x, style)


def triplane_pe_concat_video(planes: Sequence[torch.Tensor],
                             axes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                             ) -> torch.Tensor:
    """Voxel features from the xy / yt / xt planes (NCHW) on the regular grid
    axes = (ts, ys, xs): each plane sampled bilinearly (align_corners=True,
    border), broadcast and concatenated -> (b, t * h * w, 3c), tokens
    t-major, then y, then x.  The yt and xt planes are sampled with the t
    values on their W axis and the y / x values on their H axis, as the
    reference's coordinate dicts do (ddmi_tpu/nn/inr.py).  Sampling runs in
    fp32, as the JAX package's fp32 interpolation matrices make it."""
    xy, yt, xt = (p.float() for p in planes)
    ts, ys, xs = axes
    b, c = xy.shape[:2]
    t, h, w = ts.shape[0], ys.shape[0], xs.shape[0]
    f_xy = separable_grid_sample(xy, xs, ys, align_corners=True)           # (b, h, w, c)
    f_yt = separable_grid_sample(yt, ts, ys, align_corners=True).transpose(1, 2)  # (b, t, h, c)
    f_xt = separable_grid_sample(xt, ts, xs, align_corners=True).transpose(1, 2)  # (b, t, w, c)
    shape = (b, t, h, w, c)
    out = torch.cat([
        f_xy[:, None].expand(shape),
        f_yt[:, :, :, None].expand(shape),
        f_xt[:, :, None].expand(shape),
    ], dim=-1)
    return out.reshape(b, t * h * w, 3 * c)


class INRVideo(nn.Module):
    """forward(hdbf = (xy, yt, xt) pyramids of 3 NCHW planes each, axes =
    (ts, ys, xs)) -> (b, t * h * w, out_ch).  Runs in the parameters'
    dtype."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        ch, in0 = cfg.ch, 3 * cfg.latent_dim
        self.net_res1 = ResnetBlockFC(in0, ch)
        self.net_res2 = ResnetBlockFC(ch + in0, ch)
        self.net_res3 = ResnetBlockFC(ch + in0, ch)
        self.net_res4 = ResnetBlockFC(ch)
        self.net_out = nn.Linear(ch, cfg.out_ch)

    def forward(self, hdbf, axes) -> torch.Tensor:
        xy, yt, xt = hdbf
        assert len(xy) == 3, "expects 3-level HDBF pyramids"
        dtype = self.net_out.weight.dtype
        x, x_m, x_h = (
            triplane_pe_concat_video((xy[i], yt[i], xt[i]), axes).to(dtype) for i in range(3)
        )
        x = self.net_res1(x)
        x = self.net_res2(torch.cat([x, x_m], -1))
        x = self.net_res3(torch.cat([x, x_h], -1))
        x = self.net_res4(x)
        return self.net_out(F.leaky_relu(x, 0.2))


_PLANE_AXES = {"xz": [0, 2], "xy": [0, 1], "yz": [1, 2]}


def normalize_coordinate(p: torch.Tensor, padding: float = 0.1,
                         plane: str = "xz") -> torch.Tensor:
    """3D points (..., 3) projected onto `plane` and mapped to [0, 1):
    divided by 1 + padding + 10e-6, shifted by 0.5, clipped to
    [0, 1 - 10e-6] (the reference's constants, 10e-6 being 1e-5), in fp32."""
    xy = p.float()[..., _PLANE_AXES[plane]]
    xy = xy / (1 + padding + 10e-6) + 0.5
    return xy.clamp(0.0, 1 - 10e-6)


def sample_plane_coords(p: torch.Tensor, plane: str) -> torch.Tensor:
    """3D points -> [-1, 1] grid coordinates on one plane."""
    return 2.0 * normalize_coordinate(p, plane=plane) - 1.0


def triplane_pe_add(planes: Sequence[torch.Tensor],
                    coords: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 3D path's positional encoding: the sum of three bilinear plane
    samples (align_corners=True, border).  planes: three NCHW planes (b, c,
    H, W); coords: three (b, n, 2) grid coordinates -> (b, n, c) in the
    planes' dtype, summed in it as the JAX package sums."""
    out = None
    for plane, c in zip(planes, coords):
        f = grid_sample_2d(plane.permute(0, 2, 3, 1), c)
        out = f if out is None else out + f
    return out


def promoted_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer` applied in the promotion of x's and its weight's dtypes, as
    flax's Dense promotes: bf16 weights on fp32 inputs compute in fp32."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def promoted_resnet_fc(block: ResnetBlockFC, x: torch.Tensor) -> torch.Tensor:
    """ResnetBlockFC with flax's dtype promotion (see `promoted_linear`)."""
    dx = promoted_linear(block.fc_1, F.relu(promoted_linear(block.fc_0, F.relu(x))))
    return (x if block.shortcut is None else promoted_linear(block.shortcut, x)) + dx


class INR3D(nn.Module):
    """The occupancy head: forward(coords (b, n, 3) fp32, hdbf = (xy, yz,
    xz) pyramids of 3 NCHW planes each, coarse to fine) -> logits (b, n).

    The dtypes follow the JAX module's promotion.  The plane samples and
    `net_res1` run in the planes' dtype; `net_p` runs on the fp32
    coordinates, so under bf16 parameters its output, `p + net_res1(x)`
    and every layer after it are fp32 with bf16-valued weights."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        ch, lat = cfg.ch, cfg.latent_dim
        self.net_p = nn.Linear(3, ch)
        self.net_res1 = ResnetBlockFC(lat, ch)
        self.net_res2 = ResnetBlockFC(ch + lat, ch)
        self.net_res3 = ResnetBlockFC(ch + lat, ch)
        self.net_res4 = ResnetBlockFC(ch)
        self.net_out = nn.Linear(ch, cfg.out_ch)

    def forward(self, coords: torch.Tensor, hdbf) -> torch.Tensor:
        xy, yz, xz = hdbf
        assert len(xy) == 3, "expects 3-level HDBF pyramids"
        coords = coords.float()
        cs = [sample_plane_coords(coords, k) for k in ("xy", "yz", "xz")]
        x, x_m, x_h = (triplane_pe_add((xy[i], yz[i], xz[i]), cs) for i in range(3))
        x = promoted_linear(self.net_p, coords) + promoted_resnet_fc(self.net_res1, x)
        x = promoted_resnet_fc(self.net_res2, torch.cat([x, x_m.to(x.dtype)], -1))
        x = promoted_resnet_fc(self.net_res3, torch.cat([x, x_h.to(x.dtype)], -1))
        x = promoted_resnet_fc(self.net_res4, x)
        return promoted_linear(self.net_out, x).squeeze(-1)


class FreqEmbedding(nn.Module):
    """NeRF frequency embedding x -> [x, sin(2^0 x), cos(2^0 x), ...,
    sin(2^(n-1) x), cos(2^(n-1) x)], interleaved per frequency, in fp32."""

    def __init__(self, n_freqs: int):
        super().__init__()
        self.n_freqs = n_freqs

    def out_dim(self, in_dim: int = 3) -> int:
        return in_dim * (2 * self.n_freqs + 1)

    def forward(self, x):
        x = x.float()
        out = [x]
        for k in range(self.n_freqs):
            out += [torch.sin(2.0**k * x), torch.cos(2.0**k * x)]
        return torch.cat(out, dim=-1)


class INRNeRF(nn.Module):
    """The NeRF MLP: `depth` layers of width `width` with LeakyReLU 0.01 (the
    JAX package's slope; the reference's LeakyReLU(True) acts as slope 1),
    the xyz input concatenated in front of h before each layer in `skips`, a
    sigma head, and a view-conditioned rgb head.  x (..., in_xyz + in_dir)
    -> (..., 4) [sigmoid(rgb), sigma] in the parameters' dtype."""

    def __init__(self, depth: int = 8, width: int = 256, in_channels_xyz: int = 96,
                 in_channels_dir: int = 27, skips=(2, 4, 6)):
        super().__init__()
        self.depth, self.width = depth, width
        self.in_channels_xyz, self.in_channels_dir = in_channels_xyz, in_channels_dir
        self.skips = tuple(skips)
        for i in range(depth):
            fan_in = (in_channels_xyz if i == 0 else width) + (
                in_channels_xyz if i in self.skips else 0)
            layer = nn.Sequential(nn.Linear(fan_in, width), nn.LeakyReLU(0.01))
            setattr(self, f"xyz_encoding_{i + 1}", layer)
        self.xyz_encoding_final = nn.Linear(width, width)
        self.dir_encoding = nn.Sequential(
            nn.Linear(width + in_channels_dir, width // 2), nn.LeakyReLU(0.01))
        self.sigma = nn.Linear(width, 1)
        self.rgb = nn.Sequential(nn.Linear(width // 2, 3), nn.Sigmoid())

    def forward(self, x):
        x = x.to(self.sigma.weight.dtype)
        input_xyz = x[..., : self.in_channels_xyz]
        input_dir = x[..., self.in_channels_xyz :]
        h = input_xyz
        for i in range(self.depth):
            if i in self.skips:
                h = torch.cat([input_xyz, h], dim=-1)
            h = getattr(self, f"xyz_encoding_{i + 1}")(h)
        sigma = self.sigma(h)
        feat = self.xyz_encoding_final(h)
        rgb = self.rgb(self.dir_encoding(torch.cat([feat, input_dir], dim=-1)))
        return torch.cat([rgb, sigma], dim=-1)
