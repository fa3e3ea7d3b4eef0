"""The video INR of DDMI (`MLPVideo` with `triplane_pe_concat_video`): each
pixel of a frame takes, from each level of the three HDBF pyramids, the xy
plane sampled at its (x, y), the yt plane at (t, y) and the xt plane at (t,
x), bilinearly (align_corners=True, border), concatenated over the planes;
the coarsest level's features enter `net_res1`, the middle level's are
concatenated before `net_res2` and the finest's before `net_res3`; then
`net_res4` and, after a LeakyReLU(0.2), the linear `net_out`.  Each residual
block is fc_1(relu(fc_0(relu(x)))) plus x or its bias-free `shortcut`.  The
coordinates are the pixel centres, (n - 1) / n at the ends, as DDMI passes
them at sampling time; the time planes, (frames, r) as NCHW, take t on their
width axis and y or x on their height axis, as DDMI's coordinate dicts do.
Float32; the products go through a `Numerics`.  State keys are the port's
(the reference's `net_res{1..4}.{fc_0, fc_1, shortcut}`, `net_out`).

Departure from the DDMI code: one frame at a time (DDMI renders the whole
clip in one call), which changes no value."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.numerics import FP32, Numerics


def pixel_centres(n: int, device=None) -> torch.Tensor:
    e = (n - 1) / n
    return torch.linspace(-e, e, n, dtype=torch.float32, device=device)


def sample(plane, xs, ys) -> torch.Tensor:
    """An NCHW plane sampled at the grid ys (height) x xs (width) ->
    (b, len(ys), len(xs), c)."""
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    grid = torch.stack([gx, gy], dim=-1)[None].expand(plane.shape[0], -1, -1, -1)
    return F.grid_sample(plane.float(), grid, mode="bilinear", padding_mode="border",
                         align_corners=True).permute(0, 2, 3, 1)


def frame_features(xy, yt, xt, t, ys, xs) -> torch.Tensor:
    """One level's features of the pixels of the frame at time t (a (1,)
    tensor) -> (b, h * w, 3c), rows y-major."""
    f_xy = sample(xy, xs, ys)                        # (b, h, w, c)
    f_yt = sample(yt, t, ys)                         # (b, h, 1, c)
    f_xt = sample(xt, t, xs).permute(0, 2, 1, 3)     # (b, 1, w, c)
    b, h, w, c = f_xy.shape
    out = torch.cat([f_xy, f_yt.expand(b, h, w, c), f_xt.expand(b, h, w, c)], dim=-1)
    return out.reshape(b, h * w, 3 * c)


class ResnetBlockFC(nn.Module):
    def __init__(self, size_in: int, size_out: int = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = nn.Linear(size_in, size_out, bias=False) if size_in != size_out else None

    def forward(self, x, nx: Numerics):
        h = nx.linear(F.relu(x), self.fc_0.weight, self.fc_0.bias)
        dx = nx.linear(F.relu(h), self.fc_1.weight, self.fc_1.bias)
        return (x if self.shortcut is None else nx.linear(x, self.shortcut.weight)) + dx


class INRVideo(nn.Module):
    """`m` is an mlpconfig dict: ch, latent_dim, out_ch."""

    def __init__(self, m: dict):
        super().__init__()
        ch, in0 = m["ch"], 3 * m["latent_dim"]
        self.net_res1 = ResnetBlockFC(in0, ch)
        self.net_res2 = ResnetBlockFC(ch + in0, ch)
        self.net_res3 = ResnetBlockFC(ch + in0, ch)
        self.net_res4 = ResnetBlockFC(ch)
        self.net_out = nn.Linear(ch, m["out_ch"])

    def forward(self, hdbf, frame: int, frames: int, res: int, nx: Numerics = FP32):
        """hdbf = the (xy, yt, xt) pyramids of one or more samples; one
        frame -> (b, res * res, out_ch), not clipped."""
        xy, yt, xt = hdbf
        dev = xy[0].device
        t = pixel_centres(frames, dev)[frame : frame + 1]
        ys = xs = pixel_centres(res, dev)
        x, x_m, x_h = (frame_features(xy[i], yt[i], xt[i], t, ys, xs) for i in range(3))
        x = self.net_res1(x, nx)
        x = self.net_res2(torch.cat([x, x_m], -1), nx)
        x = self.net_res3(torch.cat([x, x_h], -1), nx)
        x = self.net_res4(x, nx)
        return nx.linear(F.leaky_relu(x, 0.2), self.net_out.weight, self.net_out.bias)
