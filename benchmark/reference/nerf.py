"""The NeRF render of DDMI's srn_cars configs: pixel rays of a spherical
camera path, evenly spaced samples in [near, far] (no perturbation when
sampling), triplane features bilinearly sampled (align_corners=True,
border) at pts / 3.5 on the xy, yz and xz planes, frequency embeddings of
the points and view directions, the NeRF MLP (LeakyReLU 0.01, the xyz input
concatenated in front of h at the skip layers, a sigma head and a
view-conditioned sigmoid rgb head) and alpha compositing with softplus
density on a white background.  Float32; the MLP's products go through a
`Numerics`.  State keys are the reference checkpoints' (`xyz_encoding_{i}.0`,
`xyz_encoding_final`, `dir_encoding.0`, `sigma`, `rgb.0`)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.numerics import FP32, Numerics

FOV = 0.6911112070083618   # srn_cars' field of view (radians)
NEAR, FAR = 2.0, 6.0


def poses(n_views: int, radius: float = 1.3, elevation: float = -0.3) -> np.ndarray:
    """(n_views, 4, 4) camera-to-world matrices around the origin."""
    out = []
    for theta in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        cam = np.array([radius * np.cos(theta), radius * np.sin(theta), -radius * elevation])
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, -fwd, cam
        out.append(m)
    return np.stack(out).astype(np.float32)


def rays(H: int, W: int, c2w: torch.Tensor):
    """(H * W, 3) origins and directions, pixels row-major."""
    f = 0.5 * W / math.tan(0.5 * FOV)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                          torch.arange(W, dtype=torch.float32, device=c2w.device), indexing="ij")
    d = torch.stack([(i - 0.5 * W) / f, -(j - 0.5 * H) / f, -torch.ones_like(i)], -1)
    d = (d @ c2w[:3, :3].t()).reshape(-1, 3)
    return c2w[:3, 3].expand(d.shape), d


def embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    out = [x]
    for k in range(n_freqs):
        out += [torch.sin(2.0 ** k * x), torch.cos(2.0 ** k * x)]
    return torch.cat(out, -1)


def triplane_features(planes: dict, pts: torch.Tensor) -> torch.Tensor:
    """planes {"xy", "yz", "xz"} (1, c, R, R), pts (n, 3) -> (n, 3c)."""
    p = pts / 3.5
    feats = []
    for key, (a, b) in (("xy", (0, 1)), ("yz", (1, 2)), ("xz", (0, 2))):
        grid = torch.stack([p[:, a], p[:, b]], -1)[None, None]          # (1, 1, n, 2)
        f = F.grid_sample(planes[key].float(), grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
        feats.append(f[0, :, 0].t())
    return torch.cat(feats, -1)


class NeRFMLP(nn.Module):
    def __init__(self, depth: int, width: int, in_xyz: int, in_dir: int, skips):
        super().__init__()
        self.depth, self.in_xyz, self.skips = depth, in_xyz, tuple(skips)
        for i in range(depth):
            fan_in = (in_xyz if i == 0 else width) + (in_xyz if i in self.skips else 0)
            setattr(self, f"xyz_encoding_{i + 1}", nn.Sequential(nn.Linear(fan_in, width)))
        self.xyz_encoding_final = nn.Linear(width, width)
        self.dir_encoding = nn.Sequential(nn.Linear(width + in_dir, width // 2))
        self.sigma = nn.Linear(width, 1)
        self.rgb = nn.Sequential(nn.Linear(width // 2, 3))

    def forward(self, x, nx: Numerics = FP32):
        """x (n, in_xyz + in_dir) -> (n, 4): sigmoid rgb, raw sigma."""
        lin = lambda layer, h: nx.linear(h, layer.weight, layer.bias)
        xyz, d = x[:, : self.in_xyz], x[:, self.in_xyz :]
        h = xyz
        for i in range(self.depth):
            if i in self.skips:
                h = torch.cat([xyz, h], -1)
            h = F.leaky_relu(lin(getattr(self, f"xyz_encoding_{i + 1}")[0], h), 0.01)
        sigma = lin(self.sigma, h)
        feat = lin(self.xyz_encoding_final, h)
        h = F.leaky_relu(lin(self.dir_encoding[0], torch.cat([feat, d], -1)), 0.01)
        return torch.cat([torch.sigmoid(lin(self.rgb[0], h)), sigma], -1)


def render_rays(mlp: NeRFMLP, planes: dict, o, d, n_samples: int, multires: int,
                multires_views: int, nx: Numerics = FP32) -> torch.Tensor:
    """(n, 3) rays -> (n, 3) composited rgb on a white background."""
    n = o.shape[0]
    t = torch.linspace(0.0, 1.0, n_samples, device=o.device)
    z = (NEAR * (1 - t) + FAR * t).expand(n, n_samples)
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    e_dir = embed(vd, multires_views)[:, None].expand(n, n_samples, -1).reshape(n * n_samples, -1)
    x = torch.cat([triplane_features(planes, pts), embed(pts, multires), e_dir], -1)
    raw = mlp(x, nx).reshape(n, n_samples, 4)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(d, dim=-1)[:, None]
    alpha = 1.0 - torch.exp(-F.softplus(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1),
                          -1)[:, :-1]
    w = alpha * trans
    return (w[..., None] * raw[..., :3]).sum(1) + (1.0 - w.sum(-1))[:, None]
