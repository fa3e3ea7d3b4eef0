"""PointNet++ encoder (counterpart of ddmi_tpu/nn/pointnetpp.py): set
abstractions (farthest-point sampling, ball query, a shared MLP, a max over
each group) and feature propagations (3-NN inverse-distance
interpolation, a shared MLP), with the reference's layer plan:
SA(512, r 0.2, k 32, [64, 64, 128]) -> SA(128, r 0.4, k 64, [128, 128, 256])
-> SA(all, [256, 512, 1024]) -> FP[256, 256] -> FP[256, 128] ->
FP[128, 128, c_dim].  Channels last, (b, n, c), as in JAX.

The JAX package's choices, kept:
  * farthest-point sampling starts at point 0 (the reference draws the
    start at random), and each step takes the first index of the largest
    distance to the chosen set;
  * a ball query takes the nsample lowest indices within the radius and
    pads a short group with its first member;
  * normalisation uses the batch's statistics over every axis but the
    channels, with no running averages; its parameters are `weight`
    (ones) and `bias` (zeros).
Plain PyTorch, fp32: JAX computes the encoder outside any Pallas kernel.
State keys: `sa{1,2,3}.mlps.{i}` (Linear), `sa{1,2,3}.bns.{i}`,
`fp{3,2,1}.mlps.{i}`, `fp{3,2,1}.bns.{i}`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances -2 a.b + |a|^2 + |b|^2: (b, n, c), (b, m,
    c) -> (b, n, m).  The dot products and the squared norms are summed
    over the coordinates in the same order, so a point at the same place as
    another is at distance 0 exactly (as JAX's are), never at a rounding of
    either sign that the feature propagation's 1 / (d + 1e-8) would blow up."""
    dot = ns = nd = 0.0
    for c in range(src.shape[-1]):
        a, b = src[..., c], dst[..., c]
        dot = dot + a[:, :, None] * b[:, None, :]
        ns, nd = ns + a * a, nd + b * b
    return -2.0 * dot + ns[:, :, None] + nd[:, None, :]


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of points (b, n, c) at idx (b, ...) -> (b, ..., c)."""
    b = points.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy farthest-point sampling from point 0: (b, n, 3) -> (b, npoint)
    int64 indices."""
    b, n, _ = xyz.shape
    cents = torch.zeros((b, npoint), dtype=torch.long, device=xyz.device)
    mind = torch.full((b, n), float("inf"), dtype=torch.float32, device=xyz.device)
    far = torch.zeros((b,), dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        cents[:, i] = far
        centroid = torch.gather(xyz, 1, far[:, None, None].expand(-1, 1, xyz.shape[-1]))
        mind = torch.minimum(mind, ((xyz - centroid) ** 2).sum(-1).float())
        far = torch.argmax(mind, -1)
    return cents


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """The nsample lowest indices of the points within `radius` of each
    query, a short group padded with its first: (b, n, 3), (b, s, 3) ->
    (b, s, nsample) int64."""
    n = xyz.shape[1]
    sqr = square_distance(new_xyz, xyz)
    ar = torch.arange(n, device=xyz.device).expand_as(sqr)
    key = torch.where(sqr > radius ** 2, torch.full_like(ar, n), ar)
    group = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
    return torch.where(group == n, group[:, :, :1], group)


class BatchStatNorm(nn.Module):
    """(x - mean) / sqrt(var + 1e-5) * weight + bias, the mean and the
    (biased) variance over every axis but the last, of this batch."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axes, keepdim=True)
        var = x.var(axes, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


class _SharedMLP(nn.Module):
    def __init__(self, in_ch: int, mlp: Sequence[int]):
        super().__init__()
        widths = [in_ch, *mlp]
        self.mlps = nn.ModuleList([nn.Linear(a, c) for a, c in zip(widths, widths[1:])])
        self.bns = nn.ModuleList([BatchStatNorm(c) for c in mlp])

    def run_mlp(self, h):
        for lin, bn in zip(self.mlps, self.bns):
            h = F.relu(bn(lin(h)))
        return h


class PointNetSetAbstraction(_SharedMLP):
    """forward(xyz (b, n, 3), feats (b, n, d) or None) -> (new_xyz (b, s,
    3), new_feats (b, s, mlp[-1])); group_all pools every point into one
    group at the origin."""

    def __init__(self, npoint: Optional[int], radius: Optional[float], nsample: Optional[int],
                 in_ch: int, mlp: Sequence[int], group_all: bool = False):
        super().__init__(in_ch, mlp)
        self.npoint, self.radius, self.nsample, self.group_all = npoint, radius, nsample, group_all

    def forward(self, xyz, feats):
        if self.group_all:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, xyz.shape[2]))
            grouped = xyz[:, None]
            if feats is not None:
                grouped = torch.cat([grouped, feats[:, None]], -1)
        else:
            new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if feats is not None:
                grouped = torch.cat([grouped, index_points(feats, idx)], -1)
        return new_xyz, self.run_mlp(grouped).amax(2)


class PointNetFeaturePropagation(_SharedMLP):
    """forward(xyz1 (b, n, 3) dense, xyz2 (b, s, 3) sparse, feats1 (b, n,
    d1) or None, feats2 (b, s, d2)) -> (b, n, mlp[-1])."""

    def forward(self, xyz1, xyz2, feats1, feats2):
        n, s = xyz1.shape[1], xyz2.shape[1]
        if s == 1:
            interp = feats2.expand(-1, n, -1)
        else:
            d, idx = torch.topk(square_distance(xyz1, xyz2), 3, dim=-1, largest=False,
                                sorted=True)
            w = 1.0 / (d + 1e-8)
            w = w / w.sum(-1, keepdim=True)
            interp = (index_points(feats2, idx) * w[..., None]).sum(2)
        h = interp if feats1 is None else torch.cat([feats1, interp], -1)
        return self.run_mlp(h)


class PointNetPlusPlus(nn.Module):
    """forward(xyz (b, n, 3)) -> (xyz, per-point features (b, n, c_dim)).
    `dim` and `padding` are taken for the encoder registry and unused, as
    in the reference."""

    def __init__(self, dim: Optional[int] = None, c_dim: int = 128, padding: float = 0.1):
        super().__init__()
        self.sa1 = PointNetSetAbstraction(512, 0.2, 32, 3 + 3, (64, 64, 128))
        self.sa2 = PointNetSetAbstraction(128, 0.4, 64, 3 + 128, (128, 128, 256))
        self.sa3 = PointNetSetAbstraction(None, None, None, 3 + 256, (256, 512, 1024),
                                          group_all=True)
        self.fp3 = PointNetFeaturePropagation(256 + 1024, (256, 256))
        self.fp2 = PointNetFeaturePropagation(128 + 256, (256, 128))
        self.fp1 = PointNetFeaturePropagation(128, (128, 128, c_dim))

    def forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        l1_xyz, l1 = self.sa1(xyz, xyz)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        return xyz, self.fp1(xyz, l1_xyz, None, l1)
