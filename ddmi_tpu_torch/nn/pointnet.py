"""PointNet encoder with local pooling onto triplanes (counterpart of
ddmi_tpu/nn/pointnet.py: `coordinate2index`, `LocalPoolPointnet`).

Per-point FC-ResNet blocks exchange features through the three projected
planes: each block's input is its predecessor's output concatenated with the
pooled features of the cells the point falls in, summed over the planes.
The pooling is `Tensor.scatter_reduce` over the flat cell index, with the
JAX package's semantics: the max starts from -inf and zeroes the cells no
point reached (so a cell whose features are all negative keeps them), the
mean divides by max(count, 1).  The planes come out as the mean of `fc_c`'s
features per cell, NCHW (b, c_dim, res, res), rows indexed by the plane's
second coordinate.  A point carries `dim` values (3; srn_cars clouds carry
xyz and rgb, 6): all of them enter `fc_pos`, the first three place it in
the cells.  The layers promote as flax's Dense does: on the fp32 points,
bf16 parameters compute in fp32, so the coordinates and the cell indices
stay exact.  The max is deterministic, and under autograd a tie (ReLU
features tie at 0 often) splits its gradient evenly between the tied
points, as JAX's segment_max does; the mean's scatter-add on CUDA sums in
no fixed order.

With `unet=True` one UNet2D (nn/conv_unet.py), its weights shared by the
three planes, refines them, run once over the planes stacked on the batch
axis as JAX runs it.

State keys follow the reference LocalPoolPointnet: `fc_pos`,
`blocks.{i}.{fc_0,fc_1,shortcut}`, `fc_c`, `unet.*`.

`LocalVoxelEncoder` (counterpart of the JAX module of that name) encodes an
occupancy grid (b, r, r, r), axes (x, y, z): a 3D conv with ReLU, then each
plane the mean over its orthogonal axis, in the pointnet's (row, col) =
(second, first coordinate) layout, resized bilinearly as jax.image.resize
does (`core/coords.py::resize_bilinear`) when plane_resolution is not r;
the optional shared UNet2D over the planes, and with 'grid' in plane_type
the feature volume (b, c_dim, x, y, z), refined by a UNet3D with `unet3d`.
No config of the repo selects either option.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.core.coords import resize_bilinear
from ddmi_tpu_torch.nn.conv_unet import UNet2D, UNet3D
from ddmi_tpu_torch.nn.inr import normalize_coordinate, promoted_linear, promoted_resnet_fc
from ddmi_tpu_torch.nn.stylegan import ResnetBlockFC

PLANES = ("xz", "xy", "yz")


def coordinate2index(xy01: torch.Tensor, reso: int) -> torch.Tensor:
    """(..., 2) in [0, 1) -> flat plane index ix + reso * iy (int64), the
    cell coordinates truncated toward zero."""
    x = (xy01 * reso).to(torch.int32).long()
    return x[..., 0] + reso * x[..., 1]


def segment_pool(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                 reduce: str) -> torch.Tensor:
    """Per-batch scatter pooling: values (b, n, c), index (b, n) ->
    (b, num_segments, c).  'max': -inf start, empty cells zeroed; 'mean':
    the sum over max(count, 1)."""
    b, n, c = values.shape
    idx = index[..., None].expand(b, n, c)
    if reduce == "max":
        out = values.new_full((b, num_segments, c), float("-inf"))
        out = out.scatter_reduce(1, idx, values, "amax", include_self=True)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    s = values.new_zeros((b, num_segments, c)).scatter_add(1, idx, values)
    cnt = values.new_zeros((b, num_segments)).scatter_add(
        1, index, torch.ones_like(index, dtype=values.dtype))
    return s / cnt.clamp(min=1.0)[..., None]


class LocalPoolPointnet(nn.Module):
    """forward(p (b, n, dim)) -> {"xz", "xy", "yz"} NCHW feature planes."""

    def __init__(self, c_dim: int = 32, hidden_dim: int = 256, plane_resolution: int = 64,
                 n_blocks: int = 7, scatter_type: str = "max", padding: float = 0.1,
                 unet: bool = False, unet_depth: int = 4, unet_start_filts: int = 32,
                 dim: int = 3):
        super().__init__()
        if scatter_type not in ("max", "mean"):
            raise ValueError(f"unknown scatter_type {scatter_type!r}")
        self.c_dim, self.reso = c_dim, plane_resolution
        self.scatter_type, self.padding = scatter_type, padding
        self.fc_pos = nn.Linear(dim, 2 * hidden_dim)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(2 * hidden_dim, hidden_dim) for _ in range(n_blocks)])
        self.fc_c = nn.Linear(hidden_dim, c_dim)
        self.unet = (UNet2D(c_dim, c_dim, depth=unet_depth, start_filts=unet_start_filts)
                     if unet else None)

    def forward(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = p.shape[0]
        reso, nseg = self.reso, self.reso * self.reso
        p = p.float()
        index = {k: coordinate2index(normalize_coordinate(p, self.padding, k), reso)
                 for k in PLANES}

        def pool_local(feats):
            out = 0.0
            for k in PLANES:
                seg = segment_pool(feats, index[k], nseg, self.scatter_type)
                out = out + torch.gather(
                    seg, 1, index[k][..., None].expand(-1, -1, feats.shape[-1]))
            return out

        net = promoted_resnet_fc(self.blocks[0], promoted_linear(self.fc_pos, p))
        for block in self.blocks[1:]:
            net = promoted_resnet_fc(block, torch.cat([net, pool_local(net)], dim=-1))
        c = promoted_linear(self.fc_c, net)
        fea = {k: segment_pool(c, index[k], nseg, "mean").transpose(1, 2).reshape(
                   b, self.c_dim, reso, reso) for k in PLANES}
        return fea if self.unet is None else refine_planes(self.unet, fea, PLANES)


def refine_planes(unet: nn.Module, fea: Dict[str, torch.Tensor], keys) -> Dict[str, torch.Tensor]:
    """One shared-weight UNet over the planes `keys` of `fea`, stacked on
    the batch axis in that order."""
    b = fea[keys[0]].shape[0]
    out = unet(torch.cat([fea[k] for k in keys], 0))
    return {**fea, **{k: out[i * b:(i + 1) * b] for i, k in enumerate(keys)}}


class LocalVoxelEncoder(nn.Module):
    """forward(voxels (b, r, r, r)) -> NCHW planes of `plane_type` and/or the
    'grid' volume (b, c_dim, r, r, r).  State keys: `conv_in`, `unet.*`,
    `unet3d.*`."""

    def __init__(self, c_dim: int = 32, plane_resolution: int = 64, plane_type=PLANES,
                 kernel_size: int = 3, unet: bool = False, unet_depth: int = 4,
                 unet_start_filts: int = 32, unet3d: bool = False):
        super().__init__()
        self.c_dim, self.reso = c_dim, plane_resolution
        self.plane_type = tuple(plane_type)
        self.conv_in = nn.Conv3d(1, c_dim, kernel_size, padding=0 if kernel_size == 1 else 1)
        self.planes = [k for k in self.plane_type if k != "grid"]
        self.unet = (UNet2D(c_dim, c_dim, depth=unet_depth, start_filts=unet_start_filts)
                     if unet and self.planes else None)
        self.unet3d = UNet3D(c_dim, c_dim) if unet3d and "grid" in self.plane_type else None

    def forward(self, voxels: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = voxels.shape[0]
        w = self.conv_in.weight
        dt = torch.promote_types(torch.float32, w.dtype)  # the fp32 voxels promote as in flax
        h = F.relu(F.conv3d(voxels[:, None].to(dt), w.to(dt), self.conv_in.bias.to(dt),
                            padding=self.conv_in.padding))  # (b, c, x, y, z)
        axis = {"xy": 4, "xz": 3, "yz": 2}  # the mean runs over the plane's normal
        fea: Dict[str, torch.Tensor] = {}
        for k in self.planes:
            plane = h.mean(axis[k]).transpose(2, 3)  # (b, c, second, first)
            if plane.shape[-1] != self.reso:
                plane = resize_bilinear(plane.permute(0, 2, 3, 1),
                                        (self.reso, self.reso)).permute(0, 3, 1, 2)
            fea[k] = plane
        if self.unet is not None:
            fea = refine_planes(self.unet, fea, self.planes)
        if "grid" in self.plane_type:
            fea["grid"] = h if self.unet3d is None else self.unet3d(h)
        return fea
