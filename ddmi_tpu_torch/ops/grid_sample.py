"""Bilinear sampling of NHWC planes, and trilinear sampling of NDHWC
volumes, at arbitrary coordinates (counterpart of
ddmi_tpu/ops/grid_sample.py: `grid_sample_2d`, `grid_sample_nchw_like`,
`grid_sample_3d`): align_corners=True at the NeRF, occupancy and ConvONet
paths' setting, the default, and align_corners=False at the image INR's
(stage-1 training samples its planes at the multiscale crop's
coordinates); border padding on every path, zeros padding on request.

The JAX function is four gathers outside any Pallas kernel; here it is one
`F.grid_sample`, which has the same semantics: coordinates in [-1, 1]
ordered (x, y) with x indexing W and y indexing H.  The index math runs in
fp32 whatever the planes' dtype (bf16 coordinates lose whole pixels at
sizes >= 256), and the result comes back in the planes' dtype.

F.grid_sample's backward has no derivative of its own on CUDA, so where the
coordinates carry a gradient (mesh refinement differentiates the occupancy
gradient with respect to the points) the sampling is composed of four row
gathers, as JAX composes it, which autograd differentiates to any order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _check_padding(padding_mode: str) -> None:
    if padding_mode not in ("border", "zeros"):
        raise NotImplementedError(f"padding_mode {padding_mode!r}")


def grid_sample_2d(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = True,
                   padding_mode: str = "border") -> torch.Tensor:
    """feat (B, H, W, C), grid (B, N, 2) -> (B, N, C)."""
    _check_padding(padding_mode)
    if grid.requires_grad and torch.is_grad_enabled():
        return bilinear_gather(feat, grid, align_corners, padding_mode)
    B, N = grid.shape[:2]
    out = F.grid_sample(
        feat.permute(0, 3, 1, 2).float(), grid.float().reshape(B, 1, N, 2),
        mode="bilinear", padding_mode=padding_mode, align_corners=align_corners,
    )  # (B, C, 1, N)
    return out[:, :, 0].transpose(1, 2).to(feat.dtype)


def grid_sample_nchw_like(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                          padding_mode: str = "border") -> torch.Tensor:
    """`grid_sample_2d` with torch-shaped I/O: feat (B, C, H, W), grid (B,
    Ho, Wo, 2) -> (B, C, Ho, Wo)."""
    B, C = feat.shape[:2]
    Ho, Wo = grid.shape[1:3]
    out = grid_sample_2d(feat.permute(0, 2, 3, 1), grid.reshape(B, Ho * Wo, 2),
                         align_corners, padding_mode)
    return out.reshape(B, Ho, Wo, C).permute(0, 3, 1, 2)


def grid_sample_3d(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = True,
                   padding_mode: str = "border") -> torch.Tensor:
    """Trilinear sampling: feat (B, D, H, W, C), grid (B, N, 3) in [-1, 1]
    ordered (x, y, z), x indexing W, y H and z D -> (B, N, C).  Where the
    coordinates carry a gradient it runs as eight gathers, differentiable
    to any order."""
    _check_padding(padding_mode)
    if grid.requires_grad and torch.is_grad_enabled():
        return trilinear_gather(feat, grid, align_corners, padding_mode)
    B, N = grid.shape[:2]
    out = F.grid_sample(
        feat.permute(0, 4, 1, 2, 3).float(), grid.float().reshape(B, 1, 1, N, 3),
        mode="bilinear", padding_mode=padding_mode, align_corners=align_corners,
    )  # (B, C, 1, 1, N)
    return out[:, :, 0, 0].transpose(1, 2).to(feat.dtype)


def _unnormalize(g: torch.Tensor, size: int, align_corners: bool, padding_mode: str):
    px = (g + 1.0) * 0.5 * (size - 1) if align_corners else ((g + 1.0) * size - 1.0) * 0.5
    return px.clamp(0.0, size - 1) if padding_mode == "border" else px


def bilinear_gather(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = True,
                    padding_mode: str = "border") -> torch.Tensor:
    """`grid_sample_2d` as four gathers of rows of the flattened planes and
    their bilinear weights, in fp32: the same values, differentiable to any
    order in both the planes and the coordinates."""
    B, H, W, C = feat.shape
    g = grid.float()
    x = _unnormalize(g[..., 0], W, align_corners, padding_mode)
    y = _unnormalize(g[..., 1], H, align_corners, padding_mode)
    x0, y0 = x.detach().floor(), y.detach().floor()
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = feat.float().reshape(B * H * W, C)
    base = torch.arange(B, device=feat.device)[:, None] * (H * W)

    def at(yi, xi):
        v = flat[(base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(-1)]
        v = v.reshape(B, -1, C)
        if padding_mode == "zeros":
            v = v * ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None].float()
        return v

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).to(feat.dtype)


def trilinear_gather(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = True,
                     padding_mode: str = "border") -> torch.Tensor:
    """`grid_sample_3d` as eight gathers of the flattened volume's rows and
    their trilinear weights, in fp32 (the JAX function's own form)."""
    B, D, H, W, C = feat.shape
    g = grid.float()
    x = _unnormalize(g[..., 0], W, align_corners, padding_mode)
    y = _unnormalize(g[..., 1], H, align_corners, padding_mode)
    z = _unnormalize(g[..., 2], D, align_corners, padding_mode)
    x0, y0, z0 = x.detach().floor(), y.detach().floor(), z.detach().floor()
    wx, wy, wz = (x - x0)[..., None], (y - y0)[..., None], (z - z0)[..., None]
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    flat = feat.float().reshape(B * D * H * W, C)
    base = torch.arange(B, device=feat.device)[:, None] * (D * H * W)
    out = 0.0
    for zi, fz in ((z0, 1 - wz), (z0 + 1, wz)):
        for yi, fy in ((y0, 1 - wy), (y0 + 1, wy)):
            for xi, fx in ((x0, 1 - wx), (x0 + 1, wx)):
                idx = (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W + xi.clamp(0, W - 1)
                w = fz * fy * fx
                if padding_mode == "zeros":
                    w = w * ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (zi >= 0)
                             & (zi < D))[..., None].float()
                out = out + w * flat[(base + idx).reshape(-1)].reshape(B, -1, C)
    return out.to(feat.dtype)
