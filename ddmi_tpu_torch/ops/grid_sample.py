"""Bilinear sampling of NHWC planes at arbitrary coordinates (counterpart of
ddmi_tpu/ops/grid_sample.py::grid_sample_2d at the NeRF and occupancy
paths' settings, align_corners=True with border padding).

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


def grid_sample_2d(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C), grid (B, N, 2) -> (B, N, C)."""
    if grid.requires_grad and torch.is_grad_enabled():
        return bilinear_gather(feat, grid)
    B, N = grid.shape[:2]
    out = F.grid_sample(
        feat.permute(0, 3, 1, 2).float(), grid.float().reshape(B, 1, N, 2),
        mode="bilinear", padding_mode="border", align_corners=True,
    )  # (B, C, 1, N)
    return out[:, :, 0].transpose(1, 2).to(feat.dtype)


def bilinear_gather(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """`grid_sample_2d` as four gathers of rows of the flattened planes and
    their bilinear weights, in fp32: the same values, differentiable to any
    order in both the planes and the coordinates."""
    B, H, W, C = feat.shape
    g = grid.float()
    x = ((g[..., 0] + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1)
    y = ((g[..., 1] + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1)
    x0, y0 = x.detach().floor(), y.detach().floor()
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = feat.float().reshape(B * H * W, C)
    base = torch.arange(B, device=feat.device)[:, None] * (H * W)

    def at(yi, xi):
        return flat[(base + yi * W + xi).reshape(-1)].reshape(B, -1, C)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).to(feat.dtype)
