"""Bilinear sampling of NHWC planes at arbitrary coordinates (counterpart of
ddmi_tpu/ops/grid_sample.py::grid_sample_2d at the NeRF path's settings,
align_corners=True with border padding).

The JAX function is four gathers outside any Pallas kernel; here it is one
`F.grid_sample`, which has the same semantics: coordinates in [-1, 1]
ordered (x, y) with x indexing W and y indexing H.  The index math runs in
fp32 whatever the planes' dtype (bf16 coordinates lose whole pixels at
sizes >= 256), and the result comes back in the planes' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C), grid (B, N, 2) -> (B, N, C)."""
    B, N = grid.shape[:2]
    out = F.grid_sample(
        feat.permute(0, 3, 1, 2).float(), grid.float().reshape(B, 1, N, 2),
        mode="bilinear", padding_mode="border", align_corners=True,
    )  # (B, C, 1, N)
    return out[:, :, 0].transpose(1, 2).to(feat.dtype)
